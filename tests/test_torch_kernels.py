"""The CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here is marked `cuda` and skips without a CUDA device: a CUDA
kernel has no CPU mode.  The plain versions are held to the JAX package by
tests/test_torch_{lookup,aufbau,pipeline,layouts,pack64}.py on the CPU.
This file imports nothing but the port, numpy and chip_smoke (whose tier
recipe makes the databases), so it runs on a machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from chip_smoke import (index64, make_reads, make_tier, tier64, tier_kmers,
                        tier_labels, write_fasta, xtree_refs)
from utree_tpu_torch import kernels
from utree_tpu_torch import lookup as tl
from utree_tpu_torch.classify_device import (VoteTables, aufbau_tables_to_device,
                                             aufbau_walk, build_aufbau_tables,
                                             pack_vote, vote_rows)
from utree_tpu_torch.config import UTreeConfig
from utree_tpu_torch.hash_index import (bsearch_to_device, build_displaced_index,
                                        canonical64_to_device, displaced64_to_device,
                                        displaced_to_device)
from utree_tpu_torch.index import DeviceIndexArrays

pytestmark = pytest.mark.cuda
BAD = 65535


def _random_strings(rng, n):
    """Taxonomy-shaped strings with shared prefixes, blank ranks, '_' tails,
    and the occasional flat or empty string."""
    ranks = [b"k__", b"p__", b"c__", b"o__", b"f__", b"g__", b"s__"]
    words = [b"a", b"ab", b"abc", b"b", b"ba", b"x", b"", b"_", b"q_"]
    out = set()
    while len(out) < n:
        kind = rng.random()
        if kind < 0.85:
            depth = int(rng.integers(1, len(ranks) + 1))
            out.add(b";".join(ranks[d] + words[int(rng.integers(len(words)))]
                              for d in range(depth)))
        elif kind < 0.95:
            out.add(bytes(rng.choice(list(b"ab_;"), int(rng.integers(1, 6))).astype(np.uint8)))
        else:
            out.add(b"")
    return sorted(out)[:n]


def _wide_tier(kmers=40_000, labels=64):
    """chip_smoke's tier with 70,000 more label strings (IXTYPE=u32): the
    same words and label ids, wide label lanes.  Returns (index, genome, rng)."""
    sw, ixs, genome, rng = tier_kmers(kmers, labels)
    strings = tier_labels(rng, labels) + [b"pad%d" % i for i in range(70_000)]
    return (DeviceIndexArrays.from_build(sw, ixs, strings, UTreeConfig(ixtype_bytes=4)),
            genome, rng)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tier(dev):
    index, genome, _ = make_tier(40_000, 64)
    disp = build_displaced_index(index, load=0.98, spill_budget=index.num_records)
    assert disp.t3.shape[0] > 8  # the d3 tail is exercised too
    return dict(index=index, genome=genome, table=displaced_to_device(disp, dev))


def _packed_reads(genome, n, seed, dev, read_len=150, width=192, padded=0):
    """Reads from the genome with N's and ragged lengths; the last `padded`
    rows have length 0, as a batch's padding rows do."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    starts = rng.integers(0, len(genome) - read_len, n)
    reads = np.zeros((n, width), np.uint8)
    reads[:, :read_len] = genome[starts[:, None] + np.arange(read_len)]
    reads[rng.random(reads.shape) < 0.01] = ord("N")
    rand = rng.random(n) < 0.1
    reads[rand, :read_len] = rng.choice(acgt, (int(rand.sum()), read_len))
    lens = np.full(n, read_len, np.int32)
    lens[::3] = rng.integers(20, read_len, len(lens[::3]))
    lens[n - padded:] = 0
    reads[np.arange(width)[None, :] >= lens[:, None]] = 0
    return [torch.from_numpy(a).to(dev) for a in tl.pack_reads_host(reads, lens)]


def test_k1_scan_probe_and_k2_histogram_match_plain(tier, dev):
    packed, vbits, lens = _packed_reads(tier["genome"], 3000, 1, dev)
    for do_rc in (True, False):
        for true_len in (152, None):
            kw = dict(do_rc=do_rc, bad_ix=BAD, true_len=true_len, num_labels=64)
            n0 = kernels.launches["scan_probe"]
            ids = tl.window_ids(tier["table"], packed, vbits, lens, **kw)
            assert kernels.launches["scan_probe"] == n0 + 1
            want = tl.window_ids_plain(tier["table"], packed, vbits, lens, **kw)
            assert torch.equal(ids, want)
            for cap in (1, 8, 30):
                got = tl.histogram(ids, 64, cap)
                want = tl.compact_histogram(ids, 64, cap)
                assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_k2_histogram_long_rows(dev):
    """Rows wider than the register path (32*64 ids) stream from memory."""
    rng = np.random.default_rng(2)
    for n in (7, 300, 2048, 3000):
        ids = torch.from_numpy(rng.integers(0, 40, (257, n)).astype(np.int32)).to(dev)
        ids[ids > 30] = BAD
        for cap in (1, 8, 30):
            got = tl.histogram(ids, 30, cap)
            want = tl.compact_histogram(ids, 30, cap)
            assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("seed,cap", [(0, 8), (5, 12), (7, 30), (3, 1)])
def test_k3_aufbau_vote_matches_plain(dev, seed, cap):
    rng = np.random.default_rng(seed)
    strings = _random_strings(rng, int(rng.integers(8, 80)))
    tab = build_aufbau_tables(strings)
    n = 2000
    labels = np.full((n, cap), -1, np.int32)
    counts = np.zeros((n, cap), np.int32)
    nuniq = rng.integers(0, cap + 2, n).astype(np.int32)
    for b in range(n):
        k = min(int(nuniq[b]), cap, len(strings))
        labels[b, :k] = np.sort(rng.choice(len(strings), k, replace=False))
        counts[b, :k] = rng.integers(1, 12, k)
    found = counts.sum(1).astype(np.int32)
    arrays = [torch.from_numpy(a).to(dev) for a in (labels, counts, nuniq, found)]
    dtab = aufbau_tables_to_device(tab, dev)
    for max_iters in ((tab.max_len + 4) * (cap + 2) + 16, 2):
        kw = dict(taxacut=4, max_iters=max_iters)
        want = pack_vote(*aufbau_walk(dtab, *arrays, **kw), arrays[2], arrays[3])
        assert torch.equal(vote_rows(dtab, *arrays, **kw), want)


def _vote_batch(rng, n_strings, n, cap, walk_all=False):
    """n reads of compact histograms over n_strings labels: 0..cap+1
    unique labels, or 2..cap (every read walks)."""
    labels = np.full((n, cap), -1, np.int32)
    counts = np.zeros((n, cap), np.int32)
    lo = 2 if walk_all else 0
    nuniq = rng.integers(lo, cap + 1 if walk_all else cap + 2, n).astype(np.int32)
    for b in range(n):
        k = min(int(nuniq[b]), cap, n_strings)
        labels[b, :k] = np.sort(rng.choice(n_strings, k, replace=False))
        counts[b, :k] = rng.integers(1, 12, k)
    found = counts.sum(1).astype(np.int32)
    return labels, counts, nuniq, found


def _vote_equal(dev, tab, arrays, *, taxacut=4, max_iters=None, prepared=True):
    """K3 on `arrays` (numpy) against pack_vote(aufbau_walk(...)) on the
    card, through prepared tables or the dict; returns the count of reads
    that walk."""
    cap = arrays[0].shape[1]
    dtab = aufbau_tables_to_device(tab, dev)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]
    kw = dict(taxacut=taxacut, max_iters=(tab.max_len + 4) * (cap + 2) + 16
              if max_iters is None else max_iters)
    want = pack_vote(*aufbau_walk(dtab, *t, **kw), t[2], t[3])
    n0 = kernels.launches["aufbau_vote"]
    got = vote_rows(VoteTables(dtab) if prepared else dtab, *t, **kw)
    assert kernels.launches["aufbau_vote"] == n0 + 1
    assert got.shape == (arrays[0].shape[0], 3) and torch.equal(got, want)
    return int(((t[2] >= 2) & (t[2] <= cap) & (t[3] >= 2)).sum())


@pytest.mark.parametrize("cap", [1, 8, 30])
@pytest.mark.parametrize("n", [0, 1, 31, 33, 127, 129, 1000])
def test_k3_batch_edges_match_plain(dev, n, cap):
    """K3 at B not a multiple of the warp or the tile (128 reads), at B = 0
    and 1, at caps 1, 8 (its specialised path) and 30: a batch of mixed
    reads and one where every read walks."""
    rng = np.random.default_rng(n * 31 + cap)
    tab = build_aufbau_tables(_random_strings(rng, 60))
    _vote_equal(dev, tab, _vote_batch(rng, 60, n, cap))
    if cap > 1:
        assert _vote_equal(dev, tab, _vote_batch(rng, 60, n, cap, walk_all=True)) == n


def test_k3_odd_lanes_match_plain(dev):
    """The lanes of tests/test_torch_aufbau.py on the card: padding labels,
    nuniq 0 and 1, nuniq = cap + 1, a read cut by max_iters, and fields too
    wide for their lanes; through the dict as well."""
    rng = np.random.default_rng(9)
    strings = _random_strings(rng, 20)
    tab = build_aufbau_tables(strings)
    cap = 4
    labels = np.full((4, cap), -1, np.int32)
    counts = np.zeros((4, cap), np.int32)
    labels[1, 0], counts[1, 0] = 5, 7
    labels[2], counts[2] = [0, 1, 2, 3], [1, 1, 1, 1]
    labels[3, :2], counts[3, :2] = [19, 2], [3, 4]
    arrays = (labels, counts, np.array([0, 1, cap + 1, 2], np.int32),
              np.array([0, 7, 5, 7], np.int32))
    for prepared in (True, False):
        _vote_equal(dev, tab, arrays, max_iters=256, prepared=prepared)
    rng = np.random.default_rng(2)
    tab = build_aufbau_tables(_random_strings(rng, 60))
    batch = _vote_batch(rng, 60, 200, 8, walk_all=True)
    for max_iters in (1, 3):
        _vote_equal(dev, tab, batch, max_iters=max_iters)
    wide = list(_vote_batch(rng, 60, 500, 8))
    wide[1] = wide[1] * 40_000  # sl, ol and found past their lanes
    wide[3] = wide[1].sum(1).astype(np.int32)
    _vote_equal(dev, tab, wide)


def test_k3_refuses_tables_of_another_device(dev):
    tab = aufbau_tables_to_device(build_aufbau_tables([b"a;b", b"a;c"]), "cpu")
    hist = [torch.zeros((4, 8) if i < 2 else 4, dtype=torch.int32, device=dev)
            for i in range(4)]
    with pytest.raises(ValueError):
        vote_rows(VoteTables(tab), *hist, taxacut=4, max_iters=8)


def _ladder(index, geometry):
    from utree_tpu_torch.hash_index import (_canonical_groups, _place_canonical,
                                            build_canonical_hash_index)

    if geometry == "chain":  # tier B's three-level shape, c3 in use
        built = _place_canonical(*_canonical_groups(index), 4, 4.0, 2, 1 << 27,
                                 slots3=16)
        assert built.t2.shape[0] > 8 and built.t3.shape[0] > 8
        return built
    return build_canonical_hash_index(index)


def _probe_and_hists(table, packed, vbits, lens, num_labels, probe):
    """Every probe variant and histogram layout against its plain version."""
    bad = 0x7FFFFFFF if num_labels >= 0xFFFF else BAD
    for do_rc in (True, False):
        for true_len in (152, None):
            kw = dict(do_rc=do_rc, bad_ix=bad, true_len=true_len, num_labels=num_labels)
            n0 = kernels.launches[probe]
            ids = tl.window_ids(table, packed, vbits, lens, **kw)
            assert kernels.launches[probe] == n0 + 1
            assert torch.equal(ids, tl.window_ids_plain(table, packed, vbits, lens, **kw))
            assert int((ids < num_labels).sum()) > 1000
            for cap in (1, 8, 30):
                assert torch.equal(tl.histogram_packed(ids, num_labels, cap),
                                   tl.pack_hist(ids, num_labels, cap))
                assert torch.equal(tl.histogram_unpacked(ids, num_labels, cap),
                                   tl.unpacked_hist(ids, num_labels, cap))


@pytest.mark.parametrize("geometry", ["default", "chain"])
def test_k4_ladder_probe_matches_plain(tier, dev, geometry):
    from utree_tpu_torch.hash_index import canonical_to_device

    table = canonical_to_device(_ladder(tier["index"], geometry), dev)
    packed, vbits, lens = _packed_reads(tier["genome"], 3000, 3, dev)
    _probe_and_hists(table, packed, vbits, lens, 64, "ladder_probe")


@pytest.mark.parametrize("kind", ["ladder", "displaced"])
def test_wide_probes_match_plain(dev, kind):
    from utree_tpu_torch.hash_index import canonical_to_device

    wide, genome, _ = _wide_tier()
    if kind == "ladder":
        table, probe = canonical_to_device(_ladder(wide, "default"), dev), "ladder_probe_wide"
    else:
        disp = build_displaced_index(wide, load=0.98, spill_budget=wide.num_records)
        assert disp.wide and disp.t3.shape[0] > 8
        table, probe = displaced_to_device(disp, dev), "scan_probe_wide"
    packed, vbits, lens = _packed_reads(genome, 3000, 4, dev)
    _probe_and_hists(table, packed, vbits, lens, wide.num_labels, probe)


def _edge_reads(genome, n, seed, dev, width=192):
    """n reads (n * W lanes is no multiple of K1/K4's 1024-lane tile, so
    tiles start and end inside reads) of lengths 0-192, some shorter than
    32 bases, with N's at random, at the first base and at the last one
    (which only the window at len - 32 reads)."""
    rng = np.random.default_rng(seed)
    lens = rng.choice([0, 5, 31, 32, 33, 63, 64, 150, 191, 192], n).astype(np.int32)
    starts = rng.integers(0, len(genome) - width, n)
    reads = genome[starts[:, None] + np.arange(width)].copy()
    reads[rng.random(reads.shape) < 0.004] = ord("N")
    reads[::7, 0] = ord("N")
    last = np.flatnonzero(lens > 0)[::5]
    reads[last, lens[last] - 1] = ord("N")
    reads[np.arange(width)[None, :] >= lens[:, None]] = 0
    return [torch.from_numpy(a).to(dev) for a in tl.pack_reads_host(reads, lens)]


def _sentinel(t: torch.Tensor, seed: int) -> torch.Tensor:
    """An 8-row "absent" level of t's width, of random words: never probed."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-2**31, 2**31 - 1, (8, t.shape[1]), generator=g,
                         dtype=torch.int32).to(t.device)


@pytest.fixture(scope="module")
def edge_tables(tier, dev):
    """(tables by kind, genome, num_labels) for narrow and wide labels: the
    displaced table with its d3 in use and as the 8-row sentinel, the
    ladder's chain geometry (c2 and c3 in use) and with both as sentinels."""
    from utree_tpu_torch.hash_index import canonical_to_device

    wide, wgenome, _ = _wide_tier()
    out = {}
    for labels, index, genome in (("narrow", tier["index"], tier["genome"]),
                                  ("wide", wide, wgenome)):
        disp = displaced_to_device(build_displaced_index(
            index, load=0.98, spill_budget=index.num_records), dev)
        chain = canonical_to_device(_ladder(index, "chain"), dev)
        assert disp["d3"].shape[0] > 8 and chain["c2"].shape[0] > 8
        tables = {"displaced": disp, "displaced-sentinel": dict(disp, d3=_sentinel(disp["d3"], 1)),
                  "ladder": chain, "ladder-sentinel": dict(chain, c2=_sentinel(chain["c2"], 2),
                                                           c3=_sentinel(chain["c3"], 3))}
        out[labels] = (tables, genome, index.num_labels)
    return out


@pytest.mark.parametrize("kind", ["displaced", "displaced-sentinel", "ladder",
                                  "ladder-sentinel"])
@pytest.mark.parametrize("labels", ["narrow", "wide"])
def test_k1_k4_tile_edges_match_plain(edge_tables, dev, labels, kind):
    """K1 and K4 at their tiles' edges, with and without RC, untrimmed and
    trimmed to 152, 40 (nine windows) and 32 bases (one window: a tile then
    spans more reads than its staged words hold, and its lanes read their
    bases from device memory): equal to the plain version, and the same
    over 20 launches."""
    tables, genome, num_labels = edge_tables[labels]
    table = tables[kind]
    packed, vbits, lens = _edge_reads(genome, 777, 43, dev)
    name = ("scan_probe" if kind.startswith("displaced") else "ladder_probe") + (
        "_wide" if labels == "wide" else "")
    bad = 0x7FFFFFFF if labels == "wide" else BAD
    for do_rc in (True, False):
        for true_len in (None, 152, 40, 32):
            kw = dict(do_rc=do_rc, bad_ix=bad, true_len=true_len, num_labels=num_labels)
            want = tl.window_ids_plain(table, packed, vbits, lens, **kw)
            assert int((want < num_labels).sum()) > (0 if true_len == 32 else 1000)
            n0 = kernels.launches[name]
            for _ in range(20):
                assert torch.equal(tl.window_ids(table, packed, vbits, lens, **kw), want)
            assert kernels.launches[name] == n0 + 20


def test_k1_k4_refuse_misaligned_rows(tier, dev):
    """The two-slot rows load as 8 B vectors: a d1 or c1 that starts off an
    8 B boundary raises before any launch."""
    from utree_tpu_torch.hash_index import canonical_to_device

    packed, vbits, lens = _packed_reads(tier["genome"], 64, 5, dev)
    kw = dict(do_rc=True, bad_ix=BAD, num_labels=64)
    ladder = canonical_to_device(_ladder(tier["index"], "default"), dev)
    for table, key in ((tier["table"], "d1"), (ladder, "c1")):
        t = table[key]
        buf = torch.empty(t.numel() + 1, dtype=torch.int32, device=dev)
        shifted = buf[1:].view(t.shape)
        shifted.copy_(t)
        with pytest.raises(ValueError, match="8 B aligned"):
            tl.window_ids(dict(table, **{key: shifted}), packed, vbits, lens, **kw)


def test_k2_layouts_at_long_read_widths(tier, dev):
    """Long-read chunks: 16,384 windows a row, so 2 x 16,384 ids with RC,
    far past the register path: every layout takes the streamed branch."""
    from utree_tpu_torch.hash_index import canonical_to_device

    table = canonical_to_device(_ladder(tier["index"], "default"), dev)
    genome = tier["genome"]
    width = 16_384 + 32
    rng = np.random.default_rng(5)
    reads = np.zeros((16, width), np.uint8)
    lens = rng.integers(width // 2, width - 1, 16).astype(np.int32)
    for r in range(16):
        s = int(rng.integers(0, len(genome) - width))
        reads[r] = genome[s:s + width]
    reads[np.arange(width)[None, :] >= lens[:, None]] = 0
    packed, vbits, lens = (torch.from_numpy(a).to(dev) for a in tl.pack_reads_host(reads, lens))
    ids = tl.window_ids(table, packed, vbits, lens, do_rc=True, bad_ix=BAD, num_labels=64)
    assert ids.shape[1] == 2 * (width - 31) > 32 * 64
    for cap in (1, 8, 30):
        assert torch.equal(tl.histogram_packed(ids, 64, cap), tl.pack_hist(ids, 64, cap))
        assert torch.equal(tl.histogram_unpacked(ids, 64, cap),
                           tl.unpacked_hist(ids, 64, cap))
        assert all(torch.equal(a, b) for a, b in zip(tl.histogram(ids, 64, cap),
                                                      tl.compact_histogram(ids, 64, cap)))


def _streamed_ids(rng, rows, n, num_labels):
    """(rows, n) int32 ids for K2's streamed branch, one kind of row after
    another: a long read's few label runs among misses (BAD, ids at and
    above num_labels) and negative ids; rows of exactly 1, 8, 9, 30 and 31
    distinct labels (cap and cap + 1 for caps 1, 8 and 30); one label in
    every id; ids drawn over [-3, num_labels + 3), mostly distinct; every
    id a miss."""
    ids = np.full((rows, n), BAD, np.int32)
    for r in range(rows):
        kind = r % 9
        if kind == 0:
            cuts = np.sort(rng.integers(0, n, 10))
            labels = rng.integers(0, num_labels, 11)
            ids[r] = np.repeat(labels, np.diff(np.r_[0, cuts, n]))
            miss = rng.random(n) < 0.3
            ids[r, miss] = rng.choice([BAD, num_labels, num_labels + 7, -1, -9], int(miss.sum()))
        elif kind <= 5:
            d = (1, 8, 9, 30, 31)[kind - 1]
            labels = np.r_[rng.choice(min(num_labels - 1, 1 << 20), d - 1, replace=False),
                           num_labels - 1]  # the largest label of all
            ids[r] = labels[rng.integers(0, d, n)]
            ids[r, rng.integers(0, n, n // 10)] = -1
        elif kind == 6:
            ids[r] = rng.integers(0, num_labels)
        elif kind == 7:
            ids[r] = rng.integers(-3, num_labels + 3, n)
    return ids


def _k2_all_layouts(ids, num_labels, cap):
    """The three K2 entry points against their plain versions."""
    assert torch.equal(tl.histogram_packed(ids, num_labels, cap),
                       tl.pack_hist(ids, num_labels, cap))
    assert torch.equal(tl.histogram_unpacked(ids, num_labels, cap),
                       tl.unpacked_hist(ids, num_labels, cap))
    assert all(torch.equal(a, b) for a, b in zip(tl.histogram(ids, num_labels, cap),
                                                  tl.compact_histogram(ids, num_labels, cap)))


@pytest.mark.parametrize("rows", [1, 2, 64, 4096])
@pytest.mark.parametrize("n", [2049, 16_385, 32_706, 40_000])
def test_k2_streamed_rows_match_plain(dev, n, rows):
    """One block a row: staged rows (up to 2 x 16,385 ids, in bulk copies,
    any 16 B alignment of a row) and a row read from memory (40,000), with
    hits, misses, negative ids, rows of cap and cap + 1 labels and one label
    everywhere; the plain versions run on the card too."""
    rng = np.random.default_rng(n + rows)
    base = torch.from_numpy(_streamed_ids(rng, rows + 1, n, 4096)).to(dev)
    for ids in (base[:rows], base.view(-1)[3:3 + rows * n].view(rows, n)):  # 16 B, then 4 B
        for cap in (1, 8, 30):
            _k2_all_layouts(ids, 4096, cap)


@pytest.mark.parametrize("num_labels", [524_288, 524_289], ids=["bitmap", "rounds"])
@pytest.mark.parametrize("n", [16_385, 40_000])
def test_k2_streamed_label_bitmap_limit(dev, num_labels, n):
    """num_labels at the bitmap's limit (32 x 16,384 words) takes the
    bitmap; one past it the block-wide rounds; both exact."""
    rng = np.random.default_rng(num_labels)
    ids = torch.from_numpy(_streamed_ids(rng, 27, n, num_labels)).to(dev)
    for cap in (1, 8, 30):
        _k2_all_layouts(ids, num_labels, cap)


def _word_ascii(words):
    """32-mer words (uint64) -> their bases as (n, 32) ASCII."""
    shifts = np.uint64(2) * (np.uint64(31) - np.arange(32, dtype=np.uint64))
    codes = (words[:, None] >> shifts[None, :]) & np.uint64(3)
    return np.frombuffer(b"ACGT", np.uint8)[codes.astype(np.int64)]


def test_k7_bsearch_probe_matches_plain(tier, dev):
    """The replay over the tier's CTR records, RC on and off, with the
    true_len trim; every histogram layout on its ids."""
    index = tier["index"]
    table = bsearch_to_device(index, dev)
    packed, vbits, lens = _packed_reads(tier["genome"], 3000, 6, dev)
    for do_rc in (True, False):
        for true_len in (152, None):
            kw = dict(do_rc=do_rc, bad_ix=BAD, true_len=true_len, num_labels=64,
                      probe_iters=index.probe_iters)
            n0 = kernels.launches["bsearch_probe"]
            ids = tl.window_ids(table, packed, vbits, lens, **kw)
            assert kernels.launches["bsearch_probe"] == n0 + 1
            assert torch.equal(ids, tl.window_ids_plain(table, packed, vbits, lens, **kw))
            assert int((ids < 64).sum()) > 1000
            for cap in (1, 8, 30):
                assert all(torch.equal(a, b) for a, b in zip(
                    tl.histogram(ids, 64, cap), tl.compact_histogram(ids, 64, cap)))


def test_k7_on_an_abnormal_bin(dev):
    """A DB whose lowest populated bin holds one record that sorts after the
    next bin's first record: the reference folds it into that bin, which is
    then not sorted.  K7 loops until every range is empty, the plain version
    runs JAX's fixed probe_iters trips: both end on the same record, on
    reads built from the merged bin's words and their RCs."""
    rng = np.random.default_rng(9)
    words = np.unique(rng.integers(1 << 40, 1 << 47, 3000, dtype=np.uint64))
    odd = np.uint64(0xFFFFFFFFFF)  # prefix 0, the largest suffix
    words = np.concatenate([[odd], words])
    ixs = rng.integers(0, 40, len(words))
    index = DeviceIndexArrays.from_build(words, ixs, [b"l%d" % i for i in range(40)],
                                         UTreeConfig())
    first = int(words[1] >> np.uint64(40))
    assert index.bin_ix[first] == 0 and index.bin_ix[1] == 0  # merged bin
    table = bsearch_to_device(index, dev)
    # each read: a stored word, a word of the merged bin with a changed
    # suffix, and the odd word, separated by N's
    n = 600
    pick = words[rng.integers(0, 40, n)]
    tweak = words[1 + rng.integers(0, 8, n)] ^ rng.integers(0, 1 << 8, n, dtype=np.uint64)
    reads = np.full((n, 104), ord("N"), np.uint8)
    reads[:, 0:32] = _word_ascii(pick)
    reads[:, 36:68] = _word_ascii(tweak)
    reads[:, 72:104] = _word_ascii(np.full(n, odd))
    lens = np.full(n, 104, np.int32)
    packed, vbits, lens = (torch.from_numpy(a).to(dev) for a in tl.pack_reads_host(reads, lens))
    for do_rc in (True, False):
        kw = dict(do_rc=do_rc, bad_ix=BAD, num_labels=40, probe_iters=index.probe_iters)
        ids = tl.window_ids(table, packed, vbits, lens, **kw)
        assert torch.equal(ids, tl.window_ids_plain(table, packed, vbits, lens, **kw))
        assert int((ids[:, 0] < 40).sum()) > 100  # stored words are found


def _tile_edge_ns(reads, lens, W, k, tile=256):
    """N at the first base of each tile's first window and at the last base
    of each tile's last window, for windows of k bases in a (B, W) grid."""
    n = reads.shape[0]
    for p0 in range(0, n * W, tile):
        for p, j in ((p0, 0), (min(p0 + tile, n * W) - 1, k - 1)):
            b, w = divmod(p, W)
            if w + j < reads.shape[1]:
                reads[b, w + j] = ord("N")
    return reads


def _k7_edge_reads(genome, n, seed, dev, width=192, tile=256):
    """n reads of lengths 0-192 (some shorter than 32 bases), N's at random
    and at the edges of the kernel's blocks of `tile` windows (K7's 256,
    K10's 128 with RC) for the untrimmed grid, and every 11th read all N
    (every window invalid)."""
    rng = np.random.default_rng(seed)
    lens = rng.choice([0, 5, 31, 32, 33, 34, 63, 150, 191, 192], n).astype(np.int32)
    starts = rng.integers(0, len(genome) - width, n)
    reads = genome[starts[:, None] + np.arange(width)].copy()
    reads[rng.random(reads.shape) < 0.003] = ord("N")
    reads = _tile_edge_ns(reads, lens, width - 31, 32, tile)
    reads[::11] = ord("N")
    reads[np.arange(width)[None, :] >= lens[:, None]] = 0
    return [torch.from_numpy(a).to(dev) for a in tl.pack_reads_host(reads, lens)]


@pytest.mark.parametrize("true_len", [None, 152, 104, 40, 32], ids=lambda t: f"true_len={t}")
def test_k7_tile_edges_match_plain(tier, dev, true_len):
    """K7 over grids whose W does not divide its 256-lane blocks (161,
    121, 73 and 9 windows) and a true_len trim to one window; reads of
    0-192 bases (1-3 windows at 32-34 bases), all-N reads and N's at the
    blocks' edges; both strands' descents together; RC on and off: equal
    to the plain version, and the same over 10 launches."""
    index = tier["index"]
    table = bsearch_to_device(index, dev)
    packed, vbits, lens = _k7_edge_reads(tier["genome"], 777, 44, dev)
    for do_rc in (True, False):
        kw = dict(do_rc=do_rc, bad_ix=BAD, true_len=true_len, num_labels=64,
                  probe_iters=index.probe_iters)
        want = tl.window_ids_plain(table, packed, vbits, lens, **kw)
        assert want.shape[1] == (2 if do_rc else 1) * ((true_len or 192) - 31)
        assert int((want < 64).sum()) > (0 if (true_len or 192) < 40 else 1000)
        n0 = kernels.launches["bsearch_probe"]
        for _ in range(10):
            assert torch.equal(tl.window_ids(table, packed, vbits, lens, **kw), want)
        assert kernels.launches["bsearch_probe"] == n0 + 10
        assert (want[::11] == BAD).all()  # the all-N reads


def test_k7_refuses_records_it_cannot_read(tier, dev):
    """K7 reads the records' 16 B copy: a table without it, or with one
    that is misaligned or of the wrong shape, raises before any launch."""
    index = tier["index"]
    table = bsearch_to_device(index, dev)
    packed, vbits, lens = _packed_reads(tier["genome"], 64, 5, dev)
    kw = dict(do_rc=True, bad_ix=BAD, num_labels=64, probe_iters=index.probe_iters)
    rec = table["rec"]
    buf = torch.empty(rec.numel() + 1, dtype=torch.int32, device=dev)
    shifted = buf[1:].view(rec.shape)
    shifted.copy_(rec)
    n0 = kernels.launches["bsearch_probe"]
    for bad in ({k: v for k, v in table.items() if k != "rec"}, dict(table, rec=shifted),
                dict(table, rec=rec[:-1])):
        with pytest.raises(ValueError, match="rec"):
            tl.window_ids(bad, packed, vbits, lens, **kw)
    assert kernels.launches["bsearch_probe"] == n0


@pytest.fixture(scope="module")
def k64(dev):
    index, genome, _ = tier64(40_000, 64)
    return dict(index=index, genome=genome)


def _ascii_reads(genome, n, seed, dev, read_len=150, width=192):
    """ASCII reads from the genome with N's, lower case, ragged lengths."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    starts = rng.integers(0, len(genome) - read_len, n)
    reads = np.zeros((n, width), np.uint8)
    reads[:, :read_len] = genome[starts[:, None] + np.arange(read_len)]
    reads[rng.random(reads.shape) < 0.005] = ord("N")
    low = rng.random(reads.shape) < 0.02
    reads[low] |= 0x20  # a, c, g, t (and n) count as bases too
    rand = rng.random(n) < 0.1
    reads[rand, :read_len] = rng.choice(acgt, (int(rand.sum()), read_len))
    lens = np.full(n, read_len, np.int32)
    lens[::3] = rng.integers(40, read_len, len(lens[::3]))
    return torch.from_numpy(reads).to(dev), torch.from_numpy(lens).to(dev)


def _table64(index, geometry, dev):
    from utree_tpu_torch.hash_index64 import (_canonical_groups64, _place64,
                                              build_canonical_hash_index64,
                                              build_displaced_index64)

    if geometry == "ladder":
        return canonical64_to_device(build_canonical_hash_index64(index), dev), "ladder_probe64"
    if geometry == "chain":  # the three-level shape, c64_3 in use
        built = _place64(*_canonical_groups64(index), 2, 16.0, 1, 1 << 26, slots3=8)
        assert built.t2.shape[0] > 8 and built.t3.shape[0] > 8
        return canonical64_to_device(built, dev), "ladder_probe64"
    if geometry == "displaced":
        return displaced64_to_device(build_displaced_index64(index), dev), "scan_probe64"
    built = build_displaced_index64(index, load=0.98, spill_budget=index.num_records)
    assert built.t3.shape[0] > 8  # the d64_3 tail is exercised
    return displaced64_to_device(built, dev), "scan_probe64"


@pytest.mark.parametrize("geometry", ["ladder", "chain", "displaced", "displaced-spill"])
def test_k5_k6_probe64_match_plain(k64, dev, geometry):
    """K6 on the default ladder and the three-level chain, K5 on the default
    displaced table and one that spills into d64_3; RC on and off; K2's
    unpacked rows (the PACKSIZE=64 readback) on their ids."""
    table, probe = _table64(k64["index"], geometry, dev)
    reads, lens = _ascii_reads(k64["genome"], 3000, 7, dev)
    nl = k64["index"].num_labels
    for do_rc in (True, False):
        n0 = kernels.launches[probe]
        ids = tl.window_ids64(table, reads, lens, do_rc=do_rc, bad_ix=0x7FFFFFFF)
        assert kernels.launches[probe] == n0 + 1
        assert ids.shape == (3000, 2 * 129 if do_rc else 129)
        assert torch.equal(ids, tl.window_ids64_plain(table, reads, lens, do_rc=do_rc,
                                                      bad_ix=0x7FFFFFFF))
        assert int((ids < nl).sum()) > 1000
        for cap in (1, 8, 30):
            assert torch.equal(tl.histogram_unpacked(ids, nl, cap),
                               tl.unpacked_hist(ids, nl, cap))


@pytest.mark.parametrize("kind", ["ladder", "displaced"])
def test_probe64_sentinels_match_plain(k64, dev, kind):
    """A DB of 12 64-mers spills nothing: c64_2, c64_3 and d64_3 are the
    8-row sentinels, which the kernels must not probe; u16 labels (bad_ix
    65535), reads over the 12 words' stretch of the genome."""
    from utree_tpu_torch.encode import sample_build_kmers
    from utree_tpu_torch.hash_index64 import (build_canonical_hash_index64,
                                              build_displaced_index64)

    genome = k64["genome"]
    words = np.sort(sample_build_kmers(genome[1000:1075].tobytes(), 64, 0),
                    order=("hi", "lo"))
    sub = index64(words, np.arange(len(words)) % 5, [b"l%d" % i for i in range(5)])
    if kind == "ladder":
        built = build_canonical_hash_index64(sub)
        assert built.t2.shape[0] == 8 and built.t3.shape[0] == 8
        table = canonical64_to_device(built, dev)
    else:
        built = build_displaced_index64(sub)
        assert built.t3.shape[0] == 8
        table = displaced64_to_device(built, dev)
    reads, lens = _ascii_reads(genome[980:1200], 500, 8, dev, read_len=150, width=192)
    for do_rc in (True, False):
        ids = tl.window_ids64(table, reads, lens, do_rc=do_rc, bad_ix=65535)
        assert torch.equal(ids, tl.window_ids64_plain(table, reads, lens, do_rc=do_rc,
                                                      bad_ix=65535))
        assert int((ids < 5).sum()) > 100


def _k6_edge_reads(genome, n, seed, dev, width):
    """n ASCII reads in rows of `width` (W = width - 63 windows), of lengths
    0 to width with some shorter than 64 bases, lower case and N's at
    random and at K6's tile edges, every 11th read all N."""
    rng = np.random.default_rng(seed)
    lens = rng.choice(sorted({0, 5, 63, 64, 65, 66, width - 1, width}), n).astype(np.int32)
    starts = rng.integers(0, len(genome) - width, n)
    reads = genome[starts[:, None] + np.arange(width)].copy()
    reads[rng.random(reads.shape) < 0.003] = ord("N")
    low = rng.random(reads.shape) < 0.02
    reads[low] |= 0x20
    reads = _tile_edge_ns(reads, lens, width - 63, 64)
    reads[::11] = ord("N")
    reads[np.arange(width)[None, :] >= lens[:, None]] = 0
    return torch.from_numpy(reads).to(dev), torch.from_numpy(lens).to(dev)


@pytest.mark.parametrize("width", [192, 200, 100, 73, 66, 65, 64], ids=lambda w: f"L={w}")
@pytest.mark.parametrize("geometry", ["chain", "chain-sentinels", "no-c2", "displaced",
                                      "displaced-spill", "displaced-sentinel"])
def test_k5_k6_tile_edges_match_plain(k64, dev, geometry, width):
    """K5's and K6's staged ASCII windows over rows whose W does not divide
    256 (129, 137, 37 and 10 windows), and rows of 1-3 windows, where a
    tile spans more bytes than it stages and its lanes read their bases
    with window_at; reads of 0 to L bases, all-N reads and N's at the
    tiles' edges; K6 on the three-level chain, the chain with c64_2 and
    c64_3 both the 8-row "absent" sentinel, and with c64_2 absent and c64_3
    in use; K5 on the default displaced table, one that spills into d64_3,
    and that one with d64_3 the 8-row sentinel; RC on and off: equal to the
    plain version, and the same over 10 launches."""
    if geometry.startswith("displaced"):
        table, probe = _table64(k64["index"], "displaced" if geometry == "displaced"
                                else "displaced-spill", dev)
        if geometry == "displaced-sentinel":
            table = dict(table, d64_3=_sentinel(table["d64_3"], 7))
    else:
        table, probe = _table64(k64["index"], "chain", dev)
        if geometry == "chain-sentinels":
            table = dict(table, c64_2=_sentinel(table["c64_2"], 4),
                         c64_3=_sentinel(table["c64_3"], 5))
        elif geometry == "no-c2":
            table = dict(table, c64_2=_sentinel(table["c64_2"], 6))
    reads, lens = _k6_edge_reads(k64["genome"], 777, 45, dev, width)
    nl = k64["index"].num_labels
    for do_rc in (True, False):
        kw = dict(do_rc=do_rc, bad_ix=0x7FFFFFFF)
        want = tl.window_ids64_plain(table, reads, lens, **kw)
        assert want.shape[1] == (2 if do_rc else 1) * (width - 63)
        assert int((want < nl).sum()) > (100 if width >= 100 else 10)
        n0 = kernels.launches[probe]
        for _ in range(10):
            assert torch.equal(tl.window_ids64(table, reads, lens, **kw), want)
        assert kernels.launches[probe] == n0 + 10
        assert (want[::11] == 0x7FFFFFFF).all()  # the all-N reads


def test_k6_refuses_misaligned_levels(k64, dev):
    """K6 and K5 load their rows as 16 B vectors: a c64_1, c64_2, c64_3,
    d64_1 or d64_3 that starts off a 16 B boundary raises before any
    launch."""
    reads, lens = _ascii_reads(k64["genome"], 64, 9, dev)
    for geometry, keys in (("chain", ("c64_1", "c64_2", "c64_3")),
                           ("displaced-spill", ("d64_1", "d64_3"))):
        table, probe = _table64(k64["index"], geometry, dev)
        n0 = kernels.launches[probe]
        for key in keys:
            t = table[key]
            buf = torch.empty(t.numel() + 2, dtype=torch.int32, device=dev)
            shifted = buf[2:].view(t.shape)  # 8 B past the allocation's start
            shifted.copy_(t)
            with pytest.raises(ValueError, match="16 B aligned"):
                tl.window_ids64(dict(table, **{key: shifted}), reads, lens, do_rc=True,
                                bad_ix=0x7FFFFFFF)
        assert kernels.launches[probe] == n0


@pytest.mark.parametrize("cap", [1, 8, 30])
def test_k8_hist_compact_matches_plain(tier, dev, cap):
    """K8 on K2's packed rows of tier reads (padding rows included) and on
    random rows over many tiles: a block that holds every flagged read, one
    that is one row short or a single row (the header keeps the true count,
    the rows past it are dropped), and one far larger."""
    packed, vbits, lens = _packed_reads(tier["genome"], 3000, 10, dev, padded=200)
    ids = tl.window_ids(tier["table"], packed, vbits, lens, do_rc=True, bad_ix=BAD,
                        num_labels=64)
    rng = np.random.default_rng(cap)
    b = 70_001  # 69 tiles of 1024 reads, the last one partial
    tail = rng.integers(0, cap + 2, b) | (rng.integers(0, 1 << 20, b) << 5)
    slots = rng.integers(-(1 << 31), 1 << 31, (b, cap))
    synth = torch.from_numpy(np.concatenate([slots, tail[:, None]], 1).astype(np.int32))
    for rows in (tl.histogram_packed(ids, 64, cap), synth.to(dev)):
        n_over = int(((rows[:, cap] & 31) >= 2).sum())
        assert n_over > 1
        for over_cap in (1, n_over - 1, n_over, 8192):
            n0 = kernels.launches["hist_compact"]
            got = tl.hist_compact(rows, over_cap)
            assert kernels.launches["hist_compact"] == n0 + 1
            assert got.shape == (2 * rows.shape[0] + (over_cap + 1) * (cap + 1),)
            assert torch.equal(got, tl.compact_rows(rows, over_cap))
            assert int(got[2 * rows.shape[0]]) == n_over


def _compact_rows_random(rng, b, cap):
    tail = rng.integers(0, cap + 2, b) | (rng.integers(0, 1 << 20, b) << 5)
    slots = rng.integers(-(1 << 31), 1 << 31, (b, cap))
    return torch.from_numpy(np.concatenate([slots, tail[:, None]], 1).astype(np.int32))


@pytest.mark.parametrize("b", [0, 1, 255, 257, 1000, 1023, 1024, 1025, 2049])
def test_k8_batch_edges_match_plain(dev, b):
    """K8 at B = 0 and 1, inside one tile (1024 reads), at a tile's edge and
    across two and three tiles (the look-back), with n_over past over_cap,
    at over_cap and far under it."""
    rng = np.random.default_rng(b)
    for cap in (1, 8, 30):
        rows = _compact_rows_random(rng, b, cap).to(dev)
        n_over = int(((rows[:, cap] & 31) >= 2).sum())
        for over_cap in (1, max(1, n_over - 1), max(1, n_over), 8192):
            got = tl.hist_compact(rows, over_cap)
            assert torch.equal(got, tl.compact_rows(rows, over_cap))
            assert int(got[2 * b]) == n_over


def test_k8_calls_in_a_row_match_plain(dev):
    """Calls one after another on one stream, on other rows and shapes,
    share K8's kept scratch: what one call leaves there must not reach the
    next.  A larger batch grows the scratch; a call on another stream has
    its own."""
    rng = np.random.default_rng(5)
    shapes = [(70_001, 8, 8192), (300, 8, 4), (70_001, 8, 1), (5000, 30, 700),
              (1, 8, 64), (0, 8, 64), (300_000, 8, 40_000), (64, 2, 3)]
    outs = []
    for b, cap, over_cap in shapes:
        rows = _compact_rows_random(rng, b, cap).to(dev)
        outs.append((tl.hist_compact(rows, over_cap), tl.compact_rows(rows, over_cap)))
    for got, want in outs:
        assert torch.equal(got, want)
    side = torch.cuda.Stream()
    rows = _compact_rows_random(rng, 10_000, 8).to(dev)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = tl.hist_compact(rows, 500)
    torch.cuda.synchronize()
    assert torch.equal(got, tl.compact_rows(rows, 500))


def test_k8_refuses_graph_capture(dev):
    """K8's kept scratch is valid by a per-call epoch, which a graph replay
    would reuse: a call under capture is refused, and the next call outside
    it still matches the plain version."""
    rows = _compact_rows_random(np.random.default_rng(6), 3000, 8).to(dev)
    tl.hist_compact(rows, 64)
    torch.cuda.synchronize()
    with pytest.raises(RuntimeError, match="CUDA graph"):
        with torch.cuda.graph(torch.cuda.CUDAGraph()):
            tl.hist_compact(rows, 64)
    assert torch.equal(tl.hist_compact(rows, 64), tl.compact_rows(rows, 64))


@pytest.mark.parametrize("labels", ["narrow", "wide"])
def test_k10_hash_probe_matches_plain(tier, dev, labels):
    """K10 on the legacy hash of a built DB (narrow labels, and the wide
    tier, whose ids are full int32 too), RC on and off, with the true_len
    trim, N's, ragged lengths and padding rows; every histogram layout on
    its ids."""
    from utree_tpu_torch.hash_index import build_hash_index, hash_to_device

    index, genome = (tier["index"], tier["genome"]) if labels == "narrow" else _wide_tier()[:2]
    table = hash_to_device(build_hash_index(index), dev)
    packed, vbits, lens = _packed_reads(genome, 3000, 11, dev, padded=50)
    _probe_and_hists(table, packed, vbits, lens, index.num_labels, "hash_probe")


def _placed_tables(packed, vbits, lens, seed):
    """Random t1 (256 rows) and t2 (64 rows) of 8 slots whose other slots
    hold random keys and ids, and into which a third of the batch's valid
    forward words (and a few RC words) are placed at their own buckets,
    some with ix -1: the slot rule, the t1-over-t2 rule and the negative ix
    are all exercised.  Built on the CPU with the plain version's mixes."""
    rng = np.random.default_rng(seed)
    t = [rng.integers(-(1 << 31), 1 << 31, (n, 24)).astype(np.int32) for n in (256, 64)]
    cpu = [x.cpu() for x in (packed, vbits, lens)]
    qpre, qhi, qlo, valid = tl.extract_windows(tl.base_codes_packed(*cpu))
    rpre, rhi, rlo = tl.rc_word_lanes(qpre, qhi, qlo)
    words = torch.cat([torch.stack([qpre, qhi, qlo], -1)[valid],
                       torch.stack([rpre, rhi, rlo], -1)[valid][:200]]).numpy()
    words = words[rng.random(len(words)) < 0.35]
    for pre, hi, lo in words:
        level = int(rng.random() < 0.3)  # a third go to t2 only
        mixed = tl.mix(torch.tensor(pre), torch.tensor(hi),
                       torch.tensor(lo ^ (0x5BD1E995 if level else 0)))
        row = int(mixed) & (t[level].shape[0] - 1)
        s = int(rng.integers(0, 8))
        ix = -1 if rng.random() < 0.1 else int(rng.integers(0, 60))
        t[level][row, 3 * s:3 * s + 3] = np.array([lo, (pre << 8) | hi, ix],
                                                  np.int64).astype(np.uint32).view(np.int32)
    return {"t1": torch.from_numpy(t[0]), "t2": torch.from_numpy(t[1])}


@pytest.fixture(scope="module")
def hash_tables(tier, dev):
    """The legacy hash of the narrow tier and of the wide one (70,064 labels,
    IXTYPE=u32), with their genomes and label counts."""
    from utree_tpu_torch.hash_index import build_hash_index, hash_to_device

    wide, wgenome, _ = _wide_tier()
    return {labels: (hash_to_device(build_hash_index(index), dev), genome, index.num_labels)
            for labels, index, genome in (("narrow", tier["index"], tier["genome"]),
                                          ("wide", wide, wgenome))}


@pytest.mark.parametrize("labels", ["narrow", "wide"])
def test_k10_tile_edges_match_plain(hash_tables, dev, labels):
    """K10's staged raw words at its tiles' edges (128 windows a block with
    RC, 256 without; W = 161, 121 and 9 divide neither), with and without
    RC, untrimmed and trimmed to 152, 40 (nine windows) and 32 bases (one
    window: a tile then spans more reads than its staged words hold, and it
    reads its bases with window_at); reads of 0-192 bases, all-N reads and
    N's at the tiles' edges: equal to the plain version, and the same over
    20 launches."""
    table, genome, num_labels = hash_tables[labels]
    packed, vbits, lens = _k7_edge_reads(genome, 777, 46, dev, tile=128)
    bad = 0x7FFFFFFF if labels == "wide" else BAD
    for do_rc in (True, False):
        for true_len in (None, 152, 40, 32):
            kw = dict(do_rc=do_rc, bad_ix=bad, true_len=true_len, num_labels=num_labels)
            want = tl.window_ids_plain(table, packed, vbits, lens, **kw)
            assert want.shape[1] == (2 if do_rc else 1) * ((true_len or 192) - 31)
            assert int((want < num_labels).sum()) > (0 if (true_len or 192) < 40 else 1000)
            n0 = kernels.launches["hash_probe"]
            for _ in range(20):
                assert torch.equal(tl.window_ids(table, packed, vbits, lens, **kw), want)
            assert kernels.launches["hash_probe"] == n0 + 20
            assert (want[::11] == bad).all()  # the all-N reads


def test_k10_on_random_tables(tier, dev):
    """K10 on tables of random slots with the batch's own words placed in
    them (see _placed_tables), RC on and off; and the table checks."""
    packed, vbits, lens = _packed_reads(tier["genome"], 2000, 12, dev, padded=20)
    table = {k: v.to(dev) for k, v in _placed_tables(packed, vbits, lens, 3).items()}
    for do_rc in (True, False):
        kw = dict(do_rc=do_rc, bad_ix=BAD, num_labels=64)
        n0 = kernels.launches["hash_probe"]
        ids = tl.window_ids(table, packed, vbits, lens, **kw)
        assert kernels.launches["hash_probe"] == n0 + 1
        assert torch.equal(ids, tl.window_ids_plain(table, packed, vbits, lens, **kw))
        assert int((ids < 60).sum()) > 1000
    for bad in (dict(t1=table["t1"][:, :21].contiguous()), dict(t2=table["t2"][:48])):
        with pytest.raises(ValueError, match="hash tables"):
            tl.window_ids({**table, **bad}, packed, vbits, lens, do_rc=True, bad_ix=BAD,
                          num_labels=64)


def _pipeline_reads(path, genome, rng):
    """900 tier reads, 40 chimeras of three 50 bp pieces (3 labels a read:
    hist_cap=2 overflows) and three long reads."""
    reads = make_reads(genome, rng, 900)
    write_fasta(path, reads)
    with open(path, "ab") as f:
        for i in range(40):
            starts = rng.integers(0, len(genome) - 50, 3)
            f.write(b">chimera%d\n" % i
                    + b"".join(genome[s:s + 50].tobytes() for s in starts) + b"\n")
        for i in range(3):
            s = int(rng.integers(0, len(genome) - 3000))
            f.write(b">long%d\n" % i + genome[s:s + 1500 + 700 * i].tobytes() + b"\n")


# entry points each path must launch (the histogram step of long reads adds
# histogram_packed or histogram_unpacked); "support8" is support_ranges=8
# and "cvote" device_vote=False, both the compact readback
_PATHS = {
    ("narrow", "auto"): {"ladder_probe", "histogram", "aufbau_vote", "histogram_packed"},
    ("narrow", "displaced"): {"scan_probe", "histogram", "aufbau_vote", "histogram_packed"},
    ("narrow", "bsearch"): {"bsearch_probe", "histogram", "aufbau_vote", "histogram_packed"},
    ("narrow", "hash"): {"hash_probe", "histogram", "aufbau_vote", "histogram_packed"},
    ("cvote", "hash"): {"hash_probe", "histogram_packed", "hist_compact"},
    ("wide", "hash"): {"hash_probe", "histogram_unpacked"},
    ("support8", "displaced"): {"scan_probe", "histogram_packed", "hist_compact"},
    ("cvote", "auto"): {"ladder_probe", "histogram_packed", "hist_compact"},
    ("wide", "auto"): {"ladder_probe_wide", "histogram_unpacked"},
    ("wide", "displaced"): {"scan_probe_wide", "histogram_unpacked"},
    ("wide", "bsearch"): {"bsearch_probe", "histogram_unpacked"},
    ("k64", "auto"): {"ladder_probe64", "histogram_unpacked"},
    ("k64", "displaced"): {"scan_probe64", "histogram_unpacked"},
}


@pytest.mark.parametrize("labels,mode", list(_PATHS), ids=lambda x: str(x))
def test_cuda_pipeline_equals_cpu_pipeline(tmp_path, dev, labels, mode):
    """The whole search through the kernels equals the plain versions' run,
    long reads included, and every kernel of the path was launched."""
    from utree_tpu_torch.pipeline import SearchPipeline

    if labels == "wide":
        index, genome, rng = _wide_tier()
    elif labels == "k64":
        index, genome, rng = tier64(40_000, 64)
    else:
        index, genome, rng = make_tier(40_000, 64)
    _pipeline_reads(tmp_path / "reads.fa", genome, rng)
    kw = {"support8": dict(support_ranges=8), "cvote": dict(device_vote=False)}.get(labels, {})
    outs = {}
    for device in ("cpu", "cuda"):
        kernels.reset_launches()
        pipe = SearchPipeline(index, device=device, do_rc=True, batch_size=128,
                              hist_cap=2, lookup_mode=mode, **kw)
        pipe.long_read_threshold, pipe.long_chunk = 1000, 256
        pipe.search_file(str(tmp_path / "reads.fa"), str(tmp_path / f"{device}.txt"))
        outs[device] = (tmp_path / f"{device}.txt").read_bytes()
        launched = {k for k, n in kernels.launches.items() if n}
        assert launched == (_PATHS[labels, mode] if device == "cuda" else set())
    assert outs["cuda"] == outs["cpu"]
    assert outs["cpu"].count(b"\n") > 700


@pytest.fixture(scope="module")
def xt_refs(dev, tmp_path_factory):
    """chip_smoke's xtree reference set at 8 x 3000 bp, plus one line of
    28 bp reverse-complement palindromes (palindromic pods at every even
    k).  Returns (dir, genomes, palindrome line)."""
    wd = tmp_path_factory.mktemp("xt")
    genomes = xtree_refs(wd / "refs.fa", wd / "tax.map", 8, 3000, seed=3)
    rng = np.random.default_rng(4)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    pal = b""
    for _ in range(30):
        half = rng.choice(acgt, 14).tobytes()
        pal += half + half[::-1].translate(bytes.maketrans(b"ACGT", b"TGCA")) + b"GATTACA"
    with open(wd / "refs.fa", "ab") as f:
        f.write(b">palref\n" + pal + b"\n")
    with open(wd / "tax.map", "ab") as f:
        f.write(b"palref\tk__Bacteria;p__phy0;c__cls0;o__ord0;f__fam0;g__gen0;s__pal"
                b"\tfunc__0\n")
    return wd, genomes, np.frombuffer(pal, np.uint8)


def _xt_batch(genomes, pal, n, seed, dev, width=192, padded=5, past_len=False):
    """ASCII queries of 150 bp (a tenth over the palindromes) with N's,
    lower case, random rows and ragged lengths; the last `padded` rows have
    length 0, as a chunk's padding rows do.  The bytes past each length are
    0, or with `past_len` random A, C, G and T."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    which = rng.integers(0, len(genomes), n)
    starts = rng.integers(0, genomes.shape[1] - 150, n)
    reads = np.zeros((n, width), np.uint8)
    reads[:, :150] = genomes[which[:, None], starts[:, None] + np.arange(150)]
    on_pal = rng.random(n) < 0.1
    ps = rng.integers(0, len(pal) - 150, int(on_pal.sum()))
    reads[on_pal, :150] = pal[ps[:, None] + np.arange(150)]
    reads[rng.random(reads.shape) < 0.005] = ord("N")
    reads[rng.random(reads.shape) < 0.02] |= 0x20
    rand = rng.random(n) < 0.1
    reads[rand, :150] = rng.choice(acgt, (int(rand.sum()), 150))
    lens = np.full(n, 150, np.int32)
    lens[::4] = rng.integers(10, 150, len(lens[::4]))
    lens[n - padded:] = 0
    past = np.arange(width)[None, :] >= lens[:, None]
    reads[past] = rng.choice(acgt, int(past.sum())) if past_len else 0
    return torch.from_numpy(reads).to(dev), torch.from_numpy(lens).to(dev)


@pytest.mark.parametrize("k", [14, 16, 20, 28, 29])
def test_k9_xtree_probe_matches_plain(xt_refs, dev, k):
    """K9 equals its plain version on all four matrices, on a built DB's
    table (hits on both strands, palindromes at even k) and on random
    tables whose d3 tail is probed by every window; and on a batch whose
    bytes past each length are bases, which the staged front must mask as
    past the length (code 0, the window invalid, prefix bins included)."""
    from utree_tpu_torch.xtree.align import XtreeAligner
    from utree_tpu_torch.xtree.build import build_xtree_db
    from utree_tpu_torch.xtree.device import xtree_step, xtree_step_plain

    wd, genomes, pal = xt_refs
    al = XtreeAligner(build_xtree_db(str(wd / "refs.fa"), str(wd / "tax.map"), k=k),
                      device=dev)
    reads, lens = _xt_batch(genomes, pal, 3000, k, dev)
    rng = np.random.default_rng(k)
    rand = {name: torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, shape)
                                   .astype(np.int32)).to(dev)
            for name, shape in (("d1", (4096, 8)), ("ds", (1024,)), ("d3", (64, 16)))}
    kw = dict(k=k, sl=k - 13)
    past = _xt_batch(genomes, pal, 3000, k, dev, past_len=True)
    for tables in (al.tables, rand):
        for batch in ((reads, lens), past):
            n0 = kernels.launches["xtree_probe"]
            got = xtree_step(tables, *batch, **kw)
            assert kernels.launches["xtree_probe"] == n0 + 1
            want = xtree_step_plain(tables, *batch, **kw)
            assert all(g.shape == (3000, 192 - k + 1) and torch.equal(g, w)
                       for g, w in zip(got, want))
    sf, sr, pf, pr = xtree_step(al.tables, reads, lens, **kw)
    assert int((sf >= 0).sum()) > 1000
    assert bool(((sf == sr) & (sf >= 0) & (pf == pr)).any()) == (k % 2 == 0)
    assert torch.equal(xtree_step(al.tables, *past, **kw)[0], sf)  # same queries


@pytest.mark.parametrize("k", [14, 29])
def test_k9_tile_edges_match_plain(xt_refs, dev, k):
    """Rows of T = k to 200 bytes (W = 1 to 200 - k + 1 windows) over 301
    queries, so the lanes end inside a block: at W = 1 a tile of 256 lanes
    spans 256 rows, more than the staged chunks hold, so every lane reads
    its bases byte by byte; at W = 3 so does k = 29's.  Lengths past T,
    inside it and 0, bases past each length."""
    from utree_tpu_torch.xtree.align import XtreeAligner
    from utree_tpu_torch.xtree.build import build_xtree_db
    from utree_tpu_torch.xtree.device import xtree_step, xtree_step_plain

    wd, genomes, pal = xt_refs
    al = XtreeAligner(build_xtree_db(str(wd / "refs.fa"), str(wd / "tax.map"), k=k),
                      device=dev)
    reads, lens = _xt_batch(genomes, pal, 301, 40 + k, dev, width=200, padded=3,
                            past_len=True)
    kw = dict(k=k, sl=k - 13)
    for t in (k, k + 1, k + 2, k + 7, 64, 150, 193, 200):
        rows = reads[:, :t].contiguous()
        got = xtree_step(al.tables, rows, lens, **kw)
        want = xtree_step_plain(al.tables, rows, lens, **kw)
        assert all(g.shape == (301, t - k + 1) and torch.equal(g, w)
                   for g, w in zip(got, want)), t
        assert (301 * (t - k + 1)) % 256
        if t >= 150:
            assert int((want[0] >= 0).sum()) > 1000


def test_k9_refuses_misaligned_rows(dev):
    """K9 loads a d1 row as two 16 B vectors: a d1 that starts off a 16 B
    boundary raises before any launch."""
    from utree_tpu_torch.xtree.device import xtree_step

    d1 = torch.zeros((4096, 8), dtype=torch.int32, device=dev)
    buf = torch.empty(d1.numel() + 1, dtype=torch.int32, device=dev)
    tables = {"d1": buf[1:].view(d1.shape), "ds": torch.zeros(1024, dtype=torch.int32,
                                                               device=dev),
              "d3": torch.zeros((8, 16), dtype=torch.int32, device=dev)}
    reads = torch.full((4, 64), ord("A"), dtype=torch.uint8, device=dev)
    lens = torch.full((4,), 64, dtype=torch.int32, device=dev)
    n0 = kernels.launches["xtree_probe"]
    with pytest.raises(ValueError, match="16 B aligned"):
        xtree_step(tables, reads, lens, k=29, sl=16)
    assert kernels.launches["xtree_probe"] == n0


@pytest.mark.parametrize("redist", [False, True])
def test_xtree_align_cuda_equals_host(xt_refs, dev, tmp_path, redist):
    """ALIGN through K9 writes the host engine's perq, ref, tax and cov
    bytes, 97 queries a chunk, with and without redistribution; every chunk
    launched K9."""
    from utree_tpu_torch.xtree.align import AlignOptions, XtreeAligner
    from utree_tpu_torch.xtree.build import build_xtree_db

    wd, genomes, pal = xt_refs
    reads, lens = _xt_batch(genomes, pal, 1000, 11, dev, padded=0)
    reads, lens = reads.cpu().numpy(), lens.cpu().numpy()
    with open(tmp_path / "q.fa", "wb") as f:
        for i in range(len(reads)):
            f.write(b">q%d extra words\n" % i + reads[i, :lens[i]].tobytes() + b"\n")
    db = build_xtree_db(str(wd / "refs.fa"), str(wd / "tax.map"), k=29)
    outs = {}
    for device in (None, dev):
        al = XtreeAligner(db, device=device)
        al.chunk_queries = 97
        n0 = kernels.launches["xtree_probe"]
        al.align_file(str(tmp_path / "q.fa"), AlignOptions(
            confidence=0.9, do_redist=redist,
            **{f"{o}_out": str(tmp_path / f"{device}.{o}") for o in ("perq", "ref", "tax", "cov")}))
        assert kernels.launches["xtree_probe"] - n0 == (0 if device is None else 11)
        outs[device] = [(tmp_path / f"{device}.{o}").read_bytes()
                        for o in ("perq", "ref", "tax", "cov")]
    assert outs[dev] == outs[None]
    assert outs[None][0].count(b"\n") == 1000


# ---- K11-K13: the routed displaced shards ------------------------------------------

@pytest.fixture(scope="module")
def routed(dev):
    """The 40,000-k-mer tier sharded 4 ways, narrow and wide (load 0.98, so
    the merged t3 is exercised), with the shard tables on the card."""
    from utree_tpu_torch.parallel.mesh import ShardMesh
    from utree_tpu_torch.parallel.routed import ShardedDisplacedIndex

    index, genome, _ = make_tier(40_000, 64)
    widx, _, _ = _wide_tier(40_000, 64)
    out = {"genome": genome, "mesh": ShardMesh([dev] * 4), "cpu": ShardMesh(["cpu"] * 4)}
    for key, ix in (("narrow", index), ("wide", widx)):
        sh = ShardedDisplacedIndex.build(ix, 4, load=0.98, spill_budget=ix.num_records)
        assert sh.t3.shape[0] > 8
        out[key] = (sh, sh.to_devices(out["mesh"]), sh.to_devices(out["cpu"]),
                    ix.num_labels)
    return out


def _on_cpu(*ts):
    return [t.cpu() for t in ts]


@pytest.mark.parametrize("case", ["auto", "overflow", "padded", "one-read-8-shards",
                                  "fallback"])
def test_k11_route_displaced_matches_plain(routed, dev, case):
    """Ranks in lane order even when a batch overflows (capacity 8), padding
    rows and owners that get no lane (one read of five windows over 8
    shards), and the one-shard pass of the fallback."""
    from utree_tpu_torch.parallel import routed as R

    sh = routed["narrow"][0]
    n, padded, S = {"padded": (600, 200, 4), "one-read-8-shards": (1, 0, 8)}.get(
        case, (3000, 0, 4))
    packed, vbits, lens = _packed_reads(routed["genome"], n, 31, dev, padded=padded)
    if case == "one-read-8-shards":
        lens[:] = 36  # five windows: three owners or more get no lane
    w = packed.shape[1] * 4 - 31
    cap = {"overflow": 8, "fallback": n * w}.get(case, max(128, -(-n * w // S // 128) * 128))
    if case == "fallback":
        S = 1
    nseed = sh.nseed * 2 if case == "one-read-8-shards" else sh.nseed
    kw = dict(nseed=nseed, num_shards=S, capacity=cap)
    n0 = kernels.launches["route_displaced"]
    got = R.route_displaced(packed, vbits, lens, **kw)
    assert kernels.launches["route_displaced"] == n0 + 1
    want = R.route_displaced_plain(*_on_cpu(packed, vbits, lens), **kw)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    counts = want[2]
    assert int(counts[S]) == (case == "overflow")
    if case == "one-read-8-shards":
        assert int((counts[:S] == 0).sum()) >= 1


@pytest.mark.parametrize("capacity", ["step", "8"])
@pytest.mark.parametrize("buckets", ["nseed", "b1"])
@pytest.mark.parametrize("S", [1, 2, 4, 8, 16, 32, 64])
def test_k11_look_back_at_the_shard_shape(routed, dev, S, buckets, capacity):
    """K11 at phase 15's shard shape (16,384 reads of 192 positions: 2,637,824
    lanes, 2,576 tiles, so the look-back crosses many tiles) for 1 to 64
    owners (above 8 a warp looks back for several), a displaced seed count
    and b1, at the step's capacity (S = 1:
    the fallback's B*W) and at 8 (every owner overflows): equal to the plain
    version and the same over 20 launches (a look-back race shows only now
    and then)."""
    from utree_tpu_torch.parallel import routed as R

    packed, vbits, lens = _packed_reads(routed["genome"], 16_384, 15 + S, dev)
    b, w = packed.shape[0], packed.shape[1] * 4 - 31
    assert b * w == 2_637_824
    step = b * w if S == 1 else max(128, -(-int(b * w / S * R.CAPACITY_FACTOR) // 128) * 128)
    kw = dict(nseed={"nseed": 1 << 23, "b1": 1 << 27}[buckets], num_shards=S,
              capacity=step if capacity == "step" else 8)
    want = R.route_displaced_plain(packed, vbits, lens, **kw)
    first = R.route_displaced(packed, vbits, lens, **kw)
    assert all(torch.equal(a, b) for a, b in zip(first, want))
    assert int(want[2][S]) == (capacity == "8")
    for _ in range(20):
        again = R.route_displaced(packed, vbits, lens, **kw)
        assert all(torch.equal(a, b) for a, b in zip(again, first))


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_k12_k13_match_plain(routed, dev, wide):
    """K12 on a routed receive buffer (base 0) and on fallback lanes (base
    s*per_seed, with an empty shard: lanes of shard 0's buckets only); K13
    on the records and replies, with and without RC."""
    from utree_tpu_torch.parallel import routed as R

    sh, tabs, ctabs, _ = routed["wide" if wide else "narrow"]
    per_seed = sh.nseed // 4
    packed, vbits, lens = _packed_reads(routed["genome"], 2000, 37, dev, padded=3)
    b, w = packed.shape[0], packed.shape[1] * 4 - 31
    send, rec, _ = R.route_displaced(packed, vbits, lens, nseed=sh.nseed, num_shards=4,
                                     capacity=b * w)
    # the fallback's lanes: one shard with room for all, global buckets
    glanes = R.route_displaced(packed, vbits, lens, nseed=sh.nseed, num_shards=1,
                               capacity=b * w)[0].reshape(-1, 3)
    name = "owner_probe" + ("_wide" if wide else "")
    for s in range(4):
        for lanes, base in ((send[s], 0), (glanes, s * per_seed)):
            n0 = kernels.launches[name]
            got = R.owner_probe(tabs[s]["t1"], tabs[s]["ds"], lanes.contiguous(), base=base,
                                per_seed=per_seed, wide=wide)
            assert kernels.launches[name] == n0 + 1
            want = R.owner_probe_plain(ctabs[s]["t1"], ctabs[s]["ds"], lanes.cpu(),
                                       base=base, per_seed=per_seed, wide=wide)
            assert torch.equal(got.cpu(), want) and int((want != 0).sum()) > 100
    zeros = torch.zeros((100, 3), dtype=torch.int32, device=dev)
    empty = R.owner_probe(tabs[3]["t1"], tabs[3]["ds"], zeros, base=3 * per_seed,
                          per_seed=per_seed, wide=wide)
    assert int((empty != 0).sum()) == 0  # shard 3 owns none of bucket 0's lanes
    reply = torch.stack([R.owner_probe(tabs[o]["t1"], tabs[o]["ds"], send[o].contiguous(),
                                       base=0, per_seed=per_seed, wide=wide)
                         for o in range(4)])
    name = "routed_finish" + ("_wide" if wide else "")
    for do_rc in (True, False):
        kw = dict(b=b, w=w, do_rc=do_rc, bad_ix=BAD if not wide else 0x7FFFFFFF, wide=wide)
        n0 = kernels.launches[name]
        got = R.routed_finish(rec, reply.contiguous(), tabs[0]["t3"], **kw)
        assert kernels.launches[name] == n0 + 1
        want = R.routed_finish_plain(rec.cpu(), reply.cpu(), ctabs[0]["t3"], **kw)
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("capacity", [None, 8], ids=["cap-auto", "cap-8"])
def test_routed_steps_on_one_card_equal_cpu(routed, dev, capacity):
    """The routed step and its fallback over four shards on one card equal
    the same steps on four CPU shards, every int32 (overflow column too)."""
    from utree_tpu_torch.parallel import routed as R

    sh, tabs, ctabs, nl = routed["narrow"]
    packed, vbits, lens = _packed_reads(routed["genome"], 1000, 41, dev)
    kw = dict(do_rc=True, num_labels=nl, cap=8, bad_ix=BAD)

    def run(mesh, tables, args):
        return [torch.cat(R.routed_displaced_search_step(
                    mesh, sh, capacity=capacity, **kw)(tables, *args)).cpu(),
                torch.cat(R.routed_displaced_fallback_step(mesh, sh, **kw)(tables, *args)).cpu()]

    gpu = run(routed["mesh"], tabs, (packed, vbits, lens))
    cpu = run(routed["cpu"], ctabs, _on_cpu(packed, vbits, lens))
    assert all(torch.equal(a, b) for a, b in zip(gpu, cpu))
    assert int(gpu[0][0, -1]) == (4 if capacity == 8 else 0)


def test_devices_beyond_the_cards_raise(dev):
    from utree_tpu_torch.pipeline import SearchPipeline

    n = torch.cuda.device_count()
    index, _, _ = make_tier(20_000, 64)
    with pytest.raises(ValueError, match=f"--devices {n + 1} requested but only {n} present"):
        SearchPipeline(index, device="cuda", devices=n + 1, batch_size=64 * (n + 1))


# ---- K14-K16: the ASCII k=32 step and the sharded modes ---------------------------

def _ascii_k32(genome, n, seed, dev, width):
    """(n, width) ASCII reads with N's, lower case and lengths from 0 to
    width (rows 0-2: 0, 31, 32 bases), bases left past the length."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(genome) - width, n)
    reads = genome[starts[:, None] + np.arange(width)].copy()
    reads[rng.random(reads.shape) < 0.02] = ord("N")
    reads[rng.random(reads.shape) < 0.05] |= 0x20
    lens = np.full(n, width, np.int32)
    lens[::3] = rng.integers(0, width + 1, len(lens[::3]))
    lens[:3] = (0, 31, 32)
    return torch.from_numpy(reads).to(dev), torch.from_numpy(lens).to(dev)


@pytest.fixture(scope="module")
def k32(tier, dev):
    """The tier's four k=32 tables on the card."""
    from utree_tpu_torch.hash_index import (build_canonical_hash_index, build_hash_index,
                                            canonical_to_device, hash_to_device)

    index = tier["index"]
    return {"bsearch": bsearch_to_device(index, dev), "d1": tier["table"],
            "c1": canonical_to_device(build_canonical_hash_index(index), dev),
            "t1": hash_to_device(build_hash_index(index), dev)}


@pytest.mark.parametrize("width", [120, 150, 200])
def test_k14_ascii_pack_and_search_step_match_plain(tier, k32, dev, width):
    """K14 in both modes against its plain version; search_step over each
    k=32 table (K14, the probe, the trim) against the CPU twin."""
    reads, lens = _ascii_k32(tier["genome"], 2000, width, dev, width)
    for rc in (False, True):
        n0 = kernels.launches["ascii_pack"]
        got = tl.ascii_pack(reads, lens, rc)
        assert kernels.launches["ascii_pack"] == n0 + 1
        want = tl.ascii_pack_plain(reads, lens, rc)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    index = tier["index"]
    for kind, table in k32.items():
        ctable = {k: v.cpu() for k, v in table.items()}
        for do_rc in (True, False):
            kw = dict(k=32, do_rc=do_rc, probe_iters=index.probe_iters, bad_ix=BAD,
                      num_labels=64)
            got = tl.search_step(table, reads, lens, **kw)
            want = tl.search_step(ctable, reads.cpu(), lens.cpu(), **kw)
            assert torch.equal(got.cpu(), want), (kind, do_rc)
        if kind in ("bsearch", "t1"):
            kw.pop("num_labels")
            got = tl.search_step_hist(table, reads, lens, num_labels=64, cap=8, **kw)
            want = tl.search_step_hist(ctable, reads.cpu(), lens.cpu(), num_labels=64,
                                       cap=8, **kw)
            assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("S", [1, 2, 4, 8])
def test_k15_bsearch_probe_shard_matches_plain(tier, dev, S):
    """Every slice of an S-way ShardedIndex, RC on and off, at a width that
    is no multiple of 8 and at the padded one; S = 1's one slice holds every
    word in range.  Then three reads, fewer lanes than one tile, and reads
    of ACAC... whose words have four prefixes (0x111111, 0x444444 and their
    RC words' 0xBBBBBB, 0xEEEEEE), so at S = 8 four slices hold none."""
    from utree_tpu_torch.parallel import sharded as TS
    from utree_tpu_torch.parallel.mesh import ShardMesh

    sh = TS.ShardedIndex.from_index(tier["index"], S)
    tabs = sh.to_devices(ShardMesh([dev] * S))
    per = sh.bin_ix.shape[1] - 1
    reads, lens = _ascii_k32(tier["genome"], 3000, 7 + S, dev, 150)
    acac = torch.from_numpy(np.resize(np.frombuffer(b"AC", np.uint8), (40, 150)).copy())
    acac_lens = torch.from_numpy(np.arange(40, dtype=np.int32) * 3 + 31)
    batches = [(reads, lens), (reads[:3], lens[:3]), (acac.to(dev), acac_lens.to(dev))]
    for i, (r, ln) in enumerate(batches):
        packed, vbits = tl.ascii_pack(r, ln)
        codes = tl.base_codes_packed(packed, vbits, ln)[:, :150]
        qpre, qhi, qlo, valid = tl.extract_windows(codes)
        pres = (qpre, tl.rc_word_lanes(qpre, qhi, qlo)[0])
        in_range = []
        for t in range(S):
            lo = int(sh.prefix_lo[t])
            in_range.append(sum(int((valid & (p >= lo) & (p < lo + per)).sum()) for p in pres))
            for do_rc in (True, False):
                for width in (150, 152):
                    kw = dict(prefix_lo=lo, width=width, do_rc=do_rc,
                              probe_iters=sh.probe_iters)
                    n0 = kernels.launches["bsearch_probe_shard"]
                    got = TS.shard_probe(tabs[t], packed, vbits, ln, **kw)
                    assert kernels.launches["bsearch_probe_shard"] == n0 + 1
                    want = TS.shard_probe_plain(tabs[t], packed, vbits, ln, **kw)
                    assert all(torch.equal(a, b) for a, b in zip(got, want))
                    if i == 0:
                        assert int(want[1].sum()) > 100
        assert sum(in_range) == 2 * int(valid.sum())
        if i == 2 and S == 8:
            assert in_range.count(0) == 4


@pytest.mark.parametrize("labels", [1, 5, 4096, 57344, 57345, 70000])
def test_k16_label_histogram_matches_plain(dev, labels):
    """Shared-memory counts up to 57,344 labels, global atomics above;
    negative ids as JAX's `.at[]` wraps them."""
    from utree_tpu_torch.parallel import sharded as TS

    rng = np.random.default_rng(labels)
    for shape in ((1, 7), (3, 5000), (8, 250_000)):
        ids = rng.integers(-labels - 3, labels + 3, shape).astype(np.int32)
        ids[0, 0] = -1
        t = torch.from_numpy(ids).to(dev)
        n0 = kernels.launches["label_histogram"]
        got = TS.label_histogram(t, labels)
        assert kernels.launches["label_histogram"] == n0 + 1
        assert torch.equal(got.cpu(), TS.label_histogram_plain(t.cpu(), labels))


def test_sharded_steps_on_one_card_equal_cpu(tier, k32, dev):
    """The three modes with every device on the one card against the same
    meshes of CPU devices; the dryrun on eight shards of the card."""
    from utree_tpu_torch import dryrun
    from utree_tpu_torch.parallel import sharded as TS
    from utree_tpu_torch.parallel.mesh import make_mesh

    index = tier["index"]
    reads, lens = _ascii_k32(tier["genome"], 1024, 43, dev, 150)
    for shape in ((2, 4), (1, 8), (2, 1)):
        gm, cm = make_mesh(*shape, [dev] * (shape[0] * shape[1])), make_mesh(
            *shape, ["cpu"] * (shape[0] * shape[1]))
        sh = TS.ShardedIndex.from_index(index, shape[1])
        for do_rc in (True, False):
            got = TS.sharded_search_step(gm, sh, do_rc)(sh.to_devices(gm), reads, lens)
            want = TS.sharded_search_step(cm, sh, do_rc)(sh.to_devices(cm), reads.cpu(),
                                                         lens.cpu())
            assert torch.equal(got.cpu(), want)
        for kind in ("bsearch", "d1"):
            ctab = {k: v.cpu() for k, v in k32[kind].items()}
            got = TS.replicated_search_step(gm, index, True)(gm.replicate(k32[kind]),
                                                             reads, lens)
            want = TS.replicated_search_step(cm, index, True)(cm.replicate(ctab),
                                                              reads.cpu(), lens.cpu())
            assert torch.equal(got.cpu(), want)
    chunks, clens = TS.split_long_read(tier["genome"][:40_000].tobytes(), 8, 32)
    gm, cm = make_mesh(4, 2, [dev] * 8), make_mesh(4, 2, ["cpu"] * 8)
    ctab = {k: v.cpu() for k, v in k32["bsearch"].items()}
    got = TS.long_read_histogram(gm, index, 64, True)(
        gm.replicate(k32["bsearch"]), torch.from_numpy(chunks), torch.from_numpy(clens))
    want = TS.long_read_histogram(cm, index, 64, True)(
        cm.replicate(ctab), torch.from_numpy(chunks), torch.from_numpy(clens))
    assert torch.equal(got.cpu(), want) and int(want.sum()) > 10_000
    dryrun.dryrun_multichip(8, shard_devices=[dev] * 8)


# ---- K11 at b1, K17, K18: the routed canonical-table steps ----------------------

@pytest.fixture(scope="module")
def routed_canon(dev):
    """The 40,000-k-mer tier's ladder (default and chain geometry, narrow)
    and the wide tier's (default and chain), each sharded 4 ways; the
    shard tables on the card as a (1, 4) and a (2, 4) mesh and on CPU."""
    from utree_tpu_torch.parallel.mesh import make_mesh
    from utree_tpu_torch.parallel.routed import ShardedCanonicalIndex

    index, genome, _ = make_tier(40_000, 64)
    widx, wgenome, _ = _wide_tier(40_000, 64)
    out = {"genome": genome, "wgenome": wgenome}
    for kind, ix in (("narrow", index), ("wide", widx)):
        for geometry in ("default", "chain"):
            sh = ShardedCanonicalIndex.from_canonical(_ladder(ix, geometry), 4)
            assert sh.wide == (kind == "wide")
            out[(kind, geometry)] = (sh, ix.num_labels)
    out["meshes"] = {shape: (make_mesh(*shape, [dev] * (shape[0] * 4)),
                             make_mesh(*shape, ["cpu"] * (shape[0] * 4)))
                     for shape in ((1, 4), (2, 4))}
    return out


@pytest.mark.parametrize("capacity", ["auto", "overflow", "fallback"])
def test_k11_route_at_b1_matches_plain(routed_canon, dev, capacity):
    """K11 with nseed = b1 (the canonical t1 bucket): four owners at the
    step's capacity and at capacity 8, and the fallback's one-shard pass."""
    from utree_tpu_torch.parallel import routed as R

    sh = routed_canon[("narrow", "default")][0]
    packed, vbits, lens = _packed_reads(routed_canon["genome"], 3000, 47, dev, padded=7)
    n, w = packed.shape[0], packed.shape[1] * 4 - 31
    S, cap = {"auto": (4, max(128, -(-n * w // 4 // 128) * 128)), "overflow": (4, 8),
              "fallback": (1, n * w)}[capacity]
    kw = dict(nseed=sh.b1, num_shards=S, capacity=cap)
    n0 = kernels.launches["route_displaced"]
    got = R.route_displaced(packed, vbits, lens, **kw)
    assert kernels.launches["route_displaced"] == n0 + 1
    want = R.route_displaced_plain(*_on_cpu(packed, vbits, lens), **kw)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    assert int(want[2][S]) == (capacity == "overflow")


@pytest.mark.parametrize("geometry", ["default", "chain"])
@pytest.mark.parametrize("kind", ["narrow", "wide"])
def test_k17_k18_match_plain(routed_canon, dev, kind, geometry):
    """K17 on each owner's receive buffer (base 0) and on the fallback's
    lanes (base s*b1/4); K18 on the records and the replies, RC on and
    off, on tier A's ladder (a small c2, the c3 sentinel) and on the chain
    (c2 and c3 in use)."""
    from utree_tpu_torch.parallel import routed as R

    sh, _ = routed_canon[(kind, geometry)]
    wide, per = sh.wide, sh.b1 // 4
    genome = routed_canon["wgenome" if wide else "genome"]
    packed, vbits, lens = _packed_reads(genome, 2000, 53, dev, padded=3)
    b, w = packed.shape[0], packed.shape[1] * 4 - 31
    send, rec, _ = R.route_displaced(packed, vbits, lens, nseed=sh.b1, num_shards=4,
                                     capacity=b * w // 8)
    glanes = R.route_displaced(packed, vbits, lens, nseed=sh.b1, num_shards=1,
                               capacity=b * w)[0].reshape(-1, 3)
    t1 = [torch.from_numpy(sh.t1[s]) for s in range(4)]
    name = "canonical_owner_probe" + ("_wide" if wide else "")
    for s in range(4):
        for lanes, base in ((send[s], 0), (glanes, s * per)):
            n0 = kernels.launches[name]
            got = R.canonical_owner_probe(t1[s].to(dev), lanes.contiguous(), base=base,
                                          per_shard=per, wide=wide)
            assert kernels.launches[name] == n0 + 1
            want = R.canonical_owner_probe_plain(t1[s], lanes.cpu(), base=base,
                                                 per_shard=per, wide=wide)
            assert torch.equal(got.cpu(), want)
    reply = torch.stack([R.canonical_owner_probe(t1[o].to(dev), send[o].contiguous(),
                                                 base=0, per_shard=per, wide=wide)
                         for o in range(4)])
    t2, t3 = torch.from_numpy(sh.t2), torch.from_numpy(sh.t3)
    name = "routed_canonical_finish" + ("_wide" if wide else "")
    bad = 0x7FFFFFFF if wide else BAD
    for do_rc in (True, False):
        kw = dict(b=b, w=w, do_rc=do_rc, bad_ix=bad, wide=wide)
        n0 = kernels.launches[name]
        got = R.routed_canonical_finish(rec, reply.contiguous(), t2.to(dev), t3.to(dev), **kw)
        assert kernels.launches[name] == n0 + 1
        want = R.routed_canonical_finish_plain(rec.cpu(), reply.cpu(), t2, t3, **kw)
        assert torch.equal(got.cpu(), want) and int((want < bad).sum()) > 100


def _owner_entry(routed, routed_canon, dev, kind, wide):
    """(entry point name, genome, bucket count, per, run(lanes, base, s, t1),
    plain(lanes, base, s), shard s's t1 on the card) of K12 or K17 on the
    4-shard tables (tier A's ladder for K17)."""
    from utree_tpu_torch.parallel import routed as R

    name = kind + ("_wide" if wide else "")
    if kind == "owner_probe":
        sh, tabs, ctabs, _ = routed["wide" if wide else "narrow"]
        per = sh.nseed // 4

        def run(lanes, base, s, t1):
            return R.owner_probe(t1, tabs[s]["ds"], lanes, base=base, per_seed=per, wide=wide)

        def plain(lanes, base, s):
            return R.owner_probe_plain(ctabs[s]["t1"], ctabs[s]["ds"], lanes.cpu(), base=base,
                                       per_seed=per, wide=wide)

        return (name, routed["genome"], sh.nseed, per, run, plain,
                [tabs[s]["t1"] for s in range(4)])
    sh, _ = routed_canon[("wide" if wide else "narrow", "default")]
    per = sh.b1 // 4
    t1 = [torch.from_numpy(sh.t1[s]) for s in range(4)]

    def run(lanes, base, s, t):
        return R.canonical_owner_probe(t, lanes, base=base, per_shard=per, wide=wide)

    def plain(lanes, base, s):
        return R.canonical_owner_probe_plain(t1[s], lanes.cpu(), base=base, per_shard=per,
                                             wide=wide)

    return (name, routed_canon["wgenome" if wide else "genome"], sh.b1, per, run, plain,
            [t.to(dev) for t in t1])


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("kind", ["owner_probe", "canonical_owner_probe"])
def test_k12_k17_lane_counts_match_plain(routed, routed_canon, dev, kind, wide):
    """K12 and K17 on an owner's receive buffer whose unwritten tail is long
    (room for every lane at each of 4 owners, so about three quarters of
    it is K11's zeroed tail), cut at lane counts off the 32-lane warp and
    the 256-lane block and at 0; on lanes that start off a 16 B boundary
    (read word by word); and on the fallback's lanes of a shard past 0:
    equal to the plain version, one launch a call."""
    from utree_tpu_torch.parallel import routed as R

    name, genome, nbkt, per, run, plain, t1 = _owner_entry(routed, routed_canon, dev, kind, wide)
    packed, vbits, lens = _packed_reads(genome, 600, 59, dev, padded=5)
    cap = packed.shape[0] * (packed.shape[1] * 4 - 31)
    send, _, counts = R.route_displaced(packed, vbits, lens, nseed=nbkt, num_shards=4,
                                        capacity=cap)
    assert int(counts[0]) < cap // 2  # the unwritten tail is the longer part
    lanes = send[0]
    glanes = R.route_displaced(packed, vbits, lens, nseed=nbkt, num_shards=1,
                               capacity=cap)[0].reshape(-1, 3)
    cases = [(lanes[:n], 0, 0) for n in (0, 1, 31, 33, 255, 257, 1000, cap)]
    cases += [(lanes[1:1001], 0, 0), (glanes[3:2003], per, 1), (glanes, 2 * per, 2)]
    for ln, base, s in cases:
        assert ln.is_contiguous()
        n0 = kernels.launches[name]
        got = run(ln, base, s, t1[s])
        assert kernels.launches[name] == n0 + 1
        want = plain(ln, base, s)
        assert got.shape == want.shape and torch.equal(got.cpu(), want), (ln.shape[0], base)
    assert int((plain(lanes, 0, 0) != 0).sum()) > 100


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_k12_k17_refuse_misaligned_rows(routed, routed_canon, dev, wide):
    """K12's d1 rows and K17's two-slot c1 rows load as 8 B (narrow) or
    16 B (wide) vectors: a t1 slice shifted off that boundary raises
    before any launch."""
    lanes = torch.zeros((64, 3), dtype=torch.int32, device=dev)
    for kind in ("owner_probe", "canonical_owner_probe"):
        name, _, _, _, run, _, t1 = _owner_entry(routed, routed_canon, dev, kind, wide)
        t = t1[0]
        for shift in (1, 2) if wide else (1,):  # 4 B off; 8 B off a 16 B boundary
            buf = torch.empty(t.numel() + shift, dtype=torch.int32, device=dev)
            shifted = buf[shift:].view(t.shape)
            shifted.copy_(t)
            n0 = kernels.launches[name]
            with pytest.raises(ValueError, match=f"{16 if wide else 8} B aligned"):
                run(lanes, 0, 0, shifted)
            assert kernels.launches[name] == n0


@pytest.mark.parametrize("case", ["1x4", "2x4", "2x4-cap8", "2x4-chain", "1x4-wide"])
def test_routed_canonical_steps_on_one_card_equal_cpu(routed_canon, dev, case):
    """The routed canonical step and its fallback with every shard on the
    one card equal the same steps on CPU shards, every int32; on (2, 4)
    the repaired displaced steps of the same tier too."""
    from utree_tpu_torch.parallel import routed as R

    kind = "wide" if "wide" in case else "narrow"
    sh, nl = routed_canon[(kind, "chain" if "chain" in case else "default")]
    shape = (2, 4) if case.startswith("2x4") else (1, 4)
    gm, cm = routed_canon["meshes"][shape]
    capacity = 8 if "cap8" in case else None
    genome = routed_canon["wgenome" if kind == "wide" else "genome"]
    packed, vbits, lens = _packed_reads(genome, 1000, 59, dev)
    kw = dict(do_rc=True, num_labels=nl, cap=8, bad_ix=0x7FFFFFFF if kind == "wide" else BAD)

    def run(mesh, args):
        tabs = sh.to_devices(mesh)
        return [torch.cat([o.cpu() for o in R.routed_canonical_search_step(
                    mesh, sh, capacity=capacity, **kw)(tabs, *args)]),
                torch.cat([o.cpu() for o in R.routed_fallback_step(mesh, sh, **kw)(
                    tabs, *args)])]

    n0 = {k: kernels.launches[k] for k in kernels.KERNELS}
    gpu = run(gm, (packed, vbits, lens))
    sfx = "_wide" if kind == "wide" else ""
    for k in ("route_displaced", "canonical_owner_probe" + sfx,
              "routed_canonical_finish" + sfx, "histogram_packed"):
        assert kernels.launches[k] > n0[k]
    cpu = run(cm, _on_cpu(packed, vbits, lens))
    assert all(torch.equal(a, b) for a, b in zip(gpu, cpu))
    assert int(gpu[0][0, -1]) == (shape[0] * 4 if capacity else 0)
    if capacity is None:
        assert torch.equal(gpu[0][:, :-1], gpu[1])
    if case == "2x4":
        from utree_tpu_torch.parallel.routed import ShardedDisplacedIndex

        index, _, _ = make_tier(40_000, 64)
        dsh = ShardedDisplacedIndex.build(index, 4)
        for mesh, args in ((gm, (packed, vbits, lens)), (cm, _on_cpu(packed, vbits, lens))):
            tabs = dsh.to_devices(mesh)
            dout = torch.cat([o.cpu() for o in R.routed_displaced_search_step(
                mesh, dsh, **kw)(tabs, *args)])
            dfb = torch.cat([o.cpu() for o in R.routed_displaced_fallback_step(
                mesh, dsh, **kw)(tabs, *args)])
            assert torch.equal(dout, gpu[0]) and torch.equal(dfb, gpu[1])
