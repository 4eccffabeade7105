"""The CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here is marked `cuda` and skips without a CUDA device: a CUDA
kernel has no CPU mode.  The plain versions are held to the JAX package by
tests/test_torch_{lookup,aufbau,pipeline}.py on the CPU.  This file imports
no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from bench import make_tier_index
from chip_smoke import index64, tier64, u32_index
from test_classify_device import _random_strings
from utree_tpu.classify_device import build_aufbau_tables
from utree_tpu.hash_index import build_displaced_index
from utree_tpu_torch import kernels
from utree_tpu_torch import lookup as tl
from utree_tpu_torch.classify_device import (aufbau_tables_to_device,
                                             aufbau_walk, pack_vote, vote_rows)
from utree_tpu_torch.hash_index import (bsearch_to_device, canonical64_to_device,
                                        displaced64_to_device, displaced_to_device)

pytestmark = pytest.mark.cuda
BAD = 65535


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tier(dev):
    index, sw, ixs, labels, genome, cfg, rng = make_tier_index(40_000, 64)
    disp = build_displaced_index(index, load=0.98, spill_budget=len(sw))
    assert disp.t3.shape[0] > 8  # the d3 tail is exercised too
    return dict(index=index, genome=genome, table=displaced_to_device(disp, dev))


def _packed_reads(genome, n, seed, dev, read_len=150, width=192):
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


def _ladder(index, geometry):
    from utree_tpu.hash_index import (_canonical_groups, _place_canonical,
                                      build_canonical_hash_index)

    if geometry == "chain":  # tier B's three-level shape, c3 in use
        built = _place_canonical(*_canonical_groups(index), 4, 4.0, 2, 1 << 27,
                                 slots3=16)
        assert built.t2.shape[0] > 8 and built.t3.shape[0] > 8
        return built
    return build_canonical_hash_index(index)


def _wide_index(index, sw, ixs):
    strings = list(index.strings) + [b"pad%d" % i for i in range(70_000)]
    return u32_index(sw, ixs, strings)


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

    index, sw, ixs, labels, genome, cfg, rng = make_tier_index(40_000, 64)
    wide = _wide_index(index, sw, ixs)
    if kind == "ladder":
        table, probe = canonical_to_device(_ladder(wide, "default"), dev), "ladder_probe_wide"
    else:
        disp = build_displaced_index(wide, load=0.98, spill_budget=len(sw))
        assert disp.wide and disp.t3.shape[0] > 8
        table, probe = displaced_to_device(disp, dev), "scan_probe_wide"
    packed, vbits, lens = _packed_reads(genome, 3000, 4, dev)
    _probe_and_hists(table, packed, vbits, lens, wide.num_labels, probe)


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
    from utree_tpu.config import UTreeConfig
    from utree_tpu.index import DeviceIndexArrays

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
    from utree_tpu.hash_index64 import (_canonical_groups64, _place64,
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
    from utree_tpu.encode import sample_build_kmers
    from utree_tpu.hash_index64 import build_canonical_hash_index64, build_displaced_index64

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


# entry points each path must launch (the histogram step of long reads adds
# histogram_packed or histogram_unpacked)
_PATHS = {
    ("narrow", "auto"): {"ladder_probe", "histogram", "aufbau_vote", "histogram_packed"},
    ("narrow", "displaced"): {"scan_probe", "histogram", "aufbau_vote", "histogram_packed"},
    ("narrow", "bsearch"): {"bsearch_probe", "histogram", "aufbau_vote", "histogram_packed"},
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
    from utree_tpu.build import build_database
    from utree_tpu.config import UTreeConfig
    from utree_tpu.index import DeviceIndexArrays
    from utree_tpu.testdata import make_toy_db, make_toy_reads
    from utree_tpu_torch.pipeline import SearchPipeline

    recs = make_toy_db(str(tmp_path / "refs.fa"), str(tmp_path / "tax.map"), seed=23)
    make_toy_reads(str(tmp_path / "reads.fa"), recs, num_reads=900, seed=29)
    with open(tmp_path / "reads.fa", "ab") as f:
        for i in range(3):
            f.write(b">long%d\n" % i + recs[i][2][: 1500 + 700 * i] + b"\n")
    cfg = UTreeConfig(packsize=64, ixtype_bytes=4) if labels == "k64" else UTreeConfig()
    res = build_database(str(tmp_path / "refs.fa"), str(tmp_path / "tax.map"), cfg)
    strings = list(res.labels.strings)
    if labels == "wide":
        index = u32_index(res.words, res.ixs, strings + [b"pad%d" % i for i in range(70_000)])
    elif labels == "k64":
        index = index64(res.words, res.ixs, strings)
    else:
        index = DeviceIndexArrays.from_build(res.words, res.ixs, strings, UTreeConfig())
    outs = {}
    for device in ("cpu", "cuda"):
        kernels.reset_launches()
        pipe = SearchPipeline(index, device=device, do_rc=True, batch_size=128,
                              hist_cap=2, lookup_mode=mode)
        pipe.long_read_threshold, pipe.long_chunk = 1000, 256
        pipe.search_file(str(tmp_path / "reads.fa"), str(tmp_path / f"{device}.txt"))
        outs[device] = (tmp_path / f"{device}.txt").read_bytes()
        launched = {k for k, n in kernels.launches.items() if n}
        assert launched == (_PATHS[labels, mode] if device == "cuda" else set())
    # fewer reads classify at k=64: a 64-mer window holds twice the bases
    assert outs["cuda"] == outs["cpu"]
    assert outs["cpu"].count(b"\n") > (400 if labels == "k64" else 500)
