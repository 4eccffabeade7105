"""The port's search step (utree_tpu_torch.lookup) against utree_tpu.lookup.

Inputs are made with numpy from a seed and fed to both packages; every
output is an integer, so the tolerance is exact equality.  The plain
versions run on the CPU; the CUDA kernels are held to them on a GPU in
tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import make_tier_index
from utree_tpu import lookup as jl
from utree_tpu.config import UTreeConfig
from utree_tpu.hash_index import _rc64, build_displaced_index
from utree_tpu.index import DeviceIndexArrays
from utree_tpu_torch import lookup as tl
from utree_tpu_torch.hash_index import displaced_to_device

BAD = 65535


def _lanes(words):
    qpre = (words >> np.uint64(40)).astype(np.int32)
    qhi = ((words >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int32)
    qlo = (words & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return qpre, qhi, qlo


def _t(a):
    """numpy lane -> the port's int64 u32 lane."""
    return torch.from_numpy(np.asarray(a).astype(np.int64) & 0xFFFFFFFF)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def tier():
    """A small synthetic tier (bench's generator) and its displaced table."""
    index, sw, ixs, labels, genome, cfg, rng = make_tier_index(40_000, 64)
    disp = build_displaced_index(index)
    return dict(index=index, words=sw, genome=genome, disp=disp,
                jt=disp.device_put(), tt=displaced_to_device(disp, "cpu"))


def _reads(genome, n, seed, read_len=150, width=192, n_prob=0.01):
    """Reads sampled from the genome (1% mutation, 10% random), with N's
    and ragged lengths; ASCII (n, width) zero-padded."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    starts = rng.integers(0, len(genome) - read_len, n)
    reads = genome[starts[:, None] + np.arange(read_len)].copy()
    mut = rng.random(reads.shape) < 0.01
    reads[mut] = rng.choice(acgt, int(mut.sum()))
    rand = rng.random(n) < 0.1
    reads[rand] = rng.choice(acgt, (int(rand.sum()), read_len))
    reads[rng.random(reads.shape) < n_prob] = ord("N")
    lens = rng.integers(20, read_len + 1, n).astype(np.int32)
    lens[: n // 2] = read_len
    out = np.zeros((n, width), np.uint8)
    out[:, :read_len] = reads
    out[np.arange(width)[None, :] >= lens[:, None]] = 0
    return out, lens


def test_windows_and_canonical_keys_match_jax():
    rng = np.random.default_rng(1)
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), 5000)
    reads, lens = _reads(genome, 64, seed=2)
    # palindromes: a 16-mer followed by its reverse complement is its own RC
    comp = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    for r in range(4):
        half = reads[r, 10:26]
        reads[r, 26:42] = comp[half[::-1]]
        lens[r] = 150
    packed, vbits, lens = tl.pack_reads_host(reads, lens)
    jp, jv, _ = jl.pack_reads_host(reads, lens)
    assert np.array_equal(packed, jp) and np.array_equal(vbits, jv)

    codes_j = jl.base_codes_packed(packed, vbits, lens)
    codes_t = tl.base_codes_packed(torch.from_numpy(packed), torch.from_numpy(vbits),
                                   torch.from_numpy(lens))
    assert np.array_equal(np.asarray(codes_j), _np(codes_t))
    wj = jl.extract_windows(codes_j)
    wt = tl.extract_windows(codes_t)
    for a, b in zip(wj, wt):
        assert np.array_equal(np.asarray(a).astype(np.int64), _np(b).astype(np.int64))
    assert not _np(wt[3]).all() and _np(wt[3]).any()  # invalid windows present

    rj = jl.rc_word_lanes(*wj[:3])
    rt = tl.rc_word_lanes(*wt[:3])
    for a, b in zip(rj, rt):
        assert np.array_equal(np.asarray(a).astype(np.uint32).astype(np.int64), _np(b))
    klo_j, khi_j, le_j = jl.canonical_keys(*wj[:3])
    klo_t, khi_t, le_t = tl.canonical_keys(*wt[:3])
    assert np.array_equal(np.asarray(klo_j).view(np.uint32), _np(klo_t))
    assert np.array_equal(np.asarray(khi_j).view(np.uint32), _np(khi_t))
    assert np.array_equal(np.asarray(le_j), _np(le_t))
    # the palindromic window (start 10) equals its own RC: key = word, fwd_le
    fwd_hi = (_np(wt[0]) << 8) | _np(wt[1])
    for r in range(4):
        assert _np(le_t)[r, 10] and _np(khi_t)[r, 10] == fwd_hi[r, 10]
        assert _np(klo_t)[r, 10] == _np(wt[2])[r, 10]


def test_mix_and_probe_pieces_match_jax(tier):
    rng = np.random.default_rng(3)
    n = 5000
    key_lo = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    key_hi = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    valid = rng.random(n) < 0.8
    jlo, jhi = jnp.asarray(key_lo.view(np.int32)), jnp.asarray(key_hi.view(np.int32))
    tlo, thi, tv = _t(key_lo), _t(key_hi), torch.from_numpy(valid)
    pre, hi8 = key_hi >> 8, key_hi & 0xFF
    assert np.array_equal(
        np.asarray(jl._mix_jnp(pre.astype(np.int32), hi8.astype(np.int32), key_lo)),
        _np(tl.mix(_t(pre), _t(hi8), tlo)))
    d = tier["disp"]
    nseed, nslots = 4 * len(d.seeds), 2 * d.t1.shape[0]
    bj = jl.displaced_bucket_jnp(jlo, jhi, valid, nseed)
    bt = tl.displaced_bucket(tlo, thi, tv, nseed)
    assert np.array_equal(np.asarray(bj), _np(bt))
    sj = jl.displaced_seed_jnp(jnp.asarray(d.seeds), bj)
    st = tl.displaced_seed(tier["tt"]["ds"], bt)
    assert np.array_equal(np.asarray(sj), _np(st))
    assert np.array_equal(np.asarray(jl.displaced_slot_jnp(jlo, jhi, sj, valid, nslots)),
                          _np(tl.displaced_slot(tlo, thi, st, tv, nslots)))
    assert np.array_equal(np.asarray(jl.canonical_bucket3(jlo, jhi, valid, 1024)),
                          _np(tl.canonical_bucket3(tlo, thi, tv, 1024)))


def _lookup_both(jt, tt, queries, valid, do_rc):
    qpre, qhi, qlo = _lanes(queries)
    j = jl.lookup_kmers_displaced(jt, qpre, qhi, qlo, valid, bad_ix=BAD, do_rc=do_rc)
    t = tl.lookup_kmers_displaced(tt, _t(qpre), _t(qhi), _t(qlo),
                                  torch.from_numpy(valid), bad_ix=BAD, do_rc=do_rc)
    if do_rc:
        return np.stack([np.asarray(x) for x in j]), np.stack([_np(x) for x in t])
    return np.asarray(j), _np(t)


@pytest.mark.parametrize("do_rc", [True, False])
def test_displaced_lookup_random_keys(tier, do_rc):
    rng = np.random.default_rng(4)
    w = tier["words"]
    q = np.concatenate([rng.choice(w, 3000), _rc64(rng.choice(w, 3000)),
                        rng.integers(0, 1 << 64, 3000, dtype=np.uint64)])
    valid = rng.random(len(q)) < 0.9  # invalid windows must come back bad_ix
    j, t = _lookup_both(tier["jt"], tier["tt"], q, valid, do_rc)
    assert np.array_equal(j, t)
    assert (t != BAD).sum() > 2000
    assert (t[..., ~valid] == BAD).all()


def test_displaced_lookup_forced_d3_spill():
    """A placement at load 0.98 spills into the d3 tail, which the probe must
    reach on a d1 miss."""
    rng = np.random.default_rng(17)
    words = np.sort(rng.choice(1 << 40, size=40_000, replace=False).astype(np.uint64))
    ixs = rng.integers(0, 50, len(words)).astype(np.int64)
    index = DeviceIndexArrays.from_build(words, ixs, [b"l%d" % i for i in range(50)],
                                         UTreeConfig())
    built = build_displaced_index(index, load=0.98, spill_budget=len(words))
    assert built.t3.shape[0] > 8
    q = np.concatenate([words, rng.integers(0, 1 << 40, 500, dtype=np.uint64)])
    for do_rc in (True, False):
        j, t = _lookup_both(built.device_put(), displaced_to_device(built, "cpu"),
                            q, np.ones(len(q), bool), do_rc)
        assert np.array_equal(j, t)
    # every stored word is found, including those only in the tail
    assert (t[: len(words)] != BAD).all()


@pytest.mark.parametrize("do_rc", [True, False])
def test_window_ids_with_true_len_trim(tier, do_rc):
    """_packed_window_ix's displaced branch on packed reads whose transfer
    width (256) exceeds the batch's true length (152)."""
    reads, lens = _reads(tier["genome"], 96, seed=5, width=256)
    packed, vbits, lens = tl.pack_reads_host(reads, lens)
    kw = dict(do_rc=do_rc, bad_ix=BAD, true_len=152, num_labels=64)
    j = jl._packed_window_ix(tier["jt"], packed, vbits, lens, k=32, probe_iters=1,
                             **kw)
    t = tl.window_ids(tier["tt"], torch.from_numpy(packed), torch.from_numpy(vbits),
                      torch.from_numpy(lens), **kw)
    assert t.dtype == torch.int32 and t.shape == ((96, 242) if do_rc else (96, 121))
    assert np.array_equal(np.asarray(j), _np(t))
    assert (_np(t) < 64).sum() > 1000


@pytest.mark.parametrize("cap", [1, 8])
def test_compact_histogram_overflow(cap):
    rng = np.random.default_rng(6 + cap)
    n_lab = 12
    ix = rng.integers(0, n_lab, (400, 242)).astype(np.int32)
    # rows with few unique labels, rows of misses only, rows over cap
    ix[:100] = np.where(rng.random((100, 242)) < 0.5, rng.integers(0, 3, (100, 1)), BAD)
    ix[100:150] = BAD
    j = jl.compact_histogram(jnp.asarray(ix), n_lab, cap)
    t = tl.histogram(torch.from_numpy(ix), n_lab, cap)
    for a, b in zip(j, t):
        assert b.dtype == torch.int32
        assert np.array_equal(np.asarray(a), _np(b))
    nuniq = _np(t[2])
    assert (nuniq == cap + 1).any() and (nuniq == 0).any() and (nuniq <= cap).any()


def test_search_step_vote_compact_matches_jax(tier):
    """The whole device step: packed reads -> 12 B vote rows."""
    from utree_tpu.classify_device import build_aufbau_tables
    from utree_tpu_torch.classify_device import aufbau_tables_to_device

    index = tier["index"]
    tab = build_aufbau_tables(index.strings)
    max_iters = (tab.max_len + 4) * 10 + 16
    reads, lens = _reads(tier["genome"], 128, seed=8)
    packed, vbits, lens = tl.pack_reads_host(reads, lens)
    kw = dict(do_rc=True, bad_ix=BAD, num_labels=index.num_labels, cap=8,
              taxacut=index.config.taxacut, max_iters=max_iters, true_len=152)
    jt = {**tier["jt"], **{"vt_" + k: v for k, v in tab.device_put().items()}}
    j = jl.search_step_vote_compact(jt, packed, vbits, lens, k=32, probe_iters=1, **kw)
    tt = {**tier["tt"],
          **{"vt_" + k: v for k, v in aufbau_tables_to_device(tab, "cpu").items()}}
    t = tl.search_step_vote_compact(tt, torch.from_numpy(packed),
                                    torch.from_numpy(vbits), torch.from_numpy(lens), **kw)
    assert np.array_equal(np.asarray(j), _np(t))



# ---- the canonical ladder and wide entries ------------------------------------

def _ladder_case(nlab, wide, seed, n_words=40_000, geometry=None):
    """A random word set with `nlab` labels, its ladder (the default geometry
    ladder, or one pinned (slots, load, slots2, slots3) tier), and queries:
    stored words, their RCs and random words, some windows invalid."""
    from utree_tpu.hash_index import (_canonical_groups, _place_canonical,
                                      build_canonical_hash_index)

    rng = np.random.default_rng(seed)
    words = np.unique(rng.integers(0, 1 << 64, size=n_words, dtype=np.uint64))
    ixs = rng.integers(0, nlab, size=len(words)).astype(np.int64)
    cfg = UTreeConfig(ixtype_bytes=4 if wide else 2)
    index = DeviceIndexArrays.from_build(words, ixs, [b"l%d" % i for i in range(nlab)], cfg)
    if geometry is None:
        built = build_canonical_hash_index(index)
    else:
        slots, load, slots2, slots3 = geometry
        if slots3:
            built = _place_canonical(*_canonical_groups(index), slots, load, slots2,
                                     1 << 27, slots3=slots3)
        else:
            built = build_canonical_hash_index(index, slots=slots, load=load,
                                               slots2=slots2)
    q = np.concatenate([rng.choice(words, 3000), _rc64(rng.choice(words, 1000)),
                        rng.integers(0, 1 << 64, 1000, dtype=np.uint64)])
    valid = rng.random(len(q)) < 0.95
    return built, q, valid, min(cfg.bad_ix, 0x7FFFFFFF)


def _canonical_both(built, q, valid, bad, do_rc, wide):
    from utree_tpu_torch.hash_index import canonical_to_device

    qpre, qhi, qlo = _lanes(q)
    kw = dict(slots=built.slots, slots2=built.slots2, bad_ix=bad, do_rc=do_rc,
              wide=wide)
    j = jl.lookup_kmers_canonical(built.device_put(), qpre, qhi, qlo, valid, **kw)
    t = tl.lookup_kmers_canonical(canonical_to_device(built, "cpu"), _t(qpre), _t(qhi),
                                  _t(qlo), torch.from_numpy(valid), **kw)
    if do_rc:
        return np.stack([np.asarray(x) for x in j]), np.stack([_np(x) for x in t])
    return np.asarray(j), _np(t)


@pytest.mark.parametrize("do_rc", [True, False], ids=["rc", "forward"])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_canonical_lookup_matches_jax(wide, do_rc):
    built, q, valid, bad = _ladder_case(70_000 if wide else 64, wide, seed=31)
    assert built.t1.shape[1] == built.slots * (4 if wide else 3)
    j, t = _canonical_both(built, q, valid, bad, do_rc, wide)
    assert t.dtype == np.int32 and np.array_equal(j, t)
    assert (t != bad).sum() > 2000
    assert (t[..., ~valid] == bad).all()


@pytest.mark.parametrize("geometry", [
    (4, 0.28, 16, 0),  # 2-sector rows, cached t2
    (4, 4.0, 8, 0),    # ladder tier C shape: overloaded t1 -> big t2
    (4, 4.0, 2, 16),   # ladder tier B shape: the three-level chain
    (2, 8.0, 2, 16),   # extreme overload: c3 takes a large tail
], ids=["cached-c2", "tier-C", "tier-B-chain", "big-c3"])
def test_canonical_ladder_geometries_match_jax(geometry):
    """The placed geometries of tests/test_hash_index.py: slot counts come
    from the table shapes, and a later level answers where an earlier one
    holds no entry."""
    built, q, valid, bad = _ladder_case(64, False, seed=11, geometry=geometry)
    assert built.t2.shape[0] > 8
    if geometry[3]:
        assert built.t3.shape[0] > 8  # the c3 tail is exercised
    for do_rc in (True, False):
        j, t = _canonical_both(built, q, valid, bad, do_rc, False)
        assert np.array_equal(j, t)


def test_canonical_no_spill_sentinel_matches_jax():
    """A tiny build spills nothing: c2 and c3 are the 8-row sentinels and
    are not probed (their zero rows would match no key anyway)."""
    built, q, valid, bad = _ladder_case(5, False, seed=7, n_words=12)
    assert built.t2.shape[0] == 8 and built.t3.shape[0] == 8
    for do_rc in (True, False):
        j, t = _canonical_both(built, q, valid, bad, do_rc, False)
        assert np.array_equal(j, t)


@pytest.mark.parametrize("do_rc", [True, False], ids=["rc", "forward"])
def test_displaced_wide_lookup_matches_jax(do_rc):
    """IXTYPE=u32 displaced rows (4-column slots), as tests/test_displaced.py
    places them, with a forced d3 tail."""
    rng = np.random.default_rng(13)
    words = np.unique(rng.integers(0, 1 << 64, size=40_000, dtype=np.uint64))
    nlab = 70_000
    ixs = rng.integers(0, nlab, size=len(words)).astype(np.int64)
    cfg = UTreeConfig(ixtype_bytes=4)
    index = DeviceIndexArrays.from_build(words, ixs, [b"l%d" % i for i in range(nlab)], cfg)
    bad = min(cfg.bad_ix, 0x7FFFFFFF)
    q = np.concatenate([rng.choice(words, 1500),
                        rng.integers(0, 1 << 64, size=1500, dtype=np.uint64)])
    valid = rng.random(len(q)) < 0.9
    qpre, qhi, qlo = _lanes(q)
    for built in (build_displaced_index(index),
                  build_displaced_index(index, load=0.98, spill_budget=len(words))):
        assert built.wide and built.t1.shape[1] == 8
        kw = dict(bad_ix=bad, do_rc=do_rc, wide=True)
        j = jl.lookup_kmers_displaced(built.device_put(), qpre, qhi, qlo, valid, **kw)
        t = tl.lookup_kmers_displaced(displaced_to_device(built, "cpu"), _t(qpre),
                                      _t(qhi), _t(qlo), torch.from_numpy(valid), **kw)
        j = np.stack([np.asarray(x) for x in j]) if do_rc else np.asarray(j)
        t = np.stack([_np(x) for x in t]) if do_rc else _np(t)
        assert np.array_equal(j, t)
        assert (t < nlab).sum() > 1000
    assert built.t3.shape[0] > 8  # the second placement spilled into d3


@pytest.mark.parametrize("cap", [1, 8])
def test_pack_hist_and_unpacked_layout_overflow(cap):
    """(B, cap+1) pack_hist rows and the (B, 2*cap+2) unpacked rows,
    with rows of few labels, misses only, and over cap.  Hit counts pass
    2^15, so the packed count lane reaches the sign bit."""
    rng = np.random.default_rng(40 + cap)
    n_lab = 12
    ix = rng.integers(0, n_lab, (300, 242)).astype(np.int32)
    ix[:100] = np.where(rng.random((100, 242)) < 0.5, rng.integers(0, 3, (100, 1)), BAD)
    ix[100:150] = BAD
    big = np.full((4, 40_000), 5, np.int32)  # one label, 40,000 hits
    big[1, ::7] = 9
    for rows in (ix, big):
        j = np.asarray(jl.pack_hist(jnp.asarray(rows), n_lab, cap))
        t = tl.histogram_packed(torch.from_numpy(rows), n_lab, cap)
        assert t.dtype == torch.int32 and np.array_equal(j, _np(t))
        labels, counts, nuniq, found = jl.compact_histogram(jnp.asarray(rows), n_lab, cap)
        want = np.concatenate([np.asarray(labels), np.asarray(counts),
                               np.asarray(nuniq)[:, None], np.asarray(found)[:, None]], 1)
        assert np.array_equal(want, _np(tl.histogram_unpacked(torch.from_numpy(rows),
                                                              n_lab, cap)))
    nuniq = _np(tl.histogram(torch.from_numpy(ix), n_lab, cap)[2])
    assert (nuniq == cap + 1).any() and (nuniq == 0).any()


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_hist_steps_on_the_ladder_match_jax(wide):
    """search_step_hist_packed (narrow) / search_step_hist_packed_in (wide)
    over a ladder built from a genome, on packed reads with the true_len
    trim: the whole histogram step, bitwise."""
    from utree_tpu.hash_index import build_canonical_hash_index
    from utree_tpu_torch.hash_index import canonical_to_device

    index, sw, ixs, labels, genome, cfg, rng = make_tier_index(30_000, 48)
    if wide:
        strings = list(index.strings) + [b"pad%d" % i for i in range(70_000)]
        index = DeviceIndexArrays.from_build(sw, ixs, strings, UTreeConfig(ixtype_bytes=4))
    built = build_canonical_hash_index(index)
    reads, lens = _reads(genome, 96, seed=9, width=256)
    packed, vbits, lens = tl.pack_reads_host(reads, lens)
    kw = dict(do_rc=True, bad_ix=min(index.config.bad_ix, 0x7FFFFFFF),
              num_labels=index.num_labels, cap=4, true_len=152)
    jstep = jl.search_step_hist_packed_in if wide else jl.search_step_hist_packed
    tstep = tl.search_step_hist_packed_in if wide else tl.search_step_hist_packed
    j = jstep(built.device_put(), packed, vbits, lens, k=32, probe_iters=1, **kw)
    t = tstep(canonical_to_device(built, "cpu"), torch.from_numpy(packed),
              torch.from_numpy(vbits), torch.from_numpy(lens), **kw)
    assert t.shape == (96, 10 if wide else 5)
    assert np.array_equal(np.asarray(j), _np(t))


# ---- the bsearch replay ---------------------------------------------------------

def _abnormal_index():
    """Random 32-mers plus one word alone in prefix bin 0 whose suffix is the
    largest: the reference folds it into the next populated bin, which is
    then not sorted by suffix (compute_bin_ix's zero-sentinel quirk)."""
    rng = np.random.default_rng(21)
    words = np.unique(rng.integers(1 << 40, 1 << 46, 4000, dtype=np.uint64))
    odd = np.uint64(0xFFFFFFFFFF)
    words = np.concatenate([[odd], words])
    index = DeviceIndexArrays.from_build(words, rng.integers(0, 30, len(words)),
                                         [b"l%d" % i for i in range(30)], UTreeConfig())
    first = int(words[1] >> np.uint64(40))
    assert index.bin_ix[1] == 0 and index.bin_ix[first] == 0  # the merged bin
    return index, words, rng


def test_lookup_kmers_abnormal_bin_matches_jax():
    """The replay on the merged, unsorted bin: stored words, the merged
    bin's words with changed suffixes, the odd word (stored, yet its own bin
    is empty, so it misses), random words and invalid windows; the fixed
    `probe_iters` trip count ends where an unbounded loop does."""
    from utree_tpu.hash_index import _rc64
    from utree_tpu.search_host import lookup_words
    from utree_tpu_torch.hash_index import bsearch_to_device

    index, words, rng = _abnormal_index()
    q = np.concatenate([words, words[1:40] ^ rng.integers(0, 1 << 12, 39, dtype=np.uint64),
                        _rc64(rng.choice(words, 500)),
                        rng.integers(0, 1 << 64, 500, dtype=np.uint64)])
    valid = rng.random(len(q)) < 0.95
    valid[0] = True
    qpre, qhi, qlo = _lanes(q)
    j = np.asarray(jl.lookup_kmers(index.device_put(), qpre, qhi, qlo, valid,
                                   index.probe_iters, BAD))
    tt = bsearch_to_device(index, "cpu")
    args = (_t(qpre), _t(qhi), _t(qlo), torch.from_numpy(valid))
    t = _np(tl.lookup_kmers(tt, *args, index.probe_iters, BAD))
    assert t.dtype == np.int32 and np.array_equal(j, t)
    assert np.array_equal(t, _np(tl.lookup_kmers(tt, *args, 40, BAD)))
    host = lookup_words(index.host_index(), q)
    assert np.array_equal(np.where(valid, host, BAD), t)
    assert t[0] == BAD and (t[1:len(words)][valid[1:len(words)]] != BAD).all()


@pytest.mark.parametrize("do_rc", [True, False])
def test_bsearch_window_ids_match_jax(tier, do_rc):
    """_packed_window_ix's replay branch on packed reads with the true_len
    trim: with RC the arithmetic RC words follow the forward words."""
    from utree_tpu_torch.hash_index import bsearch_to_device

    index = tier["index"]
    reads, lens = _reads(tier["genome"], 96, seed=12, width=256)
    packed, vbits, lens = tl.pack_reads_host(reads, lens)
    kw = dict(do_rc=do_rc, bad_ix=BAD, true_len=152, num_labels=64,
              probe_iters=index.probe_iters)
    j = jl._packed_window_ix(index.device_put(), packed, vbits, lens, k=32, **kw)
    pt = [torch.from_numpy(a) for a in (packed, vbits, lens)]
    t = tl.window_ids(bsearch_to_device(index, "cpu"), *pt, **kw)
    assert t.shape == ((96, 242) if do_rc else (96, 121))
    assert np.array_equal(np.asarray(j), _np(t)) and (_np(t) < 64).sum() > 1000
    if do_rc:  # [fwd | rc]: the first half is the forward-only run
        fwd = tl.window_ids(bsearch_to_device(index, "cpu"), *pt,
                            **{**kw, "do_rc": False})
        assert torch.equal(t[:, :121], fwd)


@pytest.mark.parametrize("step", ["vote", "packed", "unpacked"])
def test_bsearch_steps_match_jax(tier, step):
    """The three packed steps over the CTR records, as the JAX pipeline
    composes them for bsearch: device vote, packed and unpacked rows."""
    from utree_tpu.classify_device import build_aufbau_tables
    from utree_tpu_torch.classify_device import aufbau_tables_to_device
    from utree_tpu_torch.hash_index import bsearch_to_device

    index = tier["index"]
    reads, lens = _reads(tier["genome"], 128, seed=13)
    packed, vbits, lens = tl.pack_reads_host(reads, lens)
    kw = dict(do_rc=True, bad_ix=BAD, num_labels=64, cap=4, true_len=152,
              probe_iters=index.probe_iters)
    jt, tt = index.device_put(), bsearch_to_device(index, "cpu")
    if step == "vote":
        tab = build_aufbau_tables(index.strings)
        kw.update(taxacut=index.config.taxacut, max_iters=(tab.max_len + 4) * 6 + 16)
        jt = {**jt, **{"vt_" + k: v for k, v in tab.device_put().items()}}
        tt = {**tt, **{"vt_" + k: v for k, v in aufbau_tables_to_device(tab, "cpu").items()}}
    name = {"vote": "search_step_vote_compact", "packed": "search_step_hist_packed",
            "unpacked": "search_step_hist_packed_in"}[step]
    j = getattr(jl, name)(jt, packed, vbits, lens, k=32, **kw)
    t = getattr(tl, name)(tt, *(torch.from_numpy(a) for a in (packed, vbits, lens)), **kw)
    assert np.array_equal(np.asarray(j).reshape(_np(t).shape), _np(t))
