"""The port's search step (utree_tpu_torch.lookup) against utree_tpu.lookup.

Inputs are made with numpy from a seed and fed to both packages; every
output is an integer, so the tolerance is exact equality.  The plain
versions run on the CPU; the CUDA kernels are held to them on a GPU in
tests/test_torch_kernels.py.  Where a port function takes the index, it
gets its own copy of the JAX index (convert.index_from_jax)."""

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
from utree_tpu_torch.convert import index_from_jax
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
    return dict(index=index, port=index_from_jax(index), words=sw, genome=genome,
                disp=disp, jt=disp.device_put(), tt=displaced_to_device(disp, "cpu"))


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


@pytest.mark.parametrize("cap", [1, 8])
@pytest.mark.parametrize("over_cap", [64, 3], ids=["fits", "overflows"])
def test_search_step_hist_compact_matches_jax(tier, cap, over_cap):
    """The compact readback step: per-read (tail, lc0) pairs and the block
    of rows of 2+ labels in read order; with a 3-row block the header keeps
    the true count and the rows past the block are dropped.  The last 16
    rows are padding (length 0), never flagged."""
    reads, lens = _reads(tier["genome"], 128, seed=14)
    reads[-16:], lens[-16:] = 0, 0
    packed, vbits, lens = tl.pack_reads_host(reads, lens)
    kw = dict(do_rc=True, bad_ix=BAD, num_labels=64, cap=cap, true_len=152,
              over_cap=over_cap)
    j = np.asarray(jl.search_step_hist_compact(tier["jt"], packed, vbits, lens, k=32,
                                               probe_iters=1, **kw))
    t = _np(tl.search_step_hist_compact(tier["tt"], torch.from_numpy(packed),
                                        torch.from_numpy(vbits), torch.from_numpy(lens),
                                        **kw))
    assert t.dtype == np.int32 and np.array_equal(j, t)
    assert t.shape == (2 * 128 + (over_cap + 1) * (cap + 1),)
    n_over = int(t[2 * 128])
    assert n_over > 3 and (n_over <= over_cap) == (over_cap == 64)
    assert not t[2 * 112:2 * 128].any()  # padding: tail and lc0 are 0


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


def _histograms_match_jax(n, cap):
    """JAX's histogram rules on eight rows of n ids: a negative id counts in
    found but is never a label and never overflows; an id at or above
    num_labels is a miss; slots past the distinct count hold (-1, 0),
    packed as 0; exactly cap distinct labels do not overflow, cap + 1 do;
    one label in every id.  compact_histogram, pack_hist and unpacked_hist
    against utree_tpu.lookup's."""
    rng = np.random.default_rng(n + cap)
    n_lab = 4096
    rows = np.full((8, n), BAD, np.int32)
    for r, d in enumerate((cap, cap + 1)):  # exactly cap and cap + 1 labels
        labels = np.r_[rng.choice(n_lab - 1, d - 1, replace=False), n_lab - 1]
        rows[r] = labels[np.arange(n) % d]
    rows[2] = 77  # one label everywhere
    rows[3] = rng.integers(-4, n_lab + 4, n)  # negatives, misses, over cap
    rows[4, : n // 2] = -1  # negatives and misses only
    rows[4, n // 2:] = rng.choice([n_lab, n_lab + 1, BAD], n - n // 2)
    rows[5] = np.where(rng.random(n) < 0.5, rng.integers(0, 3, n), -7)  # few labels
    rows[6, ::5] = -2
    rows[6, 1::5] = n_lab - 1
    for r in (0, 1):  # a negative id in a full row changes no slot
        rows[r, ::11] = -5
    j = [np.asarray(x) for x in jl.compact_histogram(jnp.asarray(rows), n_lab, cap)]
    t = tl.compact_histogram(torch.from_numpy(rows), n_lab, cap)
    for a, b in zip(j, t):
        assert b.dtype == torch.int32 and np.array_equal(a, _np(b))
    assert np.array_equal(np.asarray(jl.pack_hist(jnp.asarray(rows), n_lab, cap)),
                          _np(tl.pack_hist(torch.from_numpy(rows), n_lab, cap)))
    want = np.concatenate([j[0], j[1], j[2][:, None], j[3][:, None]], 1)
    assert np.array_equal(want, _np(tl.unpacked_hist(torch.from_numpy(rows), n_lab, cap)))
    nuniq, found = j[2], j[3]
    assert nuniq[0] == cap and nuniq[1] == cap + 1 and nuniq[2] == 1 and nuniq[4] == 0
    assert found[4] == n // 2 and (j[0][4] == -1).all() and (j[1][4] == 0).all()
    assert nuniq[3] == cap + 1 and found[3] > 0


@pytest.mark.parametrize("cap", [1, 8])
@pytest.mark.parametrize("n", [2049, 32_706])
def test_histograms_at_long_widths_match_jax(n, cap):
    """The histogram rules at the widths K2's streamed branch takes (long
    reads)."""
    _histograms_match_jax(n, cap)


@pytest.mark.parametrize("cap", [1, 8, 15, 16, 30])
@pytest.mark.parametrize("n", [242, 256, 257, 258, 288, 289])
def test_histograms_at_register_widths_match_jax(n, cap):
    """The histogram rules at the widths around the edges of K2's register
    instances (8 registers a lane up to 256 ids, 9 up to 288, 10 above;
    242 and 258 ids are the wide-label and PACKSIZE=64 reads with RC) and
    the caps where the unpacked row's warp store turns into two (2cap + 2
    > 32 from cap 16)."""
    _histograms_match_jax(n, cap)


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
    tt = bsearch_to_device(index_from_jax(index), "cpu")
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
    t = tl.window_ids(bsearch_to_device(tier["port"], "cpu"), *pt, **kw)
    assert t.shape == ((96, 242) if do_rc else (96, 121))
    assert np.array_equal(np.asarray(j), _np(t)) and (_np(t) < 64).sum() > 1000
    if do_rc:  # [fwd | rc]: the first half is the forward-only run
        fwd = tl.window_ids(bsearch_to_device(tier["port"], "cpu"), *pt,
                            **{**kw, "do_rc": False})
        assert torch.equal(t[:, :121], fwd)


def test_bsearch_records_hold_the_three_arrays(tier):
    """K7's 16 B records {suf_hi, suf_lo, ix, 0}: one row a record and the
    sentinel, contiguous, equal to the three arrays JAX's lookup_kmers reads
    (the JAX index's own); the table's suf_hi, suf_lo and ix are rec's
    columns, not copies."""
    from utree_tpu_torch.hash_index import bsearch_records, bsearch_to_device

    index = tier["index"]
    t = bsearch_to_device(tier["port"], "cpu")
    rec, n = t["rec"], t["suf_hi"].shape[0] - 1
    assert rec.dtype == torch.int32 and tuple(rec.shape) == (n + 1, 4)
    assert rec.is_contiguous()
    assert np.array_equal(bsearch_records(tier["port"]), _np(rec))
    for col, k in enumerate(("suf_hi", "suf_lo", "ix")):
        assert t[k]._base is rec and t[k].data_ptr() == rec[:, col].data_ptr()
        assert t[k].shape == (n + 1,) and t[k].stride() == (4,)
    assert not rec[:, 3].any()
    jt = index.device_put()
    assert np.array_equal(_np(rec[:, 0]), np.asarray(jt["suf_hi"]))
    assert np.array_equal(_np(rec[:, 1]).view(np.uint32), np.asarray(jt["suf_lo"]))
    assert np.array_equal(_np(rec[:, 2]), np.asarray(jt["ix"]))
    assert np.array_equal(_np(t["bin_ix"]), np.asarray(jt["bin_ix"]))


@pytest.mark.parametrize("true_len", [None, 104])
def test_bsearch_bins_count_words_by_bin_size(tier, true_len):
    """chip_smoke.bsearch_bins, which sizes K7's bound: both strands' words
    by the size of their prefix bin (invalid, empty, one record, more),
    against JAX's windows of the same reads cut to true_len and the JAX
    index's bin offsets."""
    from chip_smoke import bsearch_bins

    index = tier["index"]
    reads, lens = _reads(tier["genome"], 96, seed=13, width=192)
    packed, vbits, lens = tl.pack_reads_host(reads, lens)
    t = 192 if true_len is None else true_len
    wj = jl.extract_windows(jl.base_codes_packed(packed[:, :t // 4], vbits[:, :t // 8], lens))
    valid = np.asarray(wj[3])
    bin_ix = np.asarray(index.bin_ix).astype(np.int64)
    want = {"invalid": 2 * int((~valid).sum()), "empty": 0, "one": 0, "more": 0}
    for pre in (wj[0], jl.rc_word_lanes(*wj[:3])[0]):
        pre = np.asarray(pre).astype(np.uint32).astype(np.int64)[valid]
        size = bin_ix[pre + 1] - bin_ix[pre]
        for k, m in (("empty", size == 0), ("one", size == 1), ("more", size > 1)):
            want[k] += int(m.sum())
    got = bsearch_bins(torch.from_numpy(np.asarray(index.bin_ix)),
                       *(torch.from_numpy(a) for a in (packed, vbits, lens)), true_len)
    assert got == want and sum(want.values()) == 2 * valid.size
    assert min(want.values()) > 0


def test_replicated_records_stay_views(tier):
    """mesh.replicate copies rec once a device and makes suf_hi, suf_lo and
    ix views of that copy (the meta device copies as a card does); a
    device the table is on keeps the table's own tensors."""
    from utree_tpu_torch.hash_index import bsearch_to_device
    from utree_tpu_torch.parallel.mesh import ShardMesh

    t = bsearch_to_device(tier["port"], "cpu")
    same, *copies = ShardMesh(["cpu", "meta", "meta"]).replicate(t)
    assert list(same) == list(t) and all(same[k] is t[k] for k in t)
    for r in copies:
        assert list(r) == list(t) and r["rec"]._base is None
        assert r["rec"].device.type == "meta" and r["rec"].shape == t["rec"].shape
        assert r["bin_ix"].shape == t["bin_ix"].shape
        for col, k in enumerate(("suf_hi", "suf_lo", "ix")):
            assert r[k]._base is r["rec"] and r[k].shape == t[k].shape
            assert r[k].stride() == (4,) and r[k].storage_offset() == col


@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_row_alignment_checks(shift):
    """The vector row loads' alignment rule: K6's 64-mer levels and K1/K4's
    wide two-slot rows start on 16 B, the narrow ones on 8 B; a view that
    starts off that boundary raises ValueError before any launch."""
    buf = torch.zeros(4092 + 8, dtype=torch.int32)
    off = (-buf.data_ptr() // 4) % 4 + shift  # int32 elements past a 16 B boundary
    t = buf[off:off + 4092].view(-1, 12)
    for align in (16, 8):
        if (4 * shift) % align:
            with pytest.raises(ValueError, match=f"c64_1 must be {align} B aligned"):
                tl._row_aligned(t, "c64_1", align)
        else:
            tl._row_aligned(t, "c64_1", align)


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
    jt, tt = index.device_put(), bsearch_to_device(tier["port"], "cpu")
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


# ---- the ASCII k=32 search step (append_rc, window_lanes, K14's route) --------

_KINDS = ("bsearch", "c1", "d1", "t1")


def _toy32(tmp_path_factory, ixtype_bytes=2, seed=83):
    """make_toy_db -> build_database -> DeviceIndexArrays.from_build, and the
    four k=32 tables of that DB as JAX pytrees and as the port's tensors."""
    from utree_tpu.build import build_database
    from utree_tpu.hash_index import build_canonical_hash_index, build_hash_index
    from utree_tpu.testdata import make_toy_db
    from utree_tpu_torch.convert import tables_from_jax

    wd = tmp_path_factory.mktemp("k32")
    recs = make_toy_db(str(wd / "refs.fa"), str(wd / "tax.map"), seed=seed, num_refs=6,
                       ref_len=3000)
    cfg = UTreeConfig(ixtype_bytes=ixtype_bytes)
    res = build_database(str(wd / "refs.fa"), str(wd / "tax.map"), cfg)
    index = DeviceIndexArrays.from_build(res.words, res.ixs, res.labels.strings, cfg)
    jt = {"bsearch": index.device_put(),
          "c1": build_canonical_hash_index(index).device_put(),
          "d1": build_displaced_index(index).device_put(),
          "t1": build_hash_index(index).device_put()}
    return dict(index=index, recs=recs, jt=jt,
                tt={k: tables_from_jax(v) for k, v in jt.items()})


@pytest.fixture(scope="module")
def k32(tmp_path_factory):
    return _toy32(tmp_path_factory)


def _ascii_batch(recs, n, width, seed):
    """(n, width) ASCII reads from the toy references: N's, lower case, 10%
    random rows, lengths from 0 to width (rows 0-2: 0, 31, 32 bases), and
    bases left past the length in half the rows (they must not count)."""
    rng = np.random.default_rng(seed)
    refs = [np.frombuffer(r[2], np.uint8) for r in recs]
    reads = np.zeros((n, width), np.uint8)
    for i in range(n):
        ref = refs[int(rng.integers(len(refs)))]
        s = int(rng.integers(0, len(ref) - width))
        reads[i] = ref[s:s + width]
    rand = rng.random(n) < 0.1
    reads[rand] = rng.choice(np.frombuffer(b"ACGT", np.uint8), (int(rand.sum()), width))
    reads[rng.random(reads.shape) < 0.02] = ord("N")
    lower = rng.random(reads.shape) < 0.05
    reads[lower] |= 0x20
    lens = np.full(n, width, np.int32)
    lens[n // 2:] = rng.integers(0, width + 1, n - n // 2)
    lens[:3] = (0, 31, 32)
    clear = (np.arange(width)[None, :] >= lens[:, None]) & (np.arange(n) % 2 == 0)[:, None]
    reads[clear] = 0
    return reads, lens


@pytest.mark.parametrize("width", [120, 150, 200])
def test_append_rc_window_lanes_and_k14_plain_match_jax(k32, width):
    """append_rc on base codes, window_lanes at k=32 (RC on and off), and
    K14's plain version in both modes against JAX's codes packed."""
    reads, lens = _ascii_batch(k32["recs"], 48, width, seed=width)
    tr, tlen = torch.from_numpy(reads), torch.from_numpy(lens)
    jcodes = jl.base_codes(reads, lens)
    tcodes = tl.base_codes(tr, tlen)
    assert np.array_equal(np.asarray(jcodes), _np(tcodes))
    jrc = np.asarray(jl.append_rc(jcodes, lens))
    assert np.array_equal(jrc, _np(tl.append_rc(tcodes, tlen)))
    for do_rc in (False, True):
        for a, b in zip(jl.window_lanes(reads, lens, 32, do_rc),
                        tl.window_lanes(tr, tlen, 32, do_rc)):
            assert np.array_equal(np.asarray(a).astype(np.int64), _np(b).astype(np.int64))
    for rc, codes in ((False, np.asarray(jcodes)), (True, jrc)):
        packed, vbits = tl.ascii_pack_plain(tr, tlen, rc)
        t8 = codes.shape[1] + (-codes.shape[1]) % 8
        pad = np.pad(codes, ((0, 0), (0, t8 - codes.shape[1])), constant_values=4)
        c = np.where(pad <= 3, pad, 0).astype(np.uint8)
        want = (c[:, 0::4] << 6) | (c[:, 1::4] << 4) | (c[:, 2::4] << 2) | c[:, 3::4]
        assert np.array_equal(_np(packed), want)
        assert np.array_equal(_np(vbits), np.packbits(pad <= 3, axis=1))
        # base_codes_packed of K14's output = the codes at every position
        back = tl.base_codes_packed(packed, vbits, torch.full_like(tlen, t8))
        assert np.array_equal(_np(back)[:, :codes.shape[1]], codes)
    assert (jrc[np.arange(len(lens)), lens] == 4).all()  # the sentinels


@pytest.mark.parametrize("do_rc", [True, False], ids=["rc", "forward"])
@pytest.mark.parametrize("width", [120, 150, 200])
@pytest.mark.parametrize("kind", _KINDS)
def test_search_step_k32_matches_jax(k32, kind, width, do_rc):
    """search_step on ASCII reads over each k=32 table: the CPU twin and
    the kernels' route (K14, the packed probe, the trim to W = L-31) both
    equal JAX's ids."""
    index = k32["index"]
    reads, lens = _ascii_batch(k32["recs"], 64, width, seed=7 * width + len(kind))
    kw = dict(k=32, do_rc=do_rc, probe_iters=index.probe_iters, bad_ix=BAD,
              num_labels=index.num_labels)
    j = np.asarray(jl.search_step(k32["jt"][kind], reads, lens, **kw))
    args = (k32["tt"][kind], torch.from_numpy(reads), torch.from_numpy(lens))
    t = tl.search_step(*args, **kw)
    assert t.dtype == torch.int32 and np.array_equal(j, _np(t))
    routed = tl.ascii_window_ids(*args, **{k: v for k, v in kw.items() if k != "k"})
    assert routed.is_contiguous() and torch.equal(routed, t)
    assert j.shape == (64, (2 if do_rc else 1) * (width - 31))
    assert (j < index.num_labels).sum() > 100


def test_search_step_k32_errors_match_jax(k32, tmp_path_factory):
    """JAX's exception types: no num_labels for a canonical table, k other
    than 32 (after the RC text append), reads shorter than k, an
    IXTYPE=u32 bad_ix on every table kind; search_step_hist hands
    search_step no num_labels."""
    index = k32["index"]
    reads, lens = _ascii_batch(k32["recs"], 8, 96, seed=5)
    kw = dict(k=32, do_rc=True, probe_iters=index.probe_iters, bad_ix=BAD)

    def both(exc, jt, tt, r=reads, **over):
        a = {**kw, "num_labels": None, **over}
        targs = (tt, torch.from_numpy(r), torch.from_numpy(lens))
        for call in (lambda: jl.search_step(jt, r, lens, **a),
                     lambda: tl.search_step(*targs, **a),
                     lambda: tl.ascii_window_ids(*targs, **a)):
            with pytest.raises(exc):
                call()

    jt, tt = k32["jt"], k32["tt"]
    for kind in ("c1", "d1"):
        with pytest.raises(ValueError, match="num_labels is required"):
            jl.search_step(jt[kind], reads, lens, **kw)
        with pytest.raises(ValueError, match="num_labels is required"):
            tl.search_step(tt[kind], torch.from_numpy(reads), torch.from_numpy(lens), **kw)
        with pytest.raises(ValueError, match="num_labels is required"):
            jl.search_step_hist(jt[kind], reads, lens, num_labels=8, cap=4, **kw)
        with pytest.raises(ValueError, match="num_labels is required"):
            tl.search_step_hist(tt[kind], torch.from_numpy(reads), torch.from_numpy(lens),
                                num_labels=8, cap=4, **kw)
    for kind in ("bsearch", "t1"):
        for k in (16, 64):
            both(NotImplementedError, jt[kind], tt[kind], k=k)
        both(ValueError, jt[kind], tt[kind], r=reads[:, :31])
    big = _toy32(tmp_path_factory, ixtype_bytes=4, seed=89)
    for kind in _KINDS:
        both(OverflowError, big["jt"][kind], big["tt"][kind],
             bad_ix=big["index"].config.bad_ix, num_labels=big["index"].num_labels)


@pytest.mark.parametrize("kind", ["bsearch", "t1"])
def test_search_step_hist_k32_matches_jax(k32, kind):
    index = k32["index"]
    reads, lens = _ascii_batch(k32["recs"], 64, 150, seed=31)
    kw = dict(k=32, do_rc=True, probe_iters=index.probe_iters, bad_ix=BAD,
              num_labels=index.num_labels)
    for cap in (1, 4):
        j = jl.search_step_hist(k32["jt"][kind], reads, lens, cap=cap, **kw)
        t = tl.search_step_hist(k32["tt"][kind], torch.from_numpy(reads),
                                torch.from_numpy(lens), cap=cap, **kw)
        assert t.shape == (64, 2 * cap + 2) and np.array_equal(np.asarray(j), _np(t))
