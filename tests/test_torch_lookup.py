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
    kw = dict(do_rc=do_rc, bad_ix=BAD, true_len=152)
    j = jl._packed_window_ix(tier["jt"], packed, vbits, lens, k=32, probe_iters=1,
                             num_labels=64, **kw)
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

