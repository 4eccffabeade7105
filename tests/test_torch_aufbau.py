"""The port's aufbau walk (utree_tpu_torch.classify_device) against both the
JAX walk (utree_tpu.classify_device.aufbau_walk_device) and the host oracle
classify._aufbau_walk, on the adversarial taxonomies of
tests/test_classify_device.py.  Exact equality: every output is an integer."""

import jax
import numpy as np
import pytest
import torch

from test_classify_device import _expected, _random_strings, _toprint
from utree_tpu.classify_device import (DV_FULL, aufbau_walk_device,
                                       build_aufbau_tables)
from utree_tpu_torch import _u32
from utree_tpu_torch.classify_device import (aufbau_tables_to_device,
                                             aufbau_walk, pack_vote)


def _batch(rng, L, cap, n=300):
    """n reads of 2..cap unique labels (ascending ids, as compact_histogram
    emits them), plus -1/0 padding."""
    labels = np.full((n, cap), -1, np.int32)
    counts = np.zeros((n, cap), np.int32)
    nuniq = np.zeros(n, np.int32)
    found = np.zeros(n, np.int32)
    batch = []
    for b in range(n):
        k = int(rng.integers(2, cap + 1))
        u = np.sort(rng.choice(L, size=min(k, L), replace=False))
        c = rng.integers(1, 12, size=len(u))
        labels[b, : len(u)], counts[b, : len(u)] = u, c
        nuniq[b], found[b] = len(u), int(c.sum())
        batch.append((u, c))
    return labels, counts, nuniq, found, batch


# taxacut and max_iters enter as traced scalars (the walk only divides by
# the one and compares against the other), so one compile serves every
# taxacut of a (taxonomy, cap) shape
_jax_walk_jit = jax.jit(lambda t, l, c, n, f, taxacut, max_iters: aufbau_walk_device(
    t, l, c, n, f, taxacut=taxacut, max_iters=max_iters))


def _jax_walk(tab, arrays, cap, taxacut, max_iters):
    out = _jax_walk_jit(tab.device_put(), *arrays, np.uint32(taxacut),
                        np.int32(max_iters))
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("taxacut", [2, 4, 8])
@pytest.mark.parametrize("cap", [4, 8, 12])
@pytest.mark.parametrize("seed", range(8))
def test_walk_matches_jax_and_host_oracle(seed, cap, taxacut):
    rng = np.random.default_rng(seed)
    strings = _random_strings(rng, int(rng.integers(8, 80)))
    tab = build_aufbau_tables(strings)
    max_iters = (tab.max_len + 4) * (cap + 2) + 16
    arrays = _batch(rng, len(strings), cap)
    batch = arrays[4]
    arrays = arrays[:4]
    want = _jax_walk(tab, arrays, cap, taxacut, max_iters)
    got = aufbau_walk(aufbau_tables_to_device(tab, "cpu"),
                      *(torch.from_numpy(a) for a in arrays),
                      taxacut=taxacut, max_iters=max_iters)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32
        assert np.array_equal(w, g.numpy())
    rep, dvcode, dv, sl, ol, flag = (g.numpy() for g in got)
    assert not flag.any()
    for b, (u, c) in enumerate(batch):
        tp, want_sl, want_ol = _expected(strings, u, c, taxacut)
        assert _toprint(strings, int(rep[b]), int(dvcode[b]), int(dv[b])) == tp
        assert (int(sl[b]), int(ol[b])) == (want_sl, want_ol)


def test_padding_lanes_and_overflow_match_jax():
    """Lanes that only read padding: nuniq 0 (labels all -1), nuniq 1, and
    overflow (nuniq = cap+1).  JAX clamps and wraps the out-of-range gathers
    these lanes make; the port must produce the same values on them."""
    rng = np.random.default_rng(9)
    strings = _random_strings(rng, 20)
    tab = build_aufbau_tables(strings)
    cap = 4
    labels = np.full((4, cap), -1, np.int32)
    counts = np.zeros((4, cap), np.int32)
    labels[1, 0], counts[1, 0] = 5, 7
    labels[2], counts[2] = [0, 1, 2, 3], [1, 1, 1, 1]
    labels[3, :2], counts[3, :2] = [19, 2], [3, 4]
    nuniq = np.array([0, 1, cap + 1, 2], np.int32)
    found = np.array([0, 7, 5, 7], np.int32)
    arrays = (labels, counts, nuniq, found)
    want = _jax_walk(tab, arrays, cap, 4, 256)
    got = aufbau_walk(aufbau_tables_to_device(tab, "cpu"),
                      *(torch.from_numpy(a) for a in arrays), taxacut=4, max_iters=256)
    for w, g in zip(want, got):
        assert np.array_equal(w, g.numpy())
    assert got[0][1] == 5 and got[1][1] == DV_FULL and got[5].tolist() == [0, 0, 1, 0]


def test_iteration_cap_flags_like_jax():
    """A walk cut by max_iters is flagged for host replay, lane by lane."""
    rng = np.random.default_rng(2)
    strings = _random_strings(rng, 60)
    tab = build_aufbau_tables(strings)
    arrays = _batch(rng, len(strings), 8, n=200)[:4]
    for max_iters in (1, 3):
        want = _jax_walk(tab, arrays, 8, 4, max_iters)
        got = aufbau_walk(aufbau_tables_to_device(tab, "cpu"),
                          *(torch.from_numpy(a) for a in arrays),
                          taxacut=4, max_iters=max_iters)
        for w, g in zip(want, got):
            assert np.array_equal(w, g.numpy())
        assert got[5].any()


def test_pack_vote_matches_jax_epilogue():
    """The 12 B pack with its field-range flags (lookup.py:798-808) on values
    that overflow every lane."""
    import jax.numpy as jnp

    from utree_tpu.classify_device import DV_INTERP

    rng = np.random.default_rng(3)
    n = 500
    rep = rng.integers(-1, 60000, n).astype(np.int32)
    dvcode = rng.integers(0, 3, n).astype(np.int32)
    dv = rng.integers(-2, 4000, n).astype(np.int32)
    sl = rng.integers(0, 1 << 17, n).astype(np.int32)
    ol = rng.integers(0, 1 << 17, n).astype(np.int32)
    flag = (rng.random(n) < 0.1).astype(np.int32)
    nuniq = rng.integers(0, 40, n).astype(np.int32)
    found = rng.integers(0, 1 << 21, n).astype(np.int32)
    # the JAX epilogue, verbatim from search_step_vote_compact
    unfit = ((found >= (1 << 20)) | (sl >= (1 << 16)) | (ol >= (1 << 16))
             | ((dvcode == DV_INTERP) & (dv >= (1 << 11))))
    f = jnp.asarray(flag) | unfit.astype(np.int32)
    w0 = ((jnp.asarray(rep) + 1) | (jnp.minimum(nuniq, 31) << 17) | (dvcode << 22)
          | (f << 24))
    w1 = jnp.asarray(found) | (jnp.where(dvcode == DV_INTERP, dv, 0) << 20)
    w2 = jnp.asarray(sl) | (jnp.asarray(ol) << 16)
    want = np.asarray(jnp.stack([w0, w1, w2], axis=1))
    got = pack_vote(*(torch.from_numpy(a) for a in
                      (rep, dvcode, dv, sl, ol, flag, nuniq, found)))
    assert np.array_equal(want, got.numpy())


def test_u32_helpers_wrap_like_uint32():
    """mul32 / i32 / floor_log2 against numpy's uint32 arithmetic (the lax.clz
    and wraparound hazards)."""
    rng = np.random.default_rng(4)
    a = rng.integers(0, 1 << 32, 10_000, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, 10_000, dtype=np.uint64).astype(np.uint32)
    ta, tb = (torch.from_numpy(x.astype(np.int64)) for x in (a, b))
    with np.errstate(over="ignore"):
        assert np.array_equal((a * b).astype(np.int64), _u32.mul32(ta, tb).numpy())
        assert np.array_equal((a - b).astype(np.int64), ((ta - tb) & _u32.M).numpy())
    assert np.array_equal(a.view(np.int32), _u32.i32(ta).numpy())
    n = np.concatenate([np.arange(1, 5000), [2**31 - 1, 2**30, 2**30 - 1]])
    want = 31 - np.array([32 - int(x).bit_length() for x in n])
    assert np.array_equal(want, _u32.floor_log2(torch.from_numpy(n)).numpy())

