"""The port's routed canonical-table steps (utree_tpu_torch.parallel.routed)
against utree_tpu.parallel.routed on the 8 virtual CPU devices of
tests/conftest.py: ShardedCanonicalIndex, the plain K17 owner probe, the
t2/t3 tail and the plain K18 finish, the routed step and its fallback on
(1, S) and (2, 4) meshes (every int32, the overflow column included), and
the routed displaced steps on a (2, 4) mesh.

The DB comes from make_toy_db -> build_database ->
DeviceIndexArrays.from_build; the port gets its copy through
convert.index_from_jax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from utree_tpu import hash_index as JH
from utree_tpu import lookup as JL
from utree_tpu.build import build_database
from utree_tpu.config import UTreeConfig
from utree_tpu.index import DeviceIndexArrays
from utree_tpu.lookup import pack_reads_host
from utree_tpu.parallel import make_mesh
from utree_tpu.parallel import routed as JR
from utree_tpu.testdata import make_toy_db
from utree_tpu_torch import hash_index as TH
from utree_tpu_torch import kernels
from utree_tpu_torch.convert import index_from_jax
from utree_tpu_torch.parallel import make_mesh as torch_mesh
from utree_tpu_torch.parallel import routed as TR

CHAIN = (4, 4.0, 2, 1 << 27)  # tier B's three-level shape: c2 and c3 in use


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    wd = tmp_path_factory.mktemp("routed_canonical")
    recs = make_toy_db(str(wd / "refs.fa"), str(wd / "tax.map"), seed=73, num_refs=12)
    cfg = UTreeConfig()
    res = build_database(str(wd / "refs.fa"), str(wd / "tax.map"), cfg)
    index = DeviceIndexArrays.from_build(res.words, res.ixs, res.labels.strings, cfg)
    rng = np.random.default_rng(43)
    words = np.unique(rng.integers(0, 1 << 64, size=60_000, dtype=np.uint64))
    ixs = rng.integers(0, 70_000, size=len(words)).astype(np.int64)
    widx = DeviceIndexArrays.from_build(words, ixs, [b"l%d" % i for i in range(70_000)],
                                        UTreeConfig(ixtype_bytes=4))
    return {"recs": recs, "words": words,
            "narrow": (index, index_from_jax(index)), "wide": (widx, index_from_jax(widx)),
            "canon": {}}


def _canon(db, kind, geometry="default"):
    """(JAX, port) CanonicalHashArrays of one DB: the default placement, or
    the chain geometry whose c2 and c3 both hold entries."""
    key = (kind, geometry)
    if key not in db["canon"]:
        j, t = db[kind]
        if geometry == "chain":
            pair = (JH._place_canonical(*JH._canonical_groups(j), *CHAIN, slots3=16),
                    TH._place_canonical(*TH._canonical_groups(t), *CHAIN, slots3=16))
            assert pair[0].t2.shape[0] > 8 and pair[0].t3.shape[0] > 8
        else:
            pair = (JH.build_canonical_hash_index(j), TH.build_canonical_hash_index(t))
        db["canon"][key] = pair
    return db["canon"][key]


def _sharded(db, kind, S, geometry="default"):
    jc, tc = _canon(db, kind, geometry)
    return (JR.ShardedCanonicalIndex.from_canonical(jc, S),
            TR.ShardedCanonicalIndex.from_canonical(tc, S))


def _batch(db, kind, seed, batch=64):
    """Packed reads: genome samples with N's and ragged lengths (narrow), or
    random reads with a stored word spliced in (wide)."""
    rng = np.random.default_rng(seed)
    if kind == "wide":
        reads = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(batch, 150))
        picks = rng.choice(db["words"], size=batch)
        shifts = (2 * (31 - np.arange(32))).astype(np.uint64)
        bases = ((picks[:, None] >> shifts[None, :]) & np.uint64(3)).astype(np.int64)
        reads[:, 10:42] = np.frombuffer(b"ACGT", np.uint8)[bases]
        lens = np.full(batch, 150, np.int32)
    else:
        genome = np.frombuffer(db["recs"][int(rng.integers(len(db["recs"])))][2], np.uint8)
        starts = rng.integers(0, len(genome) - 150, batch)
        reads = genome[starts[:, None] + np.arange(150)].copy()
        reads[rng.random(reads.shape) < 0.02] = ord("N")
        lens = rng.integers(20, 151, batch).astype(np.int32)
    mat = np.zeros((batch, 192), np.uint8)
    mat[:, :150] = reads
    return pack_reads_host(mat, lens)


def _kw(db, kind, do_rc, cap=8):
    index = db[kind][0]
    return dict(do_rc=do_rc, num_labels=index.num_labels, cap=cap,
                bad_ix=index.config.bad_ix)


def _u32(a):
    return torch.from_numpy(np.asarray(a)).long() & 0xFFFFFFFF


# ---- the sharded arrays ------------------------------------------------------

@pytest.mark.parametrize("kind", ["narrow", "wide"])
@pytest.mark.parametrize("S", [2, 4, 8])
def test_sharded_canonical_index_equals_jax(db, S, kind):
    j, t = _sharded(db, kind, S)
    assert t.wide == j.wide == (kind == "wide")
    for f in ("t1", "t2", "t3"):
        assert np.array_equal(getattr(j, f), getattr(t, f)), f
    assert (j.num_shards, j.b1, j.slots, j.slots2, j.slots3) == (
        t.num_shards, t.b1, t.slots, t.slots2, t.slots3)
    tabs = t.to_devices(torch_mesh(2, S, ["cpu"] * (2 * S)))
    assert len(tabs) == 2 * S
    for i, tab in enumerate(tabs):
        assert np.array_equal(tab["t1"].numpy(), j.t1[i % S])
        assert np.array_equal(tab["t2"].numpy(), j.t2)


def test_from_canonical_refuses_as_jax(db):
    """b1 % S raises JAX's ValueError; a mesh whose table axis is not S
    is refused by to_devices and the steps."""
    jc, tc = _canon(db, "narrow")
    for cls, c in ((JR.ShardedCanonicalIndex, jc), (TR.ShardedCanonicalIndex, tc)):
        with pytest.raises(ValueError, match="num_shards must divide the t1 bucket count"):
            cls.from_canonical(c, 3)
    t = TR.ShardedCanonicalIndex.from_canonical(tc, 4)
    mesh = torch_mesh(4, 2, ["cpu"] * 8)
    with pytest.raises(ValueError, match=r"4 table shards on a mesh of \(4, 2\)"):
        t.to_devices(mesh)
    with pytest.raises(ValueError, match=r"4 table shards on a mesh of \(4, 2\)"):
        TR.routed_canonical_search_step(mesh, t, **_kw(db, "narrow", True))


# ---- the plain K17, tail and K18 -------------------------------------------------

def _lanes(t, rng, n, s, base_global):
    """(n, 3) int32 lanes of shard s: half its stored keys at their rows,
    half random keys at random rows; buckets local to s (base_global False)
    or global, a quarter of them another shard's."""
    per = t.b1 // t.num_shards
    cps = 4 if t.wide else 3
    e = t.t1[s].reshape(per, -1, cps)
    row, slot = np.nonzero((e[:, :, 2:] != 0).any(2))
    pick = rng.integers(0, len(row), n)
    keys = e[row[pick], slot[pick], :2]
    bkt = row[pick].astype(np.int64)
    rand = rng.random(n) < 0.5
    keys[rand] = rng.integers(-(1 << 31), 1 << 31, (int(rand.sum()), 2))
    bkt[rand] = rng.integers(0, per, int(rand.sum()))
    if base_global:
        bkt = bkt + s * per
        other = rng.random(n) < 0.25
        bkt[other] = rng.integers(0, t.b1, int(other.sum()))
    return np.stack([bkt, keys[:, 0], keys[:, 1]], 1).astype(np.int32)


@pytest.mark.parametrize("kind", ["narrow", "wide"])
def test_canonical_owner_probe_plain_equals_jax(db, kind):
    """The plain K17 against JAX's owner gather and probe_rows[_wide]:
    local buckets at base 0 (the routed receive buffer, routed.py:153-165)
    and global buckets at base s*per_shard (the fallback, :250-266)."""
    j, t = _sharded(db, kind, 4)
    rng = np.random.default_rng(3)
    per = t.b1 // 4
    for s in range(4):
        for base_global in (False, True):
            lanes = _lanes(t, rng, 4000, s, base_global)
            base = s * per if base_global else 0
            got = TR.canonical_owner_probe_plain(
                torch.from_numpy(t.t1[s]), torch.from_numpy(lanes), base=base,
                per_shard=per, wide=t.wide).numpy()
            g = jnp.asarray(lanes[:, 0])
            mine = (g >= base) & (g < base + per)
            rows = jnp.asarray(j.t1[s])[jnp.where(mine, g - base, 0)]
            klo, khi = jnp.asarray(lanes[:, 1]), jnp.asarray(lanes[:, 2])
            if t.wide:
                va, vb = JL.probe_rows_wide(rows, klo, khi, j.slots)
                want = np.stack([np.asarray(jnp.where(mine, va, 0)),
                                 np.asarray(jnp.where(mine, vb, 0))], 1)
            else:
                want = np.asarray(jnp.where(mine, JL.probe_rows(rows, klo, khi, j.slots), 0))
            assert np.array_equal(got, want)
            assert (got != 0).sum() > 100


def _tail_inputs(t, rng, n):
    """Keys stored in t2 and t3 and random ones; values with hits and
    misses already in them; a tenth of the lanes invalid."""
    cps = 4 if t.wide else 3
    stored = [x.reshape(-1, cps) for x in (t.t2, t.t3, t.t1.reshape(-1, t.t1.shape[-1]))]
    e = np.concatenate([x[(x[:, 2:] != 0).any(1)][:, :2] for x in stored])
    keys = e[rng.integers(0, len(e), n)]
    rand = rng.random(n) < 0.3
    keys[rand] = rng.integers(-(1 << 31), 1 << 31, (int(rand.sum()), 2))
    valid = rng.random(n) < 0.9
    vals = rng.integers(-(1 << 31), 1 << 31, (n, 2)).astype(np.int32)
    vals[rng.random(n) < 0.7] = 0
    return keys.astype(np.int32), valid, vals


@pytest.mark.parametrize("kind", ["narrow", "wide"])
@pytest.mark.parametrize("geometry", ["default", "chain"])
def test_tail_probe_plain_equals_jax(db, geometry, kind):
    """tail_probe_plain against _tail_probe / _tail_probe_wide
    (routed.py:95-118): the default placement (a small t2, the t3
    sentinel) and the chain (c2 and c3 in use)."""
    j, t = _sharded(db, kind, 4, geometry)
    keys, valid, vals = _tail_inputs(t, np.random.default_rng(5), 6000)
    klo, khi, jv = jnp.asarray(keys[:, 0]), jnp.asarray(keys[:, 1]), jnp.asarray(valid)
    _, bkt2 = JL.canonical_buckets(klo, khi, jv, j.b1, j.t2.shape[0])
    t2, t3 = jnp.asarray(j.t2), jnp.asarray(j.t3)
    tk = dict(key_lo=_u32(keys[:, 0]), key_hi=_u32(keys[:, 1]),
              valid=torch.from_numpy(valid), wide=t.wide)
    tb2 = torch.from_numpy(np.array(bkt2))
    if t.wide:
        want = JR._tail_probe_wide(jnp.asarray(vals[:, 0]), jnp.asarray(vals[:, 1]), t2, t3,
                                   bkt2, klo, khi, jv, j.slots2, j.slots3)
        got = TR.tail_probe_plain((torch.from_numpy(vals[:, 0]), torch.from_numpy(vals[:, 1])),
                                  torch.from_numpy(t.t2), torch.from_numpy(t.t3), tb2, **tk)
        assert all(np.array_equal(a.numpy(), np.asarray(b)) for a, b in zip(got, want))
        changed = int((got[0].numpy() != vals[:, 0]).sum())
    else:
        want = JR._tail_probe(jnp.asarray(vals[:, 0]), t2, t3, bkt2, klo, khi, jv,
                              j.slots2, j.slots3)
        got = TR.tail_probe_plain(torch.from_numpy(vals[:, 0]), torch.from_numpy(t.t2),
                                  torch.from_numpy(t.t3), tb2, **tk)
        assert np.array_equal(got.numpy(), np.asarray(want))
        changed = int((got.numpy() != vals[:, 0]).sum())
    assert changed > (100 if geometry == "chain" else 0)


@pytest.mark.parametrize("kind", ["narrow", "wide"])
@pytest.mark.parametrize("geometry", ["default", "chain"])
def test_routed_canonical_finish_plain_equals_jax(db, geometry, kind):
    """The plain K18 on K11's records (nseed = b1, a capacity that drops
    lanes) and the owners' replies, against the reply gather, _tail_probe
    and decode_canonical_vals / _wide of routed.py:196-212, RC on and off."""
    j, t = _sharded(db, kind, 4, geometry)
    packed, vbits, lens = (torch.from_numpy(a) for a in _batch(db, kind, 7))
    b, w = packed.shape[0], packed.shape[1] * 4 - 31
    per = t.b1 // 4
    C = b * w // 32  # most of each owner's lanes are dropped
    send, rec, counts = TR.route_displaced_plain(packed, vbits, lens, nseed=t.b1,
                                                 num_shards=4, capacity=C)
    assert int(counts[4]) == 1
    reply = torch.stack([TR.canonical_owner_probe_plain(
        torch.from_numpy(t.t1[o]), send[o], base=0, per_shard=per, wide=t.wide)
        for o in range(4)])
    r = rec.numpy()
    slot, valid, fwd_le = r[:, 0], (r[:, 3] & 1) == 1, (r[:, 3] & 2) == 2
    rep = reply.numpy().reshape(4 * C, -1)
    got_v = np.where(slot[:, None] >= 0, rep[np.maximum(slot, 0)], 0).astype(np.int32)
    klo, khi, jv = jnp.asarray(r[:, 1]), jnp.asarray(r[:, 2]), jnp.asarray(valid)
    _, bkt2 = JL.canonical_buckets(klo, khi, jv, j.b1, j.t2.shape[0])
    t2, t3 = jnp.asarray(j.t2), jnp.asarray(j.t3)
    vm, fm = jv.reshape(b, w), jnp.asarray(fwd_le).reshape(b, w)
    bad = db[kind][0].config.bad_ix
    hits = 0
    for do_rc in (True, False):
        if t.wide:
            va, vb = JR._tail_probe_wide(jnp.asarray(got_v[:, 0]), jnp.asarray(got_v[:, 1]),
                                         t2, t3, bkt2, klo, khi, jv, j.slots2, j.slots3)
            ids = JL.decode_canonical_wide(va.reshape(b, w), vb.reshape(b, w), vm, fm,
                                           min(bad, 0x7FFFFFFF), do_rc)
        else:
            val = JR._tail_probe(jnp.asarray(got_v[:, 0]), t2, t3, bkt2, klo, khi, jv,
                                 j.slots2, j.slots3)
            ids = JL.decode_canonical_vals(val.reshape(b, w), vm, fm, bad, do_rc)
        want = np.concatenate([np.asarray(x) for x in ids], 1) if do_rc else np.asarray(ids)
        got = TR.routed_canonical_finish_plain(
            rec, reply, torch.from_numpy(t.t2), torch.from_numpy(t.t3), b=b, w=w,
            do_rc=do_rc, bad_ix=min(bad, 0x7FFFFFFF), wide=t.wide).numpy()
        assert np.array_equal(got, want)
        hits += int((got != min(bad, 0x7FFFFFFF)).sum())
    assert hits > 10


# ---- the steps -------------------------------------------------------------------

def _steps(db, kind, shape, do_rc, capacity, seed, geometry="default", displaced=False):
    """JAX's and the port's routed step and fallback on a (D, S) mesh of
    the same reads: (jax step, port step, jax fallback, port fallback)."""
    D, S = shape
    index, port = db[kind]
    if displaced:
        j, t = JR.ShardedDisplacedIndex.build(index, S), TR.ShardedDisplacedIndex.build(port, S)
        names = ("routed_displaced_search_step", "routed_displaced_fallback_step")
    else:
        j, t = _sharded(db, kind, S, geometry)
        names = ("routed_canonical_search_step", "routed_fallback_step")
    packed, vbits, lens = _batch(db, kind, seed)
    kw = _kw(db, kind, do_rc)
    mesh = make_mesh(data=D, table=S, devices=jax.devices()[:D * S])
    jt = j.device_put(mesh)
    jstep, jfall = (getattr(JR, n) for n in names)
    tstep, tfall = (getattr(TR, n) for n in names)
    jout = np.asarray(jstep(mesh, j, capacity=capacity, **kw)(jt, packed, vbits, lens))
    jfb = np.asarray(jfall(mesh, j, **kw)(jt, packed, vbits, lens))
    tm = torch_mesh(D, S, ["cpu"] * (D * S))
    tabs = t.to_devices(tm)
    args = [torch.from_numpy(a) for a in (packed, vbits, lens)]
    touts = tstep(tm, t, capacity=capacity, **kw)(tabs, *args)
    tfbs = tfall(tm, t, **kw)(tabs, *args)
    assert len(touts) == D * S and len(tfbs) == D
    return jout, torch.cat(touts).numpy(), jfb, torch.cat(tfbs).numpy()


def _check(jout, tout, jfb, tfb, oflo):
    assert np.array_equal(tout, jout) and np.array_equal(tfb, jfb)
    assert (jout[:, -1] == oflo).all()
    assert np.array_equal(jout[:, :-1], jfb) == (oflo == 0)
    assert (jfb[:, 0] != 0).sum() > 10  # reads hit


@pytest.mark.parametrize("do_rc", [True, False], ids=["rc", "forward"])
@pytest.mark.parametrize("S", [2, 4, 8])
def test_routed_canonical_step_equals_jax(db, S, do_rc):
    _check(*_steps(db, "narrow", (1, S), do_rc, None, seed=S), 0)


@pytest.mark.parametrize("case", ["2x4-forward", "2x4-chain-rc", "wide-1x8", "wide-2x4",
                                  "cap8-1x8", "cap8-2x4"])
def test_routed_canonical_mesh_cases_equal_jax(db, case):
    """(2, 4) as tests/test_routed.py:61 runs it; the chain geometry (c3
    through the step); wide labels; capacity 8, where every batch flags on
    every row (the column is the psum over both axes: D*S) and only the
    fallback is exact."""
    shape = (1, 8) if "1x8" in case else (2, 4)
    kind = "wide" if case.startswith("wide") else "narrow"
    capacity = 8 if case.startswith("cap8") else None
    geometry = "chain" if "chain" in case else "default"
    do_rc = case != "2x4-forward"
    res = _steps(db, kind, shape, do_rc, capacity, seed=len(case), geometry=geometry)
    _check(*res, 8 if capacity else 0)


@pytest.mark.parametrize("capacity", [None, 8], ids=["cap-auto", "cap-8"])
def test_routed_displaced_steps_on_2x4_equal_jax(db, capacity):
    """The repaired displaced steps on a (data, table) mesh, as
    tests/test_routed.py:166-185 runs JAX's: rows over all eight devices
    for the step, over `data` for the fallback."""
    _check(*_steps(db, "narrow", (2, 4), False, capacity, seed=9, displaced=True),
           8 if capacity else 0)


def test_routed_displaced_rows_equal_canonical_rows(db):
    """__graft_entry__.py:177's cross-check on a (2, 4) mesh: the routed
    displaced rows equal the routed canonical rows."""
    disp = _steps(db, "narrow", (2, 4), True, None, seed=11, displaced=True)
    canon = _steps(db, "narrow", (2, 4), True, None, seed=11)
    assert np.array_equal(disp[1], canon[1])


def test_all_to_all_over_table_moves_blocks_within_data_rows():
    """Block o of the device at (d, s) lands in block s of the device at
    (d, o); nothing crosses data rows; (1, S) is the plain exchange."""
    mesh = torch_mesh(2, 4, ["cpu"] * 8)
    blocks = [torch.tensor([[100 * i + o] for o in range(4)]) for i in range(8)]
    out = mesh.all_to_all(blocks)
    for d in range(2):
        for s in range(4):
            for o in range(4):
                assert int(out[d * 4 + o][s]) == 100 * (d * 4 + s) + o
    with pytest.raises(ValueError, match="8 tensors"):
        mesh.all_to_all(blocks[:4])


def test_kernel_registry_lists_every_entry_point():
    """26 entry points: each has a launch count and a C signature."""
    from utree_tpu_torch.kernels.build import SIGNATURES

    assert len(kernels.KERNELS) == 26 == len(set(kernels.KERNELS))
    assert set(SIGNATURES) == {"utree_" + k for k in kernels.KERNELS}
    assert set(kernels.launches) == set(kernels.KERNELS)
    for k in ("canonical_owner_probe", "canonical_owner_probe_wide",
              "routed_canonical_finish", "routed_canonical_finish_wide"):
        assert k in kernels.KERNELS
