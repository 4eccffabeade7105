"""The port's sharded modes (utree_tpu_torch.parallel.sharded, mesh) against
utree_tpu.parallel.sharded on the 8 virtual CPU devices of
tests/conftest.py: the ShardedIndex arrays, the replicated step on every
k=32 table kind, the prefix-sharded step on (2, 4) and (1, 8) meshes at
complevel 1 and 2, the sequence-parallel long-read histogram, K15's and
K16's plain versions, and the port's dryrun (the counterpart of
__graft_entry__.py).  Every output is an integer: exact equality.

The DBs come from make_toy_db -> build_database ->
DeviceIndexArrays.from_build; the port gets its copy through
convert.index_from_jax, and the same tables through convert.tables_from_jax."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from utree_tpu.build import build_database
from utree_tpu.config import UTreeConfig
from utree_tpu.hash_index import (build_canonical_hash_index, build_displaced_index,
                                  build_hash_index)
from utree_tpu.index import DeviceIndexArrays
from utree_tpu.parallel import make_mesh as jax_mesh
from utree_tpu.parallel import sharded as JS
from utree_tpu.testdata import make_toy_db
from utree_tpu_torch import dryrun
from utree_tpu_torch import lookup as tl
from utree_tpu_torch.convert import index_from_jax, tables_from_jax
from utree_tpu_torch.parallel import mesh as TM
from utree_tpu_torch.parallel import sharded as TS

CPU8 = ["cpu"] * 8


def _db(wd, complevel=1, ixtype_bytes=2):
    recs = make_toy_db(str(wd / "refs.fa"), str(wd / "tax.map"), seed=97, num_refs=8,
                       ref_len=4000)
    cfg = UTreeConfig(complevel=complevel, ixtype_bytes=ixtype_bytes)
    res = build_database(str(wd / "refs.fa"), str(wd / "tax.map"), cfg)
    index = DeviceIndexArrays.from_build(res.words, res.ixs, res.labels.strings, cfg)
    return dict(index=index, port=index_from_jax(index), recs=recs)


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    wd = tmp_path_factory.mktemp("sharded")
    return {c: _db(wd, complevel=c) for c in (1, 2)}


def _reads(recs, n, width, seed):
    """(n, width) ASCII reads from the references: N's, lower case, 10%
    random rows, lengths 0..width (rows 0-2: 0, 31, 32)."""
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
    reads[rng.random(reads.shape) < 0.05] |= 0x20
    lens = np.full(n, width, np.int32)
    lens[n // 2:] = rng.integers(0, width + 1, n - n // 2)
    lens[:3] = (0, 31, 32)
    reads[np.arange(width)[None, :] >= lens[:, None]] = 0
    return reads, lens


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("complevel", [1, 2])
@pytest.mark.parametrize("S", [2, 4, 8])
def test_sharded_index_equals_jax(dbs, S, complevel):
    db = dbs[complevel]
    j = JS.ShardedIndex.from_index(db["index"], S)
    t = TS.ShardedIndex.from_index(db["port"], S)
    for f in ("bin_ix", "suf_hi", "suf_lo", "ix", "prefix_lo"):
        a, b = getattr(j, f), getattr(t, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (j.num_shards, j.probe_iters) == (t.num_shards, t.probe_iters)
    counts = np.diff(db["index"].bin_ix.astype(np.int64)[t.prefix_lo.tolist() + [1 << 24]])
    assert len(set(counts.tolist())) > 1  # uneven shards: padded slices
    with pytest.raises(ValueError, match="divide 2"):
        TS.ShardedIndex.from_index(db["port"], 3)
    tabs = t.to_devices(TM.make_mesh(8 // S, S, CPU8))
    assert all(tabs[i] is tabs[i % S] for i in range(8))  # one copy a slice


def _tables(index):
    return {"bsearch": index.device_put(),
            "c1": build_canonical_hash_index(index).device_put(),
            "d1": build_displaced_index(index).device_put(),
            "t1": build_hash_index(index).device_put()}


@pytest.mark.parametrize("do_rc", [True, False], ids=["rc", "forward"])
@pytest.mark.parametrize("kind", ["bsearch", "c1", "d1", "t1"])
def test_replicated_step_equals_jax(dbs, kind, do_rc):
    """Rows over `data` of a (4, 2) mesh, the table on every device."""
    db = dbs[1]
    jt = _tables(db["index"])[kind]
    reads, lens = _reads(db["recs"], 64, 150, seed=3)
    j = JS.replicated_search_step(jax_mesh(4, 2), db["index"], do_rc=do_rc)(jt, reads, lens)
    mesh = TM.make_mesh(4, 2, CPU8)
    t = TS.replicated_search_step(mesh, db["port"], do_rc=do_rc)(
        mesh.replicate(tables_from_jax(jt)), *_t(reads, lens))
    assert t.dtype == torch.int32 and np.array_equal(np.asarray(j), t.numpy())
    assert (t.numpy() < db["index"].num_labels).sum() > 100


@pytest.mark.parametrize("do_rc", [True, False], ids=["rc", "forward"])
@pytest.mark.parametrize("complevel", [1, 2])
@pytest.mark.parametrize("shape", [(2, 4), (1, 8)], ids=["2x4", "1x8"])
def test_sharded_step_equals_jax(dbs, shape, complevel, do_rc):
    """The prefix-sharded step, and K15's plain version on each slice
    against JAX's _local_lookup (the packed route the card takes, at the
    read width 150, which is no multiple of 8)."""
    db = dbs[complevel]
    d, s = shape
    reads, lens = _reads(db["recs"], 32, 150, seed=11 + d)
    jsh = JS.ShardedIndex.from_index(db["index"], s)
    jm = jax_mesh(d, s)
    j = JS.sharded_search_step(jm, jsh, do_rc=do_rc)(jsh.device_put(jm), reads, lens)
    tsh = TS.ShardedIndex.from_index(db["port"], s)
    mesh = TM.make_mesh(d, s, CPU8)
    tabs = tsh.to_devices(mesh)
    t = TS.sharded_search_step(mesh, tsh, do_rc=do_rc)(tabs, *_t(reads, lens))
    assert t.dtype == torch.int32 and np.array_equal(np.asarray(j), t.numpy())
    assert (t.numpy() < db["index"].num_labels).sum() > 10
    # K15's plain version: packed reads, one slice
    lanes = JS.window_lanes(reads, lens, 32, do_rc)
    packed, vbits = tl.ascii_pack(*_t(reads, lens))
    for u in range(s):
        jix, jfound = JS._local_lookup(
            *(jnp.asarray(a[u]) for a in (jsh.bin_ix, jsh.suf_hi, jsh.suf_lo, jsh.ix)),
            jsh.prefix_lo[u], jsh.bin_ix.shape[1] - 1, *lanes, jsh.probe_iters, 65535)
        ix, found = TS.shard_probe(tabs[u], packed, vbits, torch.from_numpy(lens),
                                   prefix_lo=int(tsh.prefix_lo[u]), width=150,
                                   do_rc=do_rc, probe_iters=tsh.probe_iters)
        assert np.array_equal(np.asarray(jfound), found.numpy().astype(bool))
        assert np.array_equal(np.where(np.asarray(jfound), np.asarray(jix), 0), ix.numpy())


@pytest.mark.parametrize("S", [2, 4, 8])
def test_slice_records_hold_the_three_arrays(dbs, S):
    """The `rec` that to_devices places for each slice (here on the CPU)
    holds suf_hi, suf_lo (its int32 bits) and ix as its columns, and the
    dict's three arrays are views of them; shard_probe_plain over those
    views equals JAX's _local_lookup on every slice."""
    db = dbs[2]
    jsh = JS.ShardedIndex.from_index(db["index"], S)
    tsh = TS.ShardedIndex.from_index(db["port"], S)
    tabs = tsh.to_devices(TM.make_mesh(1, S, CPU8[:S]))
    reads, lens = _reads(db["recs"], 32, 150, seed=20 + S)
    lanes = JS.window_lanes(reads, lens, 32, True)
    packed, vbits = tl.ascii_pack(*_t(reads, lens))
    for u, tab in enumerate(tabs):
        rec = tab["rec"]
        assert rec.dtype == torch.int32 and rec.shape == (tsh.suf_hi.shape[1], 4)
        for col, key in enumerate(("suf_hi", "suf_lo", "ix")):
            view = tab[key]
            assert view.data_ptr() == rec.data_ptr() + 4 * col and view.stride() == (4,)
            assert np.array_equal(view.numpy(), getattr(tsh, key)[u].view(np.int32)), key
        assert not rec[:, 3].any()
        jix, jfound = JS._local_lookup(
            *(jnp.asarray(a[u]) for a in (jsh.bin_ix, jsh.suf_hi, jsh.suf_lo, jsh.ix)),
            jsh.prefix_lo[u], jsh.bin_ix.shape[1] - 1, *lanes, jsh.probe_iters, 65535)
        ix, found = TS.shard_probe_plain(tab, packed, vbits, torch.from_numpy(lens),
                                         prefix_lo=int(tsh.prefix_lo[u]), width=150,
                                         do_rc=True, probe_iters=tsh.probe_iters)
        assert np.array_equal(np.asarray(jfound), found.numpy().astype(bool))
        assert np.array_equal(np.where(np.asarray(jfound), np.asarray(jix), 0), ix.numpy())
        assert int(found.sum()) > 0


def test_stored_bad_ix_and_zero_suffixes_equal_jax():
    """Records whose id is bad_ix count as found (the merged lane is bad_ix
    through the sum), and words of suffix 0 next to the zero-suffix padding
    of the shorter slices."""
    rng = np.random.default_rng(5)
    cfg = UTreeConfig()
    words = rng.integers(0, 1 << 63, size=3000, dtype=np.uint64)
    words[:200] &= ~np.uint64((1 << 40) - 1)  # suffix 0
    words[200:400] &= np.uint64((1 << 62) - 1)  # crowd the low shards
    words = np.unique(words)
    ixs = rng.integers(0, 8, len(words)).astype(np.int64)
    ixs[rng.random(len(words)) < 0.1] = cfg.bad_ix
    index = DeviceIndexArrays.from_build(words, ixs, [b"l%d" % i for i in range(8)], cfg)
    port = index_from_jax(index)
    pick = words[rng.integers(0, len(words), 16)]
    shifts = (2 * (31 - np.arange(32))).astype(np.uint64)
    codes = ((pick[:, None] >> shifts[None, :]) & np.uint64(3)).astype(np.int64)
    reads = np.frombuffer(b"ACGT", np.uint8)[np.tile(codes, (1, 3))][:, :96].copy()
    lens = np.full(16, 96, np.int32)
    for shape in ((2, 4), (1, 8)):
        jsh, tsh = JS.ShardedIndex.from_index(index, shape[1]), TS.ShardedIndex.from_index(
            port, shape[1])
        jm, mesh = jax_mesh(*shape), TM.make_mesh(*shape, CPU8)
        j = np.asarray(JS.sharded_search_step(jm, jsh, do_rc=True)(
            jsh.device_put(jm), reads, lens))
        t = TS.sharded_search_step(mesh, tsh, do_rc=True)(tsh.to_devices(mesh),
                                                          *_t(reads, lens))
        assert np.array_equal(j, t.numpy())
        assert (j == cfg.bad_ix).any() and (j < 8).sum() > 16


@pytest.mark.parametrize("do_rc", [True, False], ids=["rc", "forward"])
def test_long_read_histogram_equals_jax(dbs, do_rc):
    """One long read over a (4, 2) mesh, one chunk a device (the last
    chunks shorter than 32 bases: no window), against JAX and against a
    bincount of the single-device ids."""
    db = dbs[2]
    rng = np.random.default_rng(13)
    seq = b"".join(db["recs"][int(i)][2][100:2100] for i in rng.integers(0, 8, 3))
    seq = bytes(np.frombuffer(seq, np.uint8)[:6000 - 40])
    chunks, clens = JS.split_long_read(seq, 8, 32)
    tchunks, tclens = TS.split_long_read(seq, 8, 32)
    assert np.array_equal(chunks, tchunks) and np.array_equal(clens, tclens)
    L = db["index"].num_labels
    j = JS.long_read_histogram(jax_mesh(4, 2), db["index"], L, do_rc=do_rc)(
        db["index"].device_put(), chunks, clens)
    mesh = TM.make_mesh(4, 2, CPU8)
    table = tables_from_jax(db["index"].device_put())
    t = TS.long_read_histogram(mesh, db["port"], L, do_rc=do_rc)(
        mesh.replicate(table), *_t(chunks, clens))
    assert t.dtype == torch.int32 and np.array_equal(np.asarray(j), t.numpy())
    ids = tl.search_step(table, *_t(chunks, clens), k=32, do_rc=do_rc,
                         probe_iters=db["index"].probe_iters, bad_ix=65535).numpy()
    assert np.array_equal(t.numpy(), np.bincount(ids[ids < L], minlength=L))
    assert t.sum() > 100


def test_label_histogram_plain_equals_jax():
    """K16's plain version on ids of every sign: JAX's signed compare and
    `.at[]`'s wrap of a negative slot."""
    rng = np.random.default_rng(17)
    for L in (1, 5, 300):
        ids = rng.integers(-2 * L - 5, 2 * L + 5, (7, 333)).astype(np.int32)
        ids[0, :4] = (-1, -(L + 1), -(L + 2), np.iinfo(np.int32).min)
        hit = ids < L
        slot = jnp.where(hit, ids, L)
        j = jnp.zeros((L + 1,), jnp.int32).at[slot.reshape(-1)].add(1)[:L]
        t = TS.label_histogram(torch.from_numpy(ids), L)
        assert t.dtype == torch.int32 and np.array_equal(np.asarray(j), t.numpy())


def test_ixtype_u32_raises_as_jax(tmp_path):
    """An IXTYPE=u32 bad_ix (2^32-1) does not fit the int32 id lanes: JAX
    raises OverflowError in every step, and so does the port."""
    db = _db(tmp_path, ixtype_bytes=4)
    reads, lens = _reads(db["recs"], 16, 96, seed=19)
    chunks, clens = JS.split_long_read(b"ACGT" * 300, 8, 32)
    jm, mesh = jax_mesh(2, 4), TM.make_mesh(2, 4, CPU8)
    jsh, tsh = JS.ShardedIndex.from_index(db["index"], 4), TS.ShardedIndex.from_index(
        db["port"], 4)
    assert (tsh.ix == -1).any() and np.array_equal(jsh.ix, tsh.ix)
    table = tables_from_jax(db["index"].device_put())
    L = db["index"].num_labels
    calls = [
        lambda: JS.sharded_search_step(jm, jsh)(jsh.device_put(jm), reads, lens),
        lambda: TS.sharded_search_step(mesh, tsh)(tsh.to_devices(mesh), *_t(reads, lens)),
        lambda: JS.replicated_search_step(jm, db["index"])(db["index"].device_put(),
                                                           reads, lens),
        lambda: TS.replicated_search_step(mesh, db["port"])(mesh.replicate(table),
                                                            *_t(reads, lens)),
        lambda: JS.long_read_histogram(jm, db["index"], L)(db["index"].device_put(),
                                                           chunks, clens),
        lambda: TS.long_read_histogram(mesh, db["port"], L)(mesh.replicate(table),
                                                            *_t(chunks, clens)),
    ]
    for call in calls:
        with pytest.raises(OverflowError):
            call()


def test_mesh_layout_and_collectives():
    """make_mesh's (data, table) grid and ValueError; psum and reduce over
    one axis or both, as jax.lax.psum sums."""
    with pytest.raises(ValueError, match=r"mesh 3x2 != 8 devices"):
        jax_mesh(3, 2)
    with pytest.raises(ValueError, match=r"mesh 3x2 != 8 devices"):
        TM.make_mesh(3, 2, CPU8)
    m = TM.make_mesh(table=4, devices=CPU8)
    assert m.shape == (2, 4) and TM.ShardMesh(CPU8).shape == (1, 8)
    parts = [torch.tensor([1 << i]) for i in range(8)]
    assert [int(x) for x in m.psum(parts, "table")] == [15] * 4 + [240] * 4
    assert [int(x) for x in m.psum(parts, "data")] == [17, 34, 68, 136] * 2
    assert [int(x) for x in m.psum(parts)] == [255] * 8
    assert [int(x) for x in m.reduce(parts, "table")] == [15, 240]
    assert [int(x) for x in m.reduce(parts, ("data", "table"))] == [255]
    with pytest.raises(ValueError, match="axis"):
        m.psum(parts, "rows")


def test_rows_must_divide_over_data():
    db = dryrun._toy_index()[0]
    mesh = TM.make_mesh(4, 2, CPU8)
    reads, lens = dryrun._toy_reads(6, 64)
    step = TS.replicated_search_step(mesh, db)
    with pytest.raises(ValueError, match="do not divide over 4"):
        step(mesh.replicate({}), *_t(reads, lens))


def test_dryrun_entry_and_multichip_equal_jax():
    """entry("cpu") computes JAX's entry() ids; dryrun_multichip runs every
    block on 8 CPU devices (and on 3, where the table axis is 1)."""
    import __graft_entry__ as graft

    jfn, jargs = graft.entry()
    tfn, targs = dryrun.entry("cpu")
    j, t = np.asarray(jfn(*jargs)), tfn(*targs)
    assert t.dtype == torch.int32 and np.array_equal(j, t.numpy())
    jidx, tidx = graft._toy_index()[0], dryrun._toy_index()[0]
    for f in ("bin_ix", "suf_hi", "suf_lo", "ix"):
        assert np.array_equal(getattr(jidx, f), getattr(tidx, f))
    dryrun.dryrun_multichip(8, device="cpu")
    dryrun.dryrun_multichip(3, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs 8 cards, 0 present"):
            dryrun.dryrun_multichip(8)
