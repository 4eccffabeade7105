"""The port's routed displaced shards (utree_tpu_torch.parallel.routed)
against utree_tpu.parallel.routed on the 8 virtual CPU devices of
tests/conftest.py: the sharded arrays, the plain owner probe and t3 tail,
the routed step and its fallback (every int32, the overflow column
included), and SearchPipeline(devices=N, lookup_mode="routed") bytes.

The DB comes from make_toy_db -> build_database ->
DeviceIndexArrays.from_build; the port gets its copy through
convert.index_from_jax."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from utree_tpu.build import build_database
from utree_tpu.config import UTreeConfig
from utree_tpu.index import DeviceIndexArrays
from utree_tpu.lookup import pack_reads_host
from utree_tpu.parallel import make_mesh
from utree_tpu.parallel import routed as JR
from utree_tpu.pipeline import SearchPipeline as JaxPipeline
from utree_tpu.testdata import make_toy_db, make_toy_reads
from utree_tpu_torch.convert import index_from_jax
from utree_tpu_torch.parallel import routed as TR
from utree_tpu_torch.parallel.mesh import ShardMesh
from utree_tpu_torch.pipeline import SearchPipeline

BATCH = 128


def _wide_index(seed):
    """70,000 labels (IXTYPE=u32) over 60,000 random words, as
    tests/test_routed.py builds them; returns (index, words)."""
    rng = np.random.default_rng(seed)
    words = np.unique(rng.integers(0, 1 << 64, size=60_000, dtype=np.uint64))
    ixs = rng.integers(0, 70_000, size=len(words)).astype(np.int64)
    idx = DeviceIndexArrays.from_build(words, ixs, [b"l%d" % i for i in range(70_000)],
                                       UTreeConfig(ixtype_bytes=4))
    return idx, words


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    wd = tmp_path_factory.mktemp("routed")
    recs = make_toy_db(str(wd / "refs.fa"), str(wd / "tax.map"), seed=61, num_refs=12)
    make_toy_reads(str(wd / "reads.fa"), recs, num_reads=500, seed=67)
    # two long reads (chunked through the routed step) between short ones
    rng = np.random.default_rng(71)
    with open(wd / "reads.fa", "ab") as f:
        for i in range(2):
            parts = [recs[int(r)][2][:4000] for r in rng.choice(len(recs), 5)]
            f.write(b">long%d\n" % i + b"".join(parts) + b"\n")
        tail = [recs[int(r)][2][100:250] for r in rng.choice(len(recs), 40)]
        f.write(b"".join(b">tail%d\n" % i + s + b"\n" for i, s in enumerate(tail)))
    cfg = UTreeConfig()
    res = build_database(str(wd / "refs.fa"), str(wd / "tax.map"), cfg)
    index = DeviceIndexArrays.from_build(res.words, res.ixs, res.labels.strings, cfg)
    widx, words = _wide_index(41)
    return {"dir": wd, "index": index, "port": index_from_jax(index), "recs": recs,
            "reads": str(wd / "reads.fa"), "wide": widx, "wide_port": index_from_jax(widx),
            "wide_words": words}


def _batch(db, wide, seed, batch=64):
    """Packed reads: genome samples with N's and ragged lengths (narrow), or
    random reads with a stored word spliced in (wide)."""
    rng = np.random.default_rng(seed)
    if wide:
        reads = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(batch, 150))
        picks = rng.choice(db["wide_words"], size=batch)
        shifts = (2 * (31 - np.arange(32))).astype(np.uint64)
        bases = ((picks[:, None] >> shifts[None, :]) & np.uint64(3)).astype(np.int64)
        reads[:, 10:42] = np.frombuffer(b"ACGT", np.uint8)[bases]
        lens = np.full(batch, 150, np.int32)
    else:
        genome = np.frombuffer(db["recs"][0][2], np.uint8)
        starts = rng.integers(0, len(genome) - 150, batch)
        reads = genome[starts[:, None] + np.arange(150)].copy()
        reads[rng.random(reads.shape) < 0.02] = ord("N")
        lens = rng.integers(20, 151, batch).astype(np.int32)
    mat = np.zeros((batch, 192), np.uint8)
    mat[:, :150] = reads
    return pack_reads_host(mat, lens)


def _both(db, S, wide, **kw):
    """Both packages' ShardedDisplacedIndex of one DB (cached per config)."""
    cache = db.setdefault("sharded", {})
    ck = (S, wide, tuple(sorted(kw.items())))
    if ck not in cache:
        key = "wide" if wide else "index"
        cache[ck] = (JR.ShardedDisplacedIndex.build(db[key], S, **kw),
                     TR.ShardedDisplacedIndex.build(db[key + "_port" if wide else "port"],
                                                    S, **kw))
    return cache[ck]


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("S", [2, 4, 8])
def test_sharded_index_equals_jax(db, S, wide):
    j, t = _both(db, S, wide)
    assert t.wide == wide
    for f in ("t1", "seeds", "t3"):
        assert np.array_equal(getattr(j, f), getattr(t, f)), f
    assert (j.num_shards, j.nseed, j.slots3, j.num_entries) == (
        t.num_shards, t.nseed, t.slots3, t.num_entries)


def test_sharded_spill_over_budget_raises_as_jax(db):
    for build in (lambda: JR.ShardedDisplacedIndex.build(db["index"], 4, load=0.99,
                                                         spill_budget=0),
                  lambda: TR.ShardedDisplacedIndex.build(db["port"], 4, load=0.99,
                                                         spill_budget=0)):
        with pytest.raises(ValueError, match="spill .* exceeds the cached budget"):
            build()


def _lanes(t, rng, n, s, base_global):
    """(n, 3) int32 lanes of shard s: half its stored keys, half random
    keys; buckets local to s (base_global False) or global, a quarter of
    them another shard's."""
    per_seed = t.nseed // t.num_shards
    cps = 4 if t.wide else 3
    e = t.t1[s].reshape(-1, cps)
    e = e[(e[:, 2:] != 0).any(1)]
    keys = e[rng.integers(0, len(e), n), :2]
    rand = rng.random(n) < 0.5
    keys[rand] = rng.integers(-(1 << 31), 1 << 31, (int(rand.sum()), 2))
    bkt = rng.integers(0, per_seed, n)
    if base_global:
        bkt = bkt + s * per_seed
        other = rng.random(n) < 0.25
        bkt[other] = rng.integers(0, t.nseed, int(other.sum()))
    return np.stack([bkt, keys[:, 0], keys[:, 1]], 1).astype(np.int32)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_owner_probe_plain_equals_jax(db, wide):
    """The plain K12 against _displaced_local_probe: local buckets at base
    0 (the routed receive buffer), and global buckets at base s*per_seed
    (the fallback, JAX's where(mine, ...) around the same probe)."""
    _, t = _both(db, 4, wide)
    rng = np.random.default_rng(3)
    per_seed = t.nseed // 4
    for s in range(4):
        for base_global in (False, True):
            lanes = _lanes(t, rng, 4000, s, base_global)
            base = s * per_seed if base_global else 0
            got = TR.owner_probe_plain(torch.from_numpy(t.t1[s]),
                                       torch.from_numpy(t.seeds[s]),
                                       torch.from_numpy(lanes), base=base,
                                       per_seed=per_seed, wide=wide).numpy()
            g = jnp.asarray(lanes[:, 0])
            mine = (g >= base) & (g < base + per_seed)
            v = JR._displaced_local_probe(
                jnp.asarray(t.t1[s]), jnp.asarray(t.seeds[s]), jnp.where(mine, g - base, 0),
                jnp.asarray(lanes[:, 1]), jnp.asarray(lanes[:, 2]), wide)
            want = (np.stack([np.asarray(jnp.where(mine, x, 0)) for x in v], 1) if wide
                    else np.asarray(jnp.where(mine, v, 0)))
            assert np.array_equal(got, want)
            assert (got != 0).sum() > 100


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_t3_tail_plain_equals_jax(db, wide):
    """displaced_t3_tail against _displaced_t3_tail on a placement that
    spills (load 0.99): stored t3 keys, random keys, hits and misses
    already in `val`, invalid lanes."""
    _, t = _both(db, 4, wide, load=0.99, spill_budget=1 << 20)
    assert t.t3.shape[0] > 8
    cps = 4 if wide else 3
    rng = np.random.default_rng(5)
    e = t.t3.reshape(-1, cps)
    e = e[(e[:, 2:] != 0).any(1)]
    n = 5000
    keys = e[rng.integers(0, len(e), n), :2]
    rand = rng.random(n) < 0.4
    keys[rand] = rng.integers(-(1 << 31), 1 << 31, (int(rand.sum()), 2))
    valid = rng.random(n) < 0.9
    vals = rng.integers(-(1 << 31), 1 << 31, (n, 2)).astype(np.int32)
    vals[rng.random(n) < 0.7] = 0
    jv = (jnp.asarray(vals[:, 0]), jnp.asarray(vals[:, 1])) if wide else jnp.asarray(vals[:, 0])
    want = JR._displaced_t3_tail(jv, jnp.asarray(t.t3), jnp.asarray(keys[:, 0]),
                                 jnp.asarray(keys[:, 1]), jnp.asarray(valid), t.slots3, wide)
    tv = ((torch.from_numpy(vals[:, 0]), torch.from_numpy(vals[:, 1])) if wide
          else torch.from_numpy(vals[:, 0]))
    got = TR.displaced_t3_tail(tv, torch.from_numpy(t.t3),
                               torch.from_numpy(keys[:, 0]).long() & 0xFFFFFFFF,
                               torch.from_numpy(keys[:, 1]).long() & 0xFFFFFFFF,
                               torch.from_numpy(valid), wide)
    if wide:
        assert all(np.array_equal(a.numpy(), np.asarray(b)) for a, b in zip(got, want))
    else:
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert (got.numpy() != vals[:, 0]).sum() > 100


def _steps(db, S, wide, do_rc, capacity, seed):
    j, t = _both(db, S, wide)
    packed, vbits, lens = _batch(db, wide, seed)
    kw = dict(do_rc=do_rc, num_labels=db["wide" if wide else "index"].num_labels,
              cap=8, bad_ix=(UTreeConfig(ixtype_bytes=4) if wide else UTreeConfig()).bad_ix)
    mesh = make_mesh(data=1, table=S, devices=jax.devices()[:S])
    jt = j.device_put(mesh)
    jout = np.asarray(JR.routed_displaced_search_step(mesh, j, capacity=capacity, **kw)(
        jt, packed, vbits, lens))
    jfb = np.asarray(JR.routed_displaced_fallback_step(mesh, j, **kw)(jt, packed, vbits, lens))
    tm = ShardMesh(["cpu"] * S)
    tabs = t.to_devices(tm)
    args = [torch.from_numpy(a) for a in (packed, vbits, lens)]
    tout = torch.cat(TR.routed_displaced_search_step(tm, t, capacity=capacity, **kw)(
        tabs, *args)).numpy()
    tfb = torch.cat(TR.routed_displaced_fallback_step(tm, t, **kw)(tabs, *args)).numpy()
    return jout, tout, jfb, tfb


@pytest.mark.parametrize("capacity", [None, 8], ids=["cap-auto", "cap-8"])
@pytest.mark.parametrize("do_rc", [True, False], ids=["rc", "forward"])
@pytest.mark.parametrize("S", [2, 4, 8])
def test_routed_step_and_fallback_equal_jax(db, S, do_rc, capacity):
    jout, tout, jfb, tfb = _steps(db, S, False, do_rc, capacity, seed=S)
    assert np.array_equal(tout, jout) and np.array_equal(tfb, jfb)
    assert (jout[:, -1] == (S if capacity == 8 else 0)).all()
    assert np.array_equal(jout[:, :-1], jfb) == (capacity is None)


@pytest.mark.parametrize("capacity", [None, 8], ids=["cap-auto", "cap-8"])
@pytest.mark.parametrize("S", [2, 8])
def test_routed_step_wide_equals_jax(db, S, capacity):
    jout, tout, jfb, tfb = _steps(db, S, True, True, capacity, seed=10 + S)
    assert np.array_equal(tout, jout) and np.array_equal(tfb, jfb)
    assert ((jfb[:, 0] & 0xFFFF) != 0).sum() > 30  # the spliced words hit


def test_route_displaced_plain_orders_and_drops_as_jax(db):
    """K11's plain version: ranks in lane order, the dropped lanes those of
    rank >= C, unwritten slots 0, and counts/overflow as documented."""
    _, t = _both(db, 4, False)
    packed, vbits, lens = (torch.from_numpy(a) for a in _batch(db, False, 21))
    for C in (8, 100_000):
        send, rec, counts = TR.route_displaced_plain(packed, vbits, lens, nseed=t.nseed,
                                                     num_shards=4, capacity=C)
        slot = rec[:, 0].long()
        valid = (rec[:, 3] & 1) == 1
        assert int(counts[:4].sum()) == int(valid.sum())
        assert int(counts[4]) == int((counts[:4] > C).any())
        routed = slot >= 0
        assert (routed <= valid).all()
        owner, rank = slot[routed] // C, slot[routed] % C
        for o in range(4):
            r = rank[owner == o]
            assert torch.equal(r, torch.arange(len(r)))  # lane order, no gaps
            assert int((send[o, len(r):] != 0).sum()) == 0
        assert torch.equal(send.reshape(-1, 3)[slot[routed]][:, 1:], rec[routed][:, 1:3])


# ---- the pipeline ------------------------------------------------------------------

@pytest.fixture(scope="module")
def single(db):
    out = db["dir"] / "jax_single.txt"
    JaxPipeline(db["index"], do_rc=True, batch_size=BATCH).search_file(db["reads"], str(out))
    return out.read_bytes()


@pytest.mark.parametrize("devices", [4, 8])
def test_routed_pipeline_equals_jax(db, single, tmp_path, devices):
    jax_out, port_out = tmp_path / "jax.txt", tmp_path / "port.txt"
    jp = JaxPipeline(db["index"], do_rc=True, batch_size=BATCH, devices=devices,
                     lookup_mode="routed")
    jp.search_file(db["reads"], str(jax_out))
    pipe = SearchPipeline(db["port"], device="cpu", do_rc=True, batch_size=BATCH,
                          devices=devices, lookup_mode="routed")
    assert pipe.table_kind == jp.table_kind == "routed-displaced"
    assert pipe.layout == "packed" and len(pipe._tables) == devices
    pipe.search_file(db["reads"], str(port_out))
    assert port_out.read_bytes() == jax_out.read_bytes() == single
    assert single.count(b"\n") > 300 and b"long1\t" in single


def test_routed_pipeline_forced_fallback(db, single, tmp_path):
    """Capacity 8 overflows every batch: each goes through the fallback and
    the bytes stay the JAX pipeline's (tests/test_parallel.py:190-213)."""
    pipe = SearchPipeline(db["port"], device="cpu", do_rc=True, batch_size=BATCH,
                          devices=8, lookup_mode="routed")
    sharded = TR.ShardedDisplacedIndex.build(db["port"], 8)
    pipe._step_routed = TR.routed_displaced_search_step(
        pipe._mesh, sharded, do_rc=True, num_labels=db["port"].num_labels,
        cap=pipe.hist_cap, bad_ix=db["port"].config.bad_ix, capacity=8)
    calls = []
    fallback = pipe._fallback_step
    pipe._fallback_step = lambda *a: calls.append(1) or fallback(*a)
    out = tmp_path / "port.txt"
    pipe.search_file(db["reads"], str(out))
    assert out.read_bytes() == single
    assert len(calls) >= 6  # five batches and the long reads' chunk batches


def test_routed_support8_equals_jax(db, tmp_path):
    jax_out, port_out = tmp_path / "jax.txt", tmp_path / "port.txt"
    JaxPipeline(db["index"], do_rc=False, batch_size=BATCH, devices=2, lookup_mode="routed",
                support_ranges=8).search_file(db["reads"], str(jax_out))
    SearchPipeline(db["port"], device="cpu", do_rc=False, batch_size=BATCH, devices=2,
                   lookup_mode="routed", support_ranges=8).search_file(
        db["reads"], str(port_out))
    assert port_out.read_bytes() == jax_out.read_bytes()
    assert max(ln.count(b"\t") for ln in port_out.read_bytes().splitlines()) == 11


def _message(make):
    with pytest.raises(ValueError) as e:
        make()
    return str(e.value)


@pytest.mark.parametrize("case", ["no-devices", "one-device", "wide", "batch", "present"])
def test_value_errors_match_jax(db, monkeypatch, case):
    """Each refusal of devices=N / routed raises JAX's ValueError with its
    message; 'present' asks the CPU box's 8 virtual JAX devices and, with
    the card count patched to 8, the port for 16."""
    kw = {"no-devices": dict(lookup_mode="routed"),
          "one-device": dict(lookup_mode="routed", devices=1),
          "wide": dict(lookup_mode="routed", devices=4),
          "batch": dict(devices=3, batch_size=128),
          "present": dict(devices=16)}[case]
    key = "wide" if case == "wide" else "index"
    want = _message(lambda: JaxPipeline(db[key], **kw))
    dev = "cpu"
    if case == "present":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
        dev = "cuda"
    got = _message(lambda: SearchPipeline(db[key + "_port" if case == "wide" else "port"],
                                          device=dev, **kw))
    assert got == want



class _Placed(Exception):
    pass


@pytest.mark.parametrize("case", ["three", "six", "sixteen-cards", "128-cards"])
def test_routed_shard_counts_refused(db, monkeypatch, case):
    """Shard counts the routed mode cannot serve raise before the placement
    (JAX's build loops for ever on them): a count that is no power of two,
    in the pipeline and in ShardedDisplacedIndex.build, and more shards
    than K11 takes on cards (128 > MAX_SHARDS, the card count patched).
    16 shards on cards are within K11's limit: they reach the placement."""
    devices = {"three": 3, "six": 6, "sixteen-cards": 16, "128-cards": 128}[case]
    dev = "cpu"
    if case.endswith("cards"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: devices)
        dev = "cuda"
    else:
        with pytest.raises(ValueError, match=f"power-of-two shard count, got {devices}"):
            TR.ShardedDisplacedIndex.build(db["port"], devices)
    placed = []

    def place(cls, index, num_shards, **kw):
        placed.append(num_shards)
        raise _Placed

    monkeypatch.setattr(TR.ShardedDisplacedIndex, "build", classmethod(place))

    def make():
        return SearchPipeline(db["port"], device=dev, batch_size=96 * devices,
                              devices=devices, lookup_mode="routed")

    if case == "sixteen-cards":
        assert TR.MAX_SHARDS == 64
        with pytest.raises(_Placed):
            make()
        assert placed == [16]
        return
    got = _message(make)
    assert got == (f"--lookup-mode routed runs at most 64 shards on cards, got --devices "
                   f"{devices}" if devices == 128 else
                   f"--lookup-mode routed needs a power-of-two --devices, got {devices}")
    assert not placed


def test_routed_pipeline_sixteen_shards_equals_jax(db, single, tmp_path):
    """16 routed shards, past the 8 of JAX's CPU mesh: the port's bytes
    equal utree_tpu's single-device search on the same DB."""
    out = tmp_path / "port.txt"
    pipe = SearchPipeline(db["port"], device="cpu", do_rc=True, batch_size=BATCH,
                          devices=16, lookup_mode="routed")
    assert pipe.table_kind == "routed-displaced" and len(pipe._tables) == 16
    assert pipe._sharded.num_shards == 16
    pipe.search_file(db["reads"], str(out))
    assert out.read_bytes() == single
