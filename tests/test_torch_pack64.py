"""The port's PACKSIZE=64 path (BASELINE config 4) against utree_tpu's.

Lookup pieces take the same numpy inputs in both packages: ASCII reads ->
codes -> four-lane 64-mer windows -> canonical keys -> per-window ids on
both 64-mer tables (the ladder c64_1/2/3 and the displaced d64_1/s/3) in
every placed geometry, then the unpacked histogram step.  The pipeline
tests compare classifications.txt byte for byte, both pipelines searching
the same table (convert.tables_from_jax).  Every output is an integer or a
byte, so equality is exact.

Databases come from make_toy_db -> build_database -> from_build (or from
random words), through chip_smoke.index64, which drops the one k-mer that
would trip the shared 64-mer builders' fault (ROADMAP §C); the fault itself
is pinned by test_lowest_bin_fault_matches_jax."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import index64
from utree_tpu import lookup as jl
from utree_tpu.build import build_database
from utree_tpu.config import UTreeConfig
from utree_tpu.encode import W128
from utree_tpu.hash_index import _rc64
from utree_tpu.hash_index64 import (_canonical_groups64, _place64, _rc128,
                                    build_canonical_hash_index64,
                                    build_displaced_index64, mix4)
from utree_tpu.index import DeviceIndexArrays
from utree_tpu.pipeline import SearchPipeline as JaxPipeline
from utree_tpu.testdata import make_toy_db, make_toy_reads
from utree_tpu_torch import lookup as tl
from utree_tpu_torch.convert import tables_from_jax
from utree_tpu_torch.hash_index import canonical64_to_device, displaced64_to_device
from utree_tpu_torch.pipeline import SearchPipeline

BATCH = 64
MISS = 0x7FFFFFFF
SMALL_THRESHOLD, SMALL_CHUNK = 400, 128


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _u(x):
    """A JAX int32 lane -> its u32 value as int64 (the port's lane)."""
    return np.asarray(x).view(np.uint32).astype(np.int64)


def _lanes(words):
    """W128 words -> (k0, k1, k2, k3) uint32 lanes, k0 most significant."""
    m = np.uint64(0xFFFFFFFF)
    return [(w >> np.uint64(32)).astype(np.uint32) if i == 0 else (w & m).astype(np.uint32)
            for w in (words["hi"], words["lo"]) for i in (0, 1)]


def _reads(genome, n, seed, read_len=150, width=192):
    """ASCII reads from a genome: 1% mutation, 10% random, N's, lower case,
    ragged lengths, zero padding; and two palindromic 64-mer windows."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    starts = rng.integers(0, len(genome) - read_len, n)
    reads = genome[starts[:, None] + np.arange(read_len)].copy()
    mut = rng.random(reads.shape) < 0.01
    reads[mut] = rng.choice(acgt, int(mut.sum()))
    rand = rng.random(n) < 0.1
    reads[rand] = rng.choice(acgt, (int(rand.sum()), read_len))
    reads[rng.random(reads.shape) < 0.004] = ord("N")
    reads[rng.random(reads.shape) < 0.02] |= 0x20
    comp = np.zeros(256, np.uint8)
    for a, b in zip(b"ACGT", b"TGCA"):
        comp[a] = b
    for r in range(2):  # a 32-mer and its reverse complement: a palindrome
        reads[r, 8:40] = rng.choice(acgt, 32)
        reads[r, 40:72] = comp[reads[r, 8:40][::-1]]
    lens = rng.integers(40, read_len + 1, n).astype(np.int32)
    lens[: n // 2] = read_len
    out = np.zeros((n, width), np.uint8)
    out[:, :read_len] = reads
    out[np.arange(width)[None, :] >= lens[:, None]] = 0
    return out, lens


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A toy PACKSIZE=64 DB (u32 and u16 labels), its genome, short reads
    with chimeras (2+ labels a read), and a file of long reads."""
    wd = tmp_path_factory.mktemp("pack64")
    recs = make_toy_db(str(wd / "refs.fa"), str(wd / "tax.map"), seed=53,
                       num_refs=8, ref_len=3000)
    make_toy_reads(str(wd / "short.fa"), recs, num_reads=300, seed=55)
    rng = np.random.default_rng(57)
    with open(wd / "short.fa", "ab") as f:
        for i in range(30):
            parts = []
            for r in rng.choice(len(recs), 3, replace=False):
                s = int(rng.integers(0, len(recs[r][2]) - 80))
                parts.append(recs[r][2][s:s + 80])
            f.write(b">chimera%d\n" % i + b"".join(parts) + b"\n")
    genome = b"".join(r[2] for r in recs)
    shorts = (wd / "short.fa").read_bytes().split(b">")[1:]
    with open(wd / "long.fa", "wb") as f:
        for i, rec in enumerate(shorts[:90]):
            f.write(b">" + rec)
            if i % 30 == 7:  # reads of 1.2-3.6 kbp: several chunks each
                a = int(rng.integers(0, len(genome) - 4000))
                f.write(b">long%d\n" % i + genome[a:a + 1200 * (1 + i // 30)] + b"\n")
        f.write(b">big\n" + genome[:20_000] + b"\n")  # over the real threshold
    out = {"dir": wd, "genome": np.frombuffer(genome, np.uint8), "golden": {}}
    for ixb in (4, 2):
        cfg = UTreeConfig(packsize=64, ixtype_bytes=ixb)
        res = build_database(str(wd / "refs.fa"), str(wd / "tax.map"), cfg)
        out[ixb] = index64(res.words, res.ixs, list(res.labels.strings), ixb)
    return out


def test_windows_keys_and_mix4_match_jax(env):
    reads, lens = _reads(env["genome"], 64, seed=1)
    cj = jl.base_codes(jnp.asarray(reads), jnp.asarray(lens))
    ct = tl.base_codes(torch.from_numpy(reads), torch.from_numpy(lens))
    assert np.array_equal(np.asarray(cj), _np(ct))
    wj = jl.extract_windows64(cj)
    wt = tl.extract_windows64(ct)
    for a, b in zip(wj[:4], wt[:4]):
        assert np.array_equal(_u(a), _np(b))
    assert np.array_equal(np.asarray(wj[4]), _np(wt[4]))
    assert _np(wt[4]).any() and not _np(wt[4]).all()  # invalid windows present
    for a, b in zip(jl.rc_lanes64(*wj[:4]), tl.rc_lanes64(*wt[:4])):
        assert np.array_equal(_u(a), _np(b))
    cj4 = jl._canonicalize64(*wj[:4])
    ct4 = tl.canonicalize64(*wt[:4])
    for a, b in zip(cj4[:4], ct4[:4]):
        assert np.array_equal(_u(a), _np(b))
    assert np.array_equal(np.asarray(cj4[4]), _np(ct4[4]))
    # the palindromic window (start 8) is its own RC: key = word, fwd_le
    for r in range(2):
        assert _np(ct4[4])[r, 8] and all(_np(ct4[i])[r, 8] == _np(wt[i])[r, 8]
                                          for i in range(4))
    u = [np.asarray(x).view(np.uint32) for x in cj4[:4]]
    for seed in (0, 0x6A09E667, 0x5BD1E995, 0x27D4EB2F, 0x94D049BB, 0x7FEB352D):
        want = np.asarray(mix4(*(jnp.asarray(x) for x in u), seed, jnp.uint32))
        got = tl.mix4(*ct4[:4], seed)
        assert np.array_equal(want.astype(np.int64), _np(got))


def _random_case(seed, n_words=6000, nlab=50, ixb=4):
    """A DB of random 64-mers, the RCs of some of them (stored under other
    labels) and palindromes; queries: stored words, their RCs, palindromes
    and random words, 5% of them invalid."""
    rng = np.random.default_rng(seed)
    w = np.zeros(n_words, W128)
    w["hi"] = rng.integers(0, 1 << 64, n_words, dtype=np.uint64)
    w["lo"] = rng.integers(0, 1 << 64, n_words, dtype=np.uint64)
    n_rc = min(500, n_words // 2)
    rc = np.zeros(n_rc, W128)
    rc["hi"], rc["lo"] = _rc128(w["hi"][:n_rc], w["lo"][:n_rc])
    pal = np.zeros(n_rc // 2, W128)
    pal["hi"] = rng.integers(0, 1 << 64, len(pal), dtype=np.uint64)
    pal["lo"] = _rc64(pal["hi"])  # a 64-mer equal to its reverse complement
    words = np.unique(np.concatenate([w, rc, pal]))
    index = index64(words, rng.integers(0, nlab, len(words)),
                    [b"l%d" % i for i in range(nlab)], ixb)
    q = np.concatenate([rng.choice(words, 3000), rc, pal, w[:300]])
    rnd = np.zeros(1000, W128)
    rnd["hi"] = rng.integers(0, 1 << 64, 1000, dtype=np.uint64)
    rnd["lo"] = rng.integers(0, 1 << 64, 1000, dtype=np.uint64)
    q = np.concatenate([q, rnd])
    valid = rng.random(len(q)) < 0.95
    return index, q, valid


def _geometry(index, name):
    if name == "ladder":
        return build_canonical_hash_index64(index)
    if name == "chain":  # narrow c64_2 + cached c64_3
        built = _place64(*_canonical_groups64(index), 2, 16.0, 1, 1 << 26, slots3=8)
        assert built.t2.shape[0] > 8 and built.t3.shape[0] > 8
        return built
    if name == "wide-c2":  # an overloaded c64_1 spilling into 8-slot c64_2 rows
        built = _place64(*_canonical_groups64(index), 2, 4.0, 8, 1 << 26, 0)
        assert built.t2.shape[0] > 8 and built.t3.shape[0] == 8
        return built
    if name == "displaced":
        return build_displaced_index64(index)
    built = build_displaced_index64(index, load=0.98, spill_budget=index.num_records)
    assert built.t3.shape[0] > 8  # the d64_3 tail is exercised
    return built


def _lookup_both(built, q, valid, do_rc, miss=MISS):
    k = _lanes(q)
    jk = [jnp.asarray(x.view(np.int32)) for x in k]
    tk = [torch.from_numpy(x.astype(np.int64)) for x in k]
    tv = torch.from_numpy(valid)
    if hasattr(built, "seeds"):
        j = jl.lookup_kmers_displaced64(built.device_put(), *jk, valid, miss=miss,
                                        do_rc=do_rc)
        t = tl.lookup_kmers_displaced64(displaced64_to_device(built, "cpu"), *tk, tv,
                                        miss=miss, do_rc=do_rc)
    else:
        kw = dict(slots=built.slots, slots2=built.slots2, miss=miss, do_rc=do_rc)
        j = jl.lookup_kmers_canonical64(built.device_put(), *jk, valid, **kw)
        t = tl.lookup_kmers_canonical64(canonical64_to_device(built, "cpu"), *tk, tv, **kw)
    if do_rc:
        return np.stack([np.asarray(x) for x in j]), np.stack([_np(x) for x in t])
    return np.asarray(j), _np(t)


@pytest.mark.parametrize("do_rc", [True, False], ids=["rc", "forward"])
@pytest.mark.parametrize("geometry", ["ladder", "chain", "wide-c2", "displaced",
                                      "displaced-spill"])
def test_lookup64_matches_jax(geometry, do_rc):
    """Per-window ids of both 64-mer tables in every placed geometry: stored
    words, their RCs (stored apart under other labels), palindromes (one
    entry answers both strands), random words and invalid windows."""
    index, q, valid = _random_case(seed=61)
    built = _geometry(index, geometry)
    j, t = _lookup_both(built, q, valid, do_rc)
    assert t.dtype == np.int32 and np.array_equal(j, t)
    assert (t != MISS).sum() > 2000
    assert (t[..., ~valid] == MISS).all()


@pytest.mark.parametrize("ixb", [4, 2], ids=["u32", "u16"])
def test_lookup64_sentinels_match_jax(ixb):
    """A DB of seven words spills nothing: c64_2, c64_3 and d64_3 are the
    8-row sentinels, never probed; the u16 miss id is 65535."""
    index, q, valid = _random_case(seed=67, n_words=4, nlab=5, ixb=ixb)
    miss = min(index.config.bad_ix, MISS)
    for built in (build_canonical_hash_index64(index), build_displaced_index64(index)):
        assert built.t3.shape[0] == 8 and getattr(built, "t2", built.t3).shape[0] == 8
        for do_rc in (True, False):
            j, t = _lookup_both(built, q, valid, do_rc, miss)
            assert np.array_equal(j, t)
            assert (t != miss).any()


@pytest.mark.parametrize("table", ["ladder", "displaced"])
def test_search_step_hist_k64_matches_jax(env, table):
    """The whole k=64 histogram step on ASCII reads, RC on and off, at caps
    1 and 4: (B, 2*cap+2) rows, bitwise."""
    index = env[4]
    built = _geometry(index, table)
    jt = built.device_put()
    tt = (canonical64_to_device if table == "ladder" else displaced64_to_device)(built, "cpu")
    reads, lens = _reads(env["genome"], 96, seed=3)
    for do_rc in (True, False):
        for cap in (1, 4):
            kw = dict(do_rc=do_rc, bad_ix=MISS, num_labels=index.num_labels, cap=cap)
            j = jl.search_step_hist(jt, reads, lens, k=64, probe_iters=1, **kw)
            t = tl.search_step_hist(tt, torch.from_numpy(reads), torch.from_numpy(lens),
                                    **kw)
            assert t.shape == (96, 2 * cap + 2) and np.array_equal(np.asarray(j), _np(t))
    assert (_np(t)[:, 2 * cap + 1] > 0).sum() > 30  # reads with hits


def _run_both(env, tmp_path, reads, *, ixb=4, mode="auto", do_rc=True, hist_cap=8,
              threshold=None, port_hook=None):
    """The JAX pipeline's bytes (cached) and the port's, on one table."""
    key = (reads, ixb, mode, do_rc, hist_cap, threshold)
    index = env[ixb]
    if key not in env["golden"]:
        jp = JaxPipeline(index, do_rc=do_rc, batch_size=BATCH, hist_cap=hist_cap,
                         lookup_mode=mode)
        if threshold:
            jp.long_read_threshold, jp.long_chunk = threshold, SMALL_CHUNK
        out = env["dir"] / ("jax_%s_%d_%s_%s_%d_%s.txt" % key)
        jp.search_file(str(env["dir"] / reads), str(out))
        env["golden"][key] = (out.read_bytes(), tables_from_jax(jp._table),
                              jp.table_kind)
    want, table, kind = env["golden"][key]
    pipe = SearchPipeline(index, device="cpu", do_rc=do_rc, batch_size=BATCH,
                          hist_cap=hist_cap, lookup_mode=mode, _table=table)
    if threshold:
        pipe.long_read_threshold, pipe.long_chunk = threshold, SMALL_CHUNK
    assert pipe.table_kind == kind and pipe.layout == "unpacked"
    if port_hook:
        port_hook(pipe)
    out = tmp_path / "port.txt"
    pipe.search_file(str(env["dir"] / reads), str(out))
    return out.read_bytes(), want, pipe


@pytest.mark.parametrize("do_rc", [True, False], ids=["rc", "forward"])
@pytest.mark.parametrize("ixb", [4, 2], ids=["u32", "u16"])
@pytest.mark.parametrize("mode", ["auto", "displaced"])
def test_pipeline64_bytes_equal_jax(env, tmp_path, mode, ixb, do_rc):
    """`auto` is the 64-mer ladder below 80M records, `displaced` the 64-mer
    displaced table; both label widths read back the unpacked rows."""
    got, want, pipe = _run_both(env, tmp_path, "short.fa", ixb=ixb, mode=mode,
                                do_rc=do_rc)
    assert pipe.table_kind == ("canonical64" if mode == "auto" else "displaced64")
    assert got == want and want.count(b"\n") > 150


@pytest.mark.parametrize("mode", ["auto", "displaced"])
def test_pipeline64_overflow_replay(env, tmp_path, mode):
    """hist_cap=1: every read with 2+ labels overflows and is replayed on
    the host through search_host.lookup_words (104-bit suffixes)."""
    seen = []

    def hook(pipe):
        orig = pipe._host_hits
        pipe._host_hits = lambda seq: seen.append(seq) or orig(seq)

    got, want, _ = _run_both(env, tmp_path, "short.fa", mode=mode, hist_cap=1,
                             port_hook=hook)
    assert got == want and len(seen) > 20


@pytest.mark.parametrize("threshold", [SMALL_THRESHOLD, None], ids=["small", "real"])
def test_pipeline64_long_reads(env, tmp_path, threshold):
    """Long reads at k=64: chunks go to the histogram step as ASCII rows of
    chunk + 63 bases, merge on the host and take one vote; at the small
    threshold each read takes several chunks, at the real one (16,384 bp)
    only the 20 kbp read is long."""
    got, want, _ = _run_both(env, tmp_path, "long.fa", hist_cap=2, threshold=threshold)
    assert got == want
    assert any(ln.startswith(b"big\t") for ln in want.splitlines())
    if threshold:
        assert sum(ln.startswith(b"long") for ln in want.splitlines()) == 3


def test_pipeline64_resume(env, tmp_path):
    """A run that dies after two batches resumes to the uninterrupted bytes."""
    want = _run_both(env, tmp_path, "short.fa")[1]
    table = env["golden"][("short.fa", 4, "auto", True, 8, None)][1]
    pipe = SearchPipeline(env[4], device="cpu", do_rc=True, batch_size=BATCH,
                          _table=table)

    class Stop(Exception):
        pass

    orig, calls = pipe._vote_unpacked, []

    def bomb(*a):
        if len(calls) == 2:
            raise Stop()
        calls.append(1)
        return orig(*a)

    pipe._vote_unpacked = bomb
    part = tmp_path / "part.txt"
    with pytest.raises(Stop):
        pipe.search_file(str(env["dir"] / "short.fa"), str(part))
    assert 0 < part.stat().st_size < len(want)
    pipe._vote_unpacked = orig
    pipe.search_file(str(env["dir"] / "short.fa"), str(part), resume=True)
    assert part.read_bytes() == want


def test_own_tables_equal_jax_tables(env):
    """Without _table the port places the same 64-mer tables as the JAX
    pipeline, under `auto` and `displaced`."""
    for mode, key in (("auto", "c64_1"), ("displaced", "d64_1")):
        want = tables_from_jax(JaxPipeline(env[4], lookup_mode=mode)._table)
        got = SearchPipeline(env[4], device="cpu", lookup_mode=mode)._table
        assert sorted(got) == sorted(want) and key in got
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_table_choice64_matches_jax(env, monkeypatch):
    """The PACKSIZE=64 table choice: the displaced table from the crossover,
    an explicit mode the 64-mer path lacks raises ValueError, a displaced
    table that cannot be built is an error only when asked for, and a DB
    that fits no ladder raises RuntimeError; in both pipelines alike."""
    import utree_tpu.hash_index64 as H
    import utree_tpu_torch.pipeline as P

    index = env[4]
    monkeypatch.setattr(P, "_DISPLACED_AUTO_MIN", 0)
    assert SearchPipeline(index, device="cpu").table_kind == "displaced64"
    monkeypatch.setattr(P, "_DISPLACED_AUTO_MIN", 80_000_000)
    for mode in ("bsearch", "hash", "routed"):
        with pytest.raises(ValueError, match="unsupported for PACKSIZE=64"):
            SearchPipeline(index, device="cpu", lookup_mode=mode)

    def no_fit(*a, **k):
        raise ValueError("no geometry fits")

    monkeypatch.setattr(H, "build_displaced_index64", no_fit)
    for make in (lambda **kw: JaxPipeline(index, **kw),
                 lambda **kw: SearchPipeline(index, device="cpu", **kw)):
        with pytest.raises(RuntimeError, match="displaced cannot be honored"):
            make(lookup_mode="displaced")
    monkeypatch.setattr(H, "build_canonical_hash_index64", no_fit)
    for make in (lambda **kw: JaxPipeline(index, **kw),
                 lambda **kw: SearchPipeline(index, device="cpu", **kw)):
        with pytest.raises(RuntimeError, match="needs the canonical hash table"):
            make()


def test_lowest_bin_fault_matches_jax(tmp_path):
    """The three-record DB whose lowest prefix bin holds one record that
    sorts after the next bin's first record: the reference folds it into the
    next bin, and the shared 64-mer builders' slow path for that unsorted
    bin raises OverflowError today (ROADMAP §C).  Both pipelines must fail
    alike.  Once the shared module is fixed, both build their tables and
    this test compares their bytes instead."""
    w = np.zeros(3, W128)
    w["hi"] = [0xFF00000000, (1 << 40) | 0x10, (1 << 40) | 0x20]
    cfg = UTreeConfig(packsize=64, ixtype_bytes=4)
    index = DeviceIndexArrays.from_build(w, np.arange(3), [b"a", b"b", b"c"], cfg)
    try:
        jp = JaxPipeline(index, do_rc=True, batch_size=BATCH)
    except Exception as e:  # the fault: the port must raise the same type
        with pytest.raises(type(e)):
            SearchPipeline(index, device="cpu", do_rc=True, batch_size=BATCH)
        return
    reads = tmp_path / "r.fa"
    reads.write_bytes(b">r\n" + b"A" * 24 + b"C" * 6 + b"T" * 40 + b"\n")
    jp.search_file(str(reads), str(tmp_path / "j.txt"))
    SearchPipeline(index, device="cpu", do_rc=True, batch_size=BATCH).search_file(
        str(reads), str(tmp_path / "t.txt"))
    assert (tmp_path / "j.txt").read_bytes() == (tmp_path / "t.txt").read_bytes()
