"""The port's own copies of the host code against the JAX package's.

The port imports nothing of utree_tpu: it keeps copies of the host modules
it needs (config, formats, index, encode, classify, search_host,
classify_device.build_aufbau_tables, the table placement of hash_index
and hash_index64, whose ladder runs as tensor code on the CPU here).
Each copy takes the same seeded inputs as its original here and must give
the same arrays and bytes exactly.  The last test reads every file of the
port (and chip_smoke.py and the GPU tests, which run where JAX is absent)
and fails on an import of utree_tpu, bench or jax."""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import utree_tpu.classify as j_classify
import utree_tpu.classify_device as j_classify_device
import utree_tpu.encode as j_encode
import utree_tpu.formats as j_formats
import utree_tpu.hash_index as j_hash
import utree_tpu.hash_index64 as j_hash64
import utree_tpu.search_host as j_search_host
import utree_tpu_torch.classify as t_classify
import utree_tpu_torch.classify_device as t_classify_device
import utree_tpu_torch.encode as t_encode
import utree_tpu_torch.formats as t_formats
import utree_tpu_torch.hash_index as t_hash
import utree_tpu_torch.hash_index64 as t_hash64
import utree_tpu_torch.search_host as t_search_host
from test_classify_device import _random_strings
from utree_tpu.build import build_database
from utree_tpu.config import UTreeConfig
from utree_tpu.index import DeviceIndexArrays as JaxIndex
from utree_tpu.testdata import make_toy_db, make_toy_reads
from utree_tpu_torch.convert import index_from_jax
from utree_tpu_torch.index import DeviceIndexArrays as PortIndex
from utree_tpu_torch.utils import trace

REPO = pathlib.Path(__file__).resolve().parent.parent
# name -> (config, toy DB seed, refs, ref length, labels padded to)
DBS = {
    "k32": (UTreeConfig(), 71, 10, 5000, 0),
    "k32-u32": (UTreeConfig(ixtype_bytes=4), 71, 10, 5000, 70_000),
    "k64-u32": (UTreeConfig(packsize=64, ixtype_bytes=4), 53, 8, 3000, 0),
    "k64-u16": (UTreeConfig(packsize=64), 53, 8, 3000, 0),
}


def _equal(a, b) -> bool:
    """Field-by-field equality of two of the packages' objects (dataclasses
    of the same field names): arrays by dtype and value, everything else by
    ==."""
    if dataclasses.is_dataclass(a):
        return ([f.name for f in dataclasses.fields(a)]
                == [f.name for f in dataclasses.fields(b)]
                and all(_equal(getattr(a, f.name), getattr(b, f.name))
                        for f in dataclasses.fields(a)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b))
    return a == b


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """Each DB of DBS built once: its words, ids and labels, its .ctr file,
    a reads file with chimeras (2+ labels a read, for the per-rank
    SUPPORT;RANGE columns) and the JAX index."""
    wd = tmp_path_factory.mktemp("host")
    out = {}
    for name, (cfg, seed, n_refs, ref_len, pad) in DBS.items():
        d = wd / name
        d.mkdir()
        recs = make_toy_db(str(d / "refs.fa"), str(d / "tax.map"), seed=seed,
                           num_refs=n_refs, ref_len=ref_len)
        make_toy_reads(str(d / "reads.fa"), recs, num_reads=200, seed=seed + 1)
        rng = np.random.default_rng(seed + 2)
        with open(d / "reads.fa", "ab") as f:
            for i in range(30):
                parts = [recs[r][2][s:s + 70] for r in rng.choice(len(recs), 3)
                         for s in [int(rng.integers(0, ref_len - 70))]]
                f.write(b">chimera%d extra words\n" % i + b"".join(parts) + b"\n")
        res = build_database(str(d / "refs.fa"), str(d / "tax.map"), cfg)
        strings = list(res.labels.strings)
        strings += [b"pad%d" % i for i in range(pad - len(strings))]
        j_formats.write_ubt(str(d / "db.ubt"), res.words, res.ixs, strings, cfg)
        j_formats.write_ctr_from_ubt(str(d / "db.ubt"), str(d / "db.ctr"), cfg)
        out[name] = dict(dir=d, cfg=cfg, words=res.words, ixs=res.ixs,
                         strings=strings, ctr=str(d / "db.ctr"),
                         reads=str(d / "reads.fa"),
                         jax=JaxIndex.from_build(res.words, res.ixs, strings, cfg))
    return out


@pytest.mark.parametrize("name", list(DBS))
def test_read_ctr_and_sniff_config_equal_jax(dbs, name):
    db = dbs[name]
    assert _equal(t_formats.sniff_config(db["ctr"]), j_formats.sniff_config(db["ctr"]))
    got, want = t_formats.read_ctr(db["ctr"], db["cfg"]), j_formats.read_ctr(db["ctr"], db["cfg"])
    assert _equal(got, want) and len(got.labels) == len(db["strings"])
    assert _equal(t_formats.compute_bin_ix(db["words"], db["cfg"].word_bits),
                  j_formats.compute_bin_ix(db["words"], db["cfg"].word_bits))


@pytest.mark.parametrize("name", list(DBS))
def test_index_equals_jax(dbs, name):
    """from_build, from_ctr and index_from_jax give the JAX index's fields,
    the IXTYPE=u32 sentinel record's -1 included."""
    db = dbs[name]
    port = PortIndex.from_build(db["words"], db["ixs"], db["strings"], db["cfg"])
    assert _equal(port, db["jax"]) and _equal(index_from_jax(db["jax"]), db["jax"])
    assert _equal(PortIndex.from_ctr(db["ctr"], db["cfg"]),
                  JaxIndex.from_ctr(db["ctr"], db["cfg"]))
    if db["cfg"].packsize == 32:
        assert int(port.ix[-1]) == (-1 if db["cfg"].ixtype_bytes == 4 else 0xFFFF)
    assert _equal(port.host_index(), db["jax"].host_index())


def test_sentinel_without_wrapping():
    """The u32 sentinel is built as its int32 bits, so it needs no NumPy
    that wraps 2^32-1 into an int32 (the JAX package's np.full does)."""
    cfg = UTreeConfig(ixtype_bytes=4)
    words = np.array([5, 1 << 40, 3 << 41], np.uint64)
    with np.errstate(all="raise"):
        index = PortIndex.from_build(words, np.arange(3), [b"a", b"b", b"c"], cfg)
    assert index.ix.dtype == np.int32 and list(index.ix) == [0, 1, 2, -1]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_build_aufbau_tables_equal_jax(seed):
    rng = np.random.default_rng(seed)
    strings = _random_strings(rng, int(rng.integers(5, 120)))
    assert _equal(t_classify_device.build_aufbau_tables(strings),
                  j_classify_device.build_aufbau_tables(strings))


# the four table builders, narrow and wide labels (k=32) or u32 and u16
# label ids (k=64)
BUILDERS = [("build_canonical_hash_index", "k32"),
            ("build_canonical_hash_index", "k32-u32"),
            ("build_displaced_index", "k32"),
            ("build_displaced_index", "k32-u32"),
            ("build_canonical_hash_index64", "k64-u32"),
            ("build_canonical_hash_index64", "k64-u16"),
            ("build_displaced_index64", "k64-u32"),
            ("build_displaced_index64", "k64-u16")]


@pytest.mark.parametrize("builder,name", BUILDERS)
def test_table_builders_equal_jax(dbs, builder, name):
    jmod, tmod = (j_hash64, t_hash64) if builder.endswith("64") else (j_hash, t_hash)
    db = dbs[name]
    want = getattr(jmod, builder)(db["jax"])
    got = getattr(tmod, builder)(index_from_jax(db["jax"]))
    assert _equal(got, want)
    assert getattr(got, "wide", name == "k32-u32") == (name == "k32-u32")


def test_spilled_tables_equal_jax(dbs):
    """Overloaded geometries that spill: the displaced table's cached tail
    and its respill, and the ladder's three-level chain."""
    jx, port = dbs["k32"]["jax"], index_from_jax(dbs["k32"]["jax"])
    kw = dict(load=0.98, spill_budget=jx.num_records)
    want, got = j_hash.build_displaced_index(jx, **kw), t_hash.build_displaced_index(port, **kw)
    assert _equal(got, want) and got.t3.shape[0] > 8
    assert _equal(t_hash.respill_displaced_t3(got.t3, got.wide),
                  j_hash.respill_displaced_t3(want.t3, want.wide))
    chain = (4, 4.0, 2, 1 << 27)
    want = j_hash._place_canonical(*j_hash._canonical_groups(jx), *chain, slots3=16)
    got = t_hash._place_canonical(*t_hash._canonical_groups(port), *chain, slots3=16)
    assert _equal(got, want) and got.t3.shape[0] > 8


@pytest.mark.parametrize("refused", [1, 2], ids=["tier-a", "tiers-a-b"])
@pytest.mark.parametrize("name", ["k32", "k32-u32"])
def test_refused_tiers_equal_jax(dbs, monkeypatch, name, refused):
    """The ladder with its first tier (or its first two) refused by budgets
    pinned low in both packages: the tier kept, array for array, and one
    `table.attempts` a tier tried."""
    pins = {"_CANON_T1_CAP": 1 << 12, "_CANON_T2_BUDGET": 12 * 16}
    if refused == 2:
        pins.update(_T3_ENTRY_BUDGET=0, _T2_BYTE_CAP=1 << 12)
    for mod in (j_hash, t_hash):
        for k, v in pins.items():
            monkeypatch.setattr(mod, k, v)
    jx = dbs[name]["jax"]
    want = j_hash.build_canonical_hash_index(jx)
    with trace.scope() as rec:
        got = t_hash.build_canonical_hash_index(index_from_jax(jx))
    assert _equal(got, want) and rec.counts["table.attempts"] == refused + 1
    assert (got.slots, got.slots2, got.slots3) == ((4, 2, 16) if refused == 1 else (4, 8, 1))
    assert got.t2.shape[0] > 8 and "table.place_device" not in rec.counts


def _edge_words(rng):
    """uint64 32-mers at the lanes' edges (0, all ones, the top bit alone or
    with the low bit, one 32-bit half all ones, alternating codes), 200
    palindromes (rc(w) == w) and 500 random words with the top bit set.
    Returns (words, palindromes)."""
    edges = np.array([0, (1 << 64) - 1, 1 << 63, (1 << 63) | 1, 0xFFFFFFFF,
                      0xFFFFFFFF << 32, 0x5555555555555555, 0xAAAAAAAAAAAAAAAA], np.uint64)
    half = rng.integers(0, 1 << 32, 200, dtype=np.uint64)
    # rc of a word below 2^32 carries rev2(~h) in its high half
    pal = (j_hash._rc64(half) & np.uint64(0xFFFFFFFF00000000)) | half
    top = rng.integers(0, 1 << 63, 500, dtype=np.uint64) | np.uint64(1 << 63)
    return np.concatenate([edges, pal, top]), pal


def test_rc64_twin_equals_jax():
    """The port's reverse complement, from a uint64 array and from an int64
    tensor of the same bits, against the JAX package's."""
    words, pal = _edge_words(np.random.default_rng(8))
    want = j_hash._rc64(words)
    assert _equal(t_hash._rc64(words), want)
    got = t_hash._rc64(torch.from_numpy(words.view(np.int64)))
    assert got.dtype == torch.int64 and np.array_equal(got.numpy().view(np.uint64), want)
    assert np.array_equal(j_hash._rc64(pal), pal) and np.array_equal(t_hash._rc64(pal), pal)


@pytest.mark.parametrize("salt", [0, 0x6A09E667, 0x5BD1E995, 0x27D4EB2F])
def test_mix_twin_equals_numpy(salt):
    """The ladder's bucket mix on u32 lanes against `_mix_np`, lanes as
    `_canonical_groups` gives them (int32, negative included): every triple
    of edge values, then random lanes."""
    edges = np.array([0, 1, 0xFF, 0xFFFF, 0x10000, 0x7FFFFFFF, -0x80000000, -2, -1], np.int32)
    grid = [a.ravel() for a in np.meshgrid(edges, edges, edges, indexing="ij")]
    rng = np.random.default_rng(salt & 0xFFFF)
    rand = rng.integers(-(1 << 31), 1 << 31, (3, 4000)).astype(np.int32)
    pre, hi, lo = (np.concatenate([g, r]) for g, r in zip(grid, rand))
    want = j_hash._mix_np(pre, hi, lo ^ np.int64(salt))
    got = t_hash._salted_mix(*(torch.from_numpy(a) for a in (pre, hi, lo)), salt)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want.astype(np.int64))
    assert _equal(t_hash._mix_np(pre, hi, lo ^ np.int64(salt)), want)


@pytest.mark.parametrize("b", [1, 8, 1024, 1 << 20])
def test_group_pos_twin_equals_jax(b):
    """Group positions from a uint32 array (NumPy out) and from a u32-lane
    tensor (tensors out) against the JAX package's, edge hashes included."""
    rng = np.random.default_rng(b)
    h = np.concatenate([[0, 0xFFFFFFFF, 0xFFFFFFFF, 0x80000000],
                        rng.integers(0, 1 << 32, 5000)]).astype(np.uint32)
    want = j_hash._group_pos(h, b)
    got = t_hash._group_pos(h, b)
    assert all(_equal(g, w) for g, w in zip(got, want))
    got = t_hash._group_pos(torch.from_numpy(h.astype(np.int64)), b)
    assert all(g.dtype == torch.int64 and np.array_equal(g.numpy(), w)
               for g, w in zip(got, want))
    assert all(len(a) == 0 for a in t_hash._group_pos(np.zeros(0, np.uint32), b))


def _anomalous_bins(index) -> int:
    """Populated bins whose record range is not strictly increasing by
    suffix: those `_reference_hits` replays probe by probe."""
    n = index.num_records
    s = (index.suf_hi[:n].astype(np.uint64) << np.uint64(32)) | index.suf_lo[:n].view(np.uint32)
    starts, ends = index.bin_ix[:-1].astype(np.int64), index.bin_ix[1:].astype(np.int64)
    return sum(bool(np.any(s[a + 1:b] <= s[a:b - 1]))
               for a, b in zip(starts[ends > starts + 1], ends[ends > starts + 1]))


def _fold_cases():
    from test_torch_hash import CASES

    words, pal = _edge_words(np.random.default_rng(9))
    words = np.unique(np.concatenate([words, j_hash._rc64(words[:300])]))
    # one word alone in prefix bin 0 with the largest suffix: the next
    # populated bin's range takes it in and is no longer sorted (as
    # tests/test_torch_lookup.py's _abnormal_index)
    rng = np.random.default_rng(21)
    merged = np.concatenate([[np.uint64(0xFFFFFFFFFF)],
                             np.unique(rng.integers(1 << 40, 1 << 46, 4000, dtype=np.uint64))])
    cases = {k: CASES[k] for k in ("singleton-first-bin", "contaminated-bin0", "u32")}
    cases["merged-unsorted-bin"] = lambda: (merged, np.arange(len(merged)) % 30, 30,
                                            UTreeConfig(), None)
    cases["edges-and-palindromes"] = lambda: (words, np.arange(len(words)) % 11, 11,
                                              UTreeConfig(), None)
    return cases


@pytest.mark.parametrize("case", ["singleton-first-bin", "contaminated-bin0",
                                  "merged-unsorted-bin", "u32", "edges-and-palindromes"])
def test_canonical_fold_equals_jax(case):
    """`_canonical_groups` (NumPy out, and int32 tensors out) against the
    JAX package's, on DBs with anomalous bins (the compressor's quirks),
    wide labels, words with the top bit set, w and rc(w) under different
    labels, and palindromes."""
    words, ixs, nlab, cfg, _ = _fold_cases()[case]()
    jx = JaxIndex.from_build(words, np.asarray(ixs, np.int64),
                             [b"l%d" % i for i in range(nlab)], cfg)
    if case == "merged-unsorted-bin":
        assert _anomalous_bins(jx) > 0
    want = j_hash._canonical_groups(jx)
    got = t_hash._canonical_groups(index_from_jax(jx))
    assert len(got) == len(want) and all(_equal(g, w) for g, w in zip(got, want))
    tens = t_hash._canonical_groups(index_from_jax(jx), "cpu")
    assert tens[-1] == want[-1] and all(
        t.dtype == torch.int32 and np.array_equal(t.numpy(), w)
        for t, w in zip(tens[:-1], want[:-1]))


@pytest.mark.parametrize("support_ranges", [1, 8])
def test_aufbau_vote_counts_equal_jax(support_ranges):
    """Random histograms over taxonomy-shaped strings: the GG vote's line,
    one SUPPORT;RANGE pair or eight."""
    rng = np.random.default_rng(support_ranges)
    strings = _random_strings(rng, 60)
    lines = 0
    for r in range(600):
        k = int(rng.integers(1, 9))
        uniq = np.sort(rng.choice(len(strings), k, replace=False))
        counts = rng.integers(1, 20, k)
        want = j_classify.aufbau_vote_counts(b"r%d" % r, uniq, counts, strings, 4,
                                             support_ranges)
        assert t_classify.aufbau_vote_counts(b"r%d" % r, uniq, counts, strings, 4,
                                             support_ranges) == want
        hits = np.repeat(uniq, counts)
        assert t_classify.aufbau_vote(b"r", hits, strings, 4, support_ranges) == \
            j_classify.aufbau_vote(b"r", hits, strings, 4, support_ranges)
        lines += want.count(b"\t") == (11 if support_ranges == 8 and k > 1 else 4)
    assert lines > 300


@pytest.mark.parametrize("k", [32, 64])
@pytest.mark.parametrize("do_rc", [True, False], ids=["rc", "forward"])
def test_window_words_equal_jax(k, do_rc):
    rng = np.random.default_rng(k)
    for _ in range(50):
        seq = bytes(rng.choice(list(b"ACGTacgtN"), int(rng.integers(0, 300))))
        got = t_encode.search_window_words(seq, k, do_rc)
        assert _equal(got, j_encode.search_window_words(seq, k, do_rc))
        assert _equal(t_encode.sample_build_kmers(seq, k, 1),
                      j_encode.sample_build_kmers(seq, k, 1))
    assert t_encode.revcomp_text(b"ACGTNacgt") == j_encode.revcomp_text(b"ACGTNacgt")


@pytest.mark.parametrize("name", ["k32", "k64-u32"])
@pytest.mark.parametrize("support_ranges", [1, 8])
@pytest.mark.parametrize("do_rc", [True, False], ids=["rc", "forward"])
def test_host_search_file_equal_jax(dbs, tmp_path, name, support_ranges, do_rc):
    """search_host.search_file, the port's oracle: the JAX package's bytes."""
    db = dbs[name]
    outs = []
    for mod in (j_search_host, t_search_host):
        idx = mod.HostIndex.from_ctr(db["ctr"], db["cfg"])
        out = tmp_path / f"{mod.__name__}.txt"
        assert mod.search_file(idx, db["reads"], str(out), do_rc=do_rc,
                               support_ranges=support_ranges) == 230
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and outs[0].count(b"\n") > 100
    if support_ranges == 8:
        assert b"\tchimera" not in outs[0] and outs[0].count(b"chimera") > 10
        assert max(ln.count(b"\t") for ln in outs[0].splitlines()) == 11


# every file that runs where JAX may be absent
_NO_JAX_FILES = sorted(str(p.relative_to(REPO))
                       for p in (REPO / "utree_tpu_torch").rglob("*.py")) + [
    "chip_smoke.py", "kernel_ab.py", "tests/test_torch_kernels.py"]
_REFUSED = ("utree_tpu", "bench", "jax")


@pytest.mark.parametrize("path", _NO_JAX_FILES)
def test_file_imports_nothing_of_jax(path):
    """No import of utree_tpu (or a submodule), bench or jax, anywhere in
    the file, at any depth."""
    tree = ast.parse((REPO / path).read_text(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    bad = [n for n in names if n.split(".")[0] in _REFUSED]
    assert not bad, f"{path} imports {bad}"
