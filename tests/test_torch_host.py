"""The port's own copies of the host code against the JAX package's.

The port imports nothing of utree_tpu: it keeps copies of the host modules
it needs (config, formats, index, encode, classify, search_host,
classify_device.build_aufbau_tables, the numpy table placement of
hash_index and hash_index64).  Each copy takes the same seeded inputs as
its original here and must give the same arrays and bytes exactly.  The
last test reads every file of the port (and chip_smoke.py and the GPU
tests, which run where JAX is absent) and fails on an import of utree_tpu,
bench or jax."""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest

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
