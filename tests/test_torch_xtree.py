"""xtree BUILD and ALIGN of the port against the JAX package, on the CPU.

The port's copies (`utree_tpu_torch.xtree.{build,io,align}`, the C++ engine
`csrc/host/xtree.cpp`) and its device front end (`xtree.device`: the plain
version of kernel K9 here, the kernel itself on a GPU in
tests/test_torch_kernels.py) take the same seeded inputs as
`utree_tpu.xtree` and must give the same arrays and bytes exactly
(tolerance 0: every output is an integer or a byte).  Databases come from
`make_toy_db` + `build_xtree_db`, never from the C oracle."""

import dataclasses
import gzip
import importlib
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import utree_tpu.xtree.build as j_build
import utree_tpu.xtree.device as j_device
import utree_tpu.xtree.io as j_io
import utree_tpu_torch.xtree.build as t_build
import utree_tpu_torch.xtree.device as t_device
import utree_tpu_torch.xtree.io as t_io
from utree_tpu.pipeline import _bucket_len64
from utree_tpu.testdata import make_toy_db, make_toy_reads
from utree_tpu.xtree.align import AlignOptions as JOpts
from utree_tpu.xtree.align import XtreeAligner as JAligner
from utree_tpu_torch.convert import tables_from_jax, xtree_db_from_jax
from utree_tpu_torch.xtree.align import AlignOptions as TOpts
from utree_tpu_torch.xtree.align import XtreeAligner as TAligner

REPO = pathlib.Path(__file__).resolve().parent.parent
OUTS = ("perq", "ref", "tax", "cov")


def _func_map(src: pathlib.Path, dst: pathlib.Path, mod: int) -> None:
    """A 3-column map: the toy map's lineages, then func__<i % mod>."""
    rows = [ln.split(b"\t") for ln in src.read_bytes().split(b"\n") if ln]
    with open(dst, "wb") as f:
        for i, (k, v) in enumerate(rows):
            f.write(k + b"\t" + v + b"\tfunc__" + str(i % mod).encode() + b"\n")


def _rc(seq: bytes) -> bytes:
    return seq[::-1].translate(bytes.maketrans(b"ACGT", b"TGCA"))


@pytest.fixture(scope="module")
def xdata(tmp_path_factory):
    """The toy refs of tests/test_xtree.py's batch-engine test, plus one
    reference line of 28 bp reverse-complement palindromes (whose centres are
    palindromes at every even k) and reads over them."""
    wd = tmp_path_factory.mktemp("xtorch")
    recs = make_toy_db(str(wd / "refs.fa"), str(wd / "tax.map"), num_refs=12,
                       ref_len=2500, seed=61, num_lineages=2)
    make_toy_reads(str(wd / "reads.fa"), recs, num_reads=700, read_len=100,
                   seed=71, mutate_prob=0.08, random_frac=0.15)
    rng = np.random.default_rng(5)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    pals = []
    for _ in range(40):
        half = rng.choice(acgt, 14).tobytes()
        pals.append(half + _rc(half) + rng.choice(acgt, 9).tobytes())
    pal_line = b"".join(pals)
    with open(wd / "refs.fa", "ab") as f:
        f.write(b">palref\n" + pal_line + b"\n")
    with open(wd / "tax.map", "ab") as f:
        f.write(b"palref\t" + recs[0][1] + b"\n")
    with open(wd / "reads.fa", "ab") as f:
        for i in range(20):
            s = int(rng.integers(0, len(pal_line) - 90))
            f.write(b">palread%d\n" % i + pal_line[s:s + 90] + b"\n")
    _func_map(wd / "tax.map", wd / "tax3.map", 4)
    return wd


def _queries(wd: pathlib.Path) -> list[bytes]:
    """The reads plus adversarial queries: N runs, shorter than k, empty,
    all-A, lower case, and two longer than 64 bytes (one stitched over an
    N), so the batch width buckets to 128."""
    seqs = [s for _, s in j_io.iter_queries(str(wd / "reads.fa"))]
    return seqs + [b"ACGTN" * 30, b"ACG", b"", b"A" * 64, seqs[0].lower(),
                   seqs[0] + b"N" + seqs[1], seqs[2] + seqs[3]]


def _batch(seqs: list[bytes], pad: int):
    """(B, T) ASCII matrix and lengths as `_batch_hits_device` packs them,
    with `pad` zero rows of length 0 after the queries."""
    t = _bucket_len64(max(len(s) for s in seqs))
    reads = np.zeros((len(seqs) + pad, t), np.uint8)
    lens = np.zeros(len(seqs) + pad, np.int32)
    for i, s in enumerate(seqs):
        reads[i, :len(s)] = np.frombuffer(s, np.uint8)
        lens[i] = len(s)
    return reads, lens


# ---- BUILD ---------------------------------------------------------------

@pytest.mark.parametrize("comp", [0, 2])
def test_xtr_bytes_equal_jax(xdata, tmp_path, comp):
    """build_xtree_db + write_xtr write JAX's bytes (the 2^26+1 bin offsets
    make each file 512 MB); read_xtr round-trips; the build logs are equal;
    xtree_db_from_jax copies every field."""
    args = (str(xdata / "refs.fa"), str(xdata / "tax3.map"))
    jdb = j_build.build_xtree_db(*args, k=29, comp=comp)
    tdb = t_build.build_xtree_db(*args, k=29, comp=comp)
    assert jdb.num_kmers > (10_000 if comp == 0 else 1000)
    assert len(jdb.h_strings[1]) == 4
    conv = xtree_db_from_jax(jdb)
    for f in dataclasses.fields(jdb):
        a, b = getattr(jdb, f.name), getattr(conv, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        elif f.name == "h_pairs":
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        else:
            assert a == b, f.name
    files = [tmp_path / n for n in ("j.xtr", "t.xtr", "back.xtr")]
    try:
        j_build.write_xtr(jdb, str(files[0]))
        t_build.write_xtr(tdb, str(files[1]))
        want = files[0].read_bytes()
        assert files[1].read_bytes() == want
        t_build.write_xtr(t_build.read_xtr(str(files[1])), str(files[2]))
        assert files[2].read_bytes() == want
    finally:
        for f in files:
            f.unlink(missing_ok=True)
    j_build.write_build_log(jdb, str(tmp_path / "j.log"))
    t_build.write_build_log(tdb, str(tmp_path / "t.log"))
    assert (tmp_path / "t.log").read_bytes() == (tmp_path / "j.log").read_bytes()


def test_iter_queries_equal_jax(xdata, tmp_path):
    """FASTA, and the same records as gz FASTQ: the same (name, seq) pairs."""
    fa = str(xdata / "reads.fa")
    recs = list(j_io.iter_queries(fa))
    assert list(t_io.iter_queries(fa)) == recs and len(recs) == 720
    fq = tmp_path / "reads.fq.gz"
    with gzip.open(fq, "wb") as f:
        for name, seq in recs:
            f.write(b"@" + name + b"\n" + seq + b"\n+\n" + b"I" * len(seq) + b"\n")
    assert list(t_io.iter_queries(str(fq))) == list(j_io.iter_queries(str(fq))) == recs


@pytest.mark.parametrize("name", ["fasta.cpp", "vote.cpp", "xtree.cpp", "shallow.cpp"])
def test_host_cpp_is_a_byte_copy(name):
    """The port's host C++ is the JAX package's, byte for byte."""
    port = REPO / "utree_tpu_torch" / "csrc" / "host" / name
    assert port.read_bytes() == (REPO / "native" / name).read_bytes()


# ---- the device front end ---------------------------------------------------

def _pods(db):
    """The aligner's (sfx, bins) of a DB: the sentinel pod appended
    (XtreeAligner.__init__), so both packages' indexes take one copy of the
    512 MB bin offsets."""
    pool_sz = sum(len(x) + 1 for x in db.ref_names)
    sfx = np.concatenate([db.sfx.astype(np.int64), [pool_sz & 0xFFFFFFFF]])
    return sfx, db.bin_offsets.astype(np.int64)


@pytest.mark.parametrize("k,past_len", [pytest.param(k, b"", id=str(k))
                                        for k in (14, 16, 20, 28, 29)]
                         + [pytest.param(29, b"ACGT", id="29-bases-past-len")])
def test_xtree_step_plain_equals_jax(xdata, k, past_len):
    """build_xtree_device_index places JAX's d1/ds/d3 element for element,
    and the plain version of K9 equals the jitted `xtree_device_step` on all
    four matrices, on JAX's tables and on the port's: k=14 and 16 take the
    s > 32 and s == 32 branches of `_rc_lanes_k`, the rest s < 32; sl = 1,
    3, 7, 15, 16 (`_prefix_of`'s b == 32 at 29); palindromes at even k; Ns,
    short, empty, lower-case and >64-byte queries and padding rows; and
    (past_len) every byte past a query's length an A, C, G or T, which both
    mask to code 0 and an invalid window, prefix bins included."""
    jdb = j_build.build_xtree_db(str(xdata / "refs.fa"), str(xdata / "tax3.map"),
                                 k=k, comp=0)
    sfx, bins = _pods(jdb)
    jidx = j_device.build_xtree_device_index(jdb, sfx, bins)
    tidx = t_device.build_xtree_device_index(xtree_db_from_jax(jdb), sfx, bins, "cpu")
    del jdb, sfx, bins
    jtab = tables_from_jax(jidx.tables)
    assert sorted(jtab) == sorted(tidx.tables) == ["d1", "d3", "ds"]
    for key, v in jtab.items():
        assert torch.equal(tidx.tables[key], v), key
    assert tidx.num_entries == jidx.num_entries > 1000
    reads, lens = _batch(_queries(xdata), pad=3)
    if past_len:
        past = np.arange(reads.shape[1])[None, :] >= lens[:, None]
        reads[past] = np.resize(np.frombuffer(past_len, np.uint8), int(past.sum()))
    want = [np.asarray(x) for x in j_device.make_device_step(jidx)(jidx.tables, reads, lens)]
    for tables in (tidx.tables, jtab):
        got = t_device.xtree_step(tables, torch.from_numpy(reads),
                                  torch.from_numpy(lens), k=k, sl=k - 13)
        assert len(got) == 4
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and np.array_equal(g.numpy(), w)
    sf, sr, pf, pr = want
    assert (sf >= 0).sum() > 5000 and (sr >= 0).any()  # reads are forward-strand
    assert (sf[-3:] == -1).all() and (sr[-3:] == -1).all()  # padding rows
    pal = (sf == sr) & (sf >= 0) & (pf == pr)
    assert pal.any() == (k % 2 == 0)


@pytest.fixture(scope="module")
def onepast(tmp_path_factory):
    """tests/test_xtree.py's one-past DB (seeds 307/1307), built with
    build_xtree_db: LBS_k hits one pod past the probed bin."""
    wd = tmp_path_factory.mktemp("onepast")
    recs = make_toy_db(str(wd / "refs.fa"), str(wd / "tax.map"), num_refs=9,
                       ref_len=2800, seed=307)
    make_toy_reads(str(wd / "reads.fa"), recs, num_reads=400, read_len=110,
                   seed=1307, mutate_prob=0.05)
    return wd


@pytest.mark.parametrize("data", ["toy", "onepast"])
def test_hits_equal_jax(xdata, onepast, data):
    """The port's `_batch_hits` (NumPy spec), its C++ scan and its front end
    on device="cpu" give JAX's `_batch_hits` triples; on the one-past DB
    its precondition holds (a seed at or past the probed bin's end)."""
    from utree_tpu_torch.native import xt_scan_hits

    wd = xdata if data == "toy" else onepast
    jdb = j_build.build_xtree_db(str(wd / "refs.fa"),
                                 str(wd / ("tax3.map" if data == "toy" else "tax.map")),
                                 k=29, comp=0)
    seqs = _queries(wd)
    ja = JAligner(jdb)
    want = ja._batch_hits(seqs)
    if data == "onepast":
        assert (want[2] >= ja.bins[want[1] + 1]).any(), "fixture no longer triggers one-past"
    del ja
    ta = TAligner(xtree_db_from_jax(jdb), device="cpu")
    off = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=off[1:])
    for got in (ta._batch_hits(seqs), ta._batch_hits_device(seqs),
                xt_scan_hits(ta._xt_lib, b"".join(seqs), off[:-1], off[1:], ta.k,
                             ta.pl, ta.bins, ta.sfx)):
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert len(want[0]) > 5000

    # the C++ tallies equal the NumPy spec twins (selected by _xt_lib = None)
    q = len(seqs)
    qid, pres, seeds = want
    hmaps = [None] + list(ta.lbins[0][:3])
    lib, ta._xt_lib = ta._xt_lib, None
    try:
        spec = ta._batch_ref_tally(qid, pres, seeds, q)
        hspec = [ta._batch_h_tally(qid, pres, seeds, ta.h_pairs[0], ta.n_uniq_h[0], q,
                                   lbin=lb) for lb in hmaps]
    finally:
        ta._xt_lib = lib
    nat = ta._batch_ref_tally_native(qid, pres, seeds, q)
    hnat = [ta._batch_h_tally(qid, pres, seeds, ta.h_pairs[0], ta.n_uniq_h[0], q,
                              lbin=lb) for lb in hmaps]
    assert all(np.array_equal(a, b) for a, b in zip(spec[:3], nat[:3]))
    for f in ("qu", "rxu", "counts", "first", "uniq"):
        assert np.array_equal(getattr(spec[3], f), getattr(nat[3], f)), f
    for a, b in zip(hspec, hnat):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


# ---- ALIGN end to end -----------------------------------------------------------

@pytest.fixture(scope="module")
def xdbs(xdata):
    """One k=29 DB for both packages (the port's a copy of JAX's)."""
    jdb = j_build.build_xtree_db(str(xdata / "refs.fa"), str(xdata / "tax3.map"),
                                 k=29, comp=0)
    return jdb, xtree_db_from_jax(jdb)


# each engine: (package, constructor argument); one is built at a time, as
# each holds its own 512 MB int64 copy of the bin offsets
_ENGINES = {"jax": ("jax", False), "jax-device": ("jax", True),
            "host": ("port", None), "cpu": ("port", "cpu")}


@pytest.mark.parametrize("conf,full_lca,redist", [
    (0.33, True, False),
    (0.95, True, True),   # high confidence forces the deep/aufbau paths
    (0.95, True, False),  # aufbau + the native formatting tail (lv>0 cuts)
    (0.95, False, False),  # shallow early-exit branch
    (0.0, True, True),     # ag_thres = 0 edge (loop runs to the level cap)
    (0.0, True, False),    # ag_thres = 0 through the fused native deep call
])
def test_align_bytes_equal_jax(xdata, xdbs, tmp_path, conf, full_lca, redist):
    """perq, ref, tax and cov of the port's host engine and plain front end
    equal JAX's host engine and device front end, byte for byte, on the
    grid of tests/test_xtree.py's batch-engine test, 97 queries a chunk
    (prime: ragged chunk boundaries); the port's literal replay
    (`align_file_scalar`) too where the run redistributes."""
    outs = {}
    for tag, (pkg, arg) in _ENGINES.items():
        if pkg == "jax":
            al, mk = JAligner(xdbs[0], use_device=arg), JOpts
        else:
            al, mk = TAligner(xdbs[1], device=arg), TOpts
        al.chunk_queries = 97
        runs = [(tag, al.align_file)]
        if redist and tag == "host":
            runs.append(("scalar", al.align_file_scalar))
        for name, fn in runs:
            fn(str(xdata / "reads.fa"), mk(
                confidence=conf, do_full_lca=full_lca, do_redist=redist,
                **{f"{o}_out": str(tmp_path / f"{name}.{o}") for o in OUTS}))
            outs[name] = [(tmp_path / f"{name}.{o}").read_bytes() for o in OUTS]
        del al
    for tag, got in outs.items():
        for o, g, w in zip(OUTS, got, outs["jax"]):
            assert g == w, (tag, o)
    assert outs["jax"][0].count(b"\n") == 720 and len(outs["jax"][3]) > 200


def test_cli_bytes_equal_jax(xdata, tmp_path):
    """`python -m utree_tpu_torch.cli xtree-build` and `xtree-align
    --device cpu` (and `--host`) write `utree_tpu.cli`'s bytes; without
    --device it asks for the card."""
    from utree_tpu.cli import main as jax_main

    from utree_tpu_torch.cli import main as port_main

    seqs, mp = str(xdata / "reads.fa"), str(xdata / "tax3.map")
    jx, tx = str(tmp_path / "j.xtr"), str(tmp_path / "t.xtr")
    jax_main(["xtree-build", "--seqs", str(xdata / "refs.fa"), "--map", mp,
              "--db-out", jx, "--comp", "1"])

    def port(*argv):
        subprocess.run([sys.executable, "-m", "utree_tpu_torch.cli", *argv],
                       cwd=REPO, check=True, capture_output=True)

    port("xtree-build", "--seqs", str(xdata / "refs.fa"), "--map", mp,
         "--db-out", tx, "--comp", "1")
    assert pathlib.Path(tx).read_bytes() == pathlib.Path(jx).read_bytes()

    def flags(tag):
        return [x for o in OUTS for x in (f"--{o}-out", str(tmp_path / f"{tag}.{o}"))]

    jax_main(["xtree-align", "--db", jx, "--seqs", seqs, "--confidence", "0.9",
              "--redistribute", *flags("j")])
    port("xtree-align", "--db", tx, "--seqs", seqs, "--confidence", "0.9",
         "--redistribute", "--device", "cpu", *flags("c"))
    port("xtree-align", "--db", tx, "--seqs", seqs, "--confidence", "0.9",
         "--redistribute", "--host", *flags("h"))
    for o in OUTS:
        want = (tmp_path / f"j.{o}").read_bytes()
        assert (tmp_path / f"c.{o}").read_bytes() == want, o
        assert (tmp_path / f"h.{o}").read_bytes() == want, o
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            port_main(["xtree-align", "--db", tx, "--seqs", seqs])


def test_no_silent_fallback(xdbs, monkeypatch, tmp_path):
    """device="cuda" without a card raises; with a card whose K9 build fails
    it raises that failure; nothing falls back to the CPU or the host."""
    # the module: the package exports its `build` function under that name
    kbuild = importlib.import_module("utree_tpu_torch.kernels.build")
    tdb = xdbs[1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            TAligner(tdb, device="cuda")

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(kbuild, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kbuild, "_nvcc", no_nvcc)
    kbuild.build.cache_clear()
    kbuild.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            TAligner(tdb, device="cuda")
    finally:
        kbuild.build.cache_clear()
        kbuild.library.cache_clear()
