"""The rank-specific (non-GG) search of the port against the JAX package, on
the CPU: `search_host.search_file_shallow` and its parts (the literal word
state machine `scan_shallow_literal`, its batched twin `scan_shallow_fast`,
the C++ `native.shallow_*` built from `csrc/host/shallow.cpp`, the stateful
`classify.ShallowVoter`) and `search --rank-specific` in the CLI.  Bytes and
hits must be equal (tolerance 0).  Databases come from make_toy_db ->
build_database(do_gg=False) -> write_ubt/write_ctr_from_ubt, read by both
packages' `HostIndex.from_ctr`; never the C oracle."""

import dataclasses
import gzip

import numpy as np
import pytest

import utree_tpu.classify as j_classify
import utree_tpu.native as j_native
import utree_tpu.search_host as j_search_host
import utree_tpu_torch.classify as t_classify
import utree_tpu_torch.native as t_native
import utree_tpu_torch.search_host as t_search_host
from utree_tpu.build import build_database
from utree_tpu.config import UTreeConfig
from utree_tpu.formats import write_ctr_from_ubt, write_ubt
from utree_tpu.testdata import make_toy_db, make_toy_reads
from utree_tpu_torch.encode import encode_bases, revcomp_text
from utree_tpu_torch.io.fasta import iter_fasta_records

SPARSITIES = (1, 2, 4, 8)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A non-GG DB (do_gg=False, as `build --rank-specific` makes it), its
    reads, the same reads gzipped (which the native whole-file scanner
    refuses as not linearized FASTA, and the Python reader takes), and the
    reads the scan tests take: N-spliced ones, short ones and all-N ones."""
    wd = tmp_path_factory.mktemp("shallow")
    recs = make_toy_db(str(wd / "refs.fa"), str(wd / "tax.map"), seed=101, num_refs=10)
    make_toy_reads(str(wd / "reads.fa"), recs, num_reads=300, seed=103)
    cfg = UTreeConfig()
    res = build_database(str(wd / "refs.fa"), str(wd / "tax.map"), cfg, do_gg=False)
    write_ubt(str(wd / "db.ubt"), res.words, res.ixs, res.labels.strings, cfg)
    write_ctr_from_ubt(str(wd / "db.ubt"), str(wd / "db.ctr"), cfg)
    with gzip.open(wd / "reads.fa.gz", "wb") as f:
        f.write((wd / "reads.fa").read_bytes())
    seqs = [s for _, s in iter_fasta_records(str(wd / "reads.fa"))][:100]
    seqs += [r[:40] + b"N" + r[41:] for r in seqs[:20]]
    seqs += [b"", b"ACGT", b"N" * 40, seqs[0][:31], seqs[1][:32]]
    return {"dir": wd, "cfg": cfg, "ctr": str(wd / "db.ctr"), "seqs": seqs}


def _indexes(env, sparsity):
    cfg = dataclasses.replace(env["cfg"], sparsity=sparsity)
    return (j_search_host.HostIndex.from_ctr(env["ctr"], cfg),
            t_search_host.HostIndex.from_ctr(env["ctr"], cfg))


@pytest.mark.parametrize("do_rc", [True, False], ids=["rc", "forward"])
@pytest.mark.parametrize("sparsity", SPARSITIES)
def test_search_file_shallow_equals_jax(env, tmp_path, sparsity, do_rc):
    """The whole-file native path on linearized FASTA, and the Python-driven
    batches (native scan, ShallowVoter) on the gzipped file with a chunk of
    7 reads, so the vote's phantom slot crosses batch boundaries: each gives
    the JAX package's bytes, and the two give the same bytes."""
    j_idx, t_idx = _indexes(env, sparsity)
    outs = {}
    for reads, chunk in (("reads.fa", 4096), ("reads.fa.gz", 7)):
        for tag, mod, idx in (("jax", j_search_host, j_idx), ("port", t_search_host, t_idx)):
            out = tmp_path / f"{tag}_{reads}.txt"
            n = mod.search_file_shallow(idx, str(env["dir"] / reads), str(out),
                                        do_rc=do_rc, chunk=chunk)
            assert n == 300
            outs[tag, reads] = out.read_bytes()
        assert outs["port", reads] == outs["jax", reads]
    assert outs["port", "reads.fa.gz"] == outs["port", "reads.fa"]
    assert outs["port", "reads.fa"].count(b"\n") > 100


@pytest.mark.parametrize("do_rc", [True, False], ids=["rc", "forward"])
def test_native_batches_keep_the_phantom_slot(env, tmp_path, do_rc):
    """shallow_classify_file in batches of 5 reads: the vote buffer is
    zeroed once a file, so the bytes equal one batch's, and JAX's."""
    j_idx, t_idx = _indexes(env, 2)
    reads = str(env["dir"] / "reads.fa")
    outs = []
    for mod, idx, chunk in ((j_native, j_idx, 5), (t_native, t_idx, 5),
                            (t_native, t_idx, 1 << 16)):
        out = tmp_path / f"o{len(outs)}.txt"
        assert mod.shallow_classify_file(idx, reads, str(out), do_rc, chunk=chunk) == 300
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] == outs[2] and outs[0].count(b"\n") > 100


@pytest.mark.parametrize("sparsity", SPARSITIES)
def test_scans_equal_the_literal_replay(env, sparsity):
    """scan_shallow_fast and the C++ shallow_scan_batch equal the literal
    word state machine hit for hit (N-spliced, short and all-N reads
    included, both strands), which equals JAX's; the skip-after-hit
    over-shift path is taken."""
    j_idx, t_idx = _indexes(env, sparsity)
    seqs = env["seqs"]
    multi = 0
    for rc in (False, True):
        want = [t_search_host.scan_shallow_literal(t_idx, r, rc) for r in seqs]
        assert want == [j_search_host.scan_shallow_literal(j_idx, r, rc) for r in seqs]
        assert [t_search_host.scan_shallow_fast(t_idx, r, rc) for r in seqs] == want
        ext = [encode_bases(r + b"N" + revcomp_text(r) if rc else r) for r in seqs]
        assert t_native.shallow_scan_batch(t_idx, ext) == want
        multi += sum(len(h) > 1 for h in want)
    assert multi > 50


def test_shallow_voter_and_subsample_equal_jax():
    """The stateful vote over one voter for a run of reads (the phantom
    slot carries the previous reads' hits), and the skip-after-hit
    subsampling, on random hits."""
    rng = np.random.default_rng(7)
    strings = [b"k__a;p__%d" % i for i in range(12)]
    jv, tv = j_classify.ShallowVoter(strings), t_classify.ShallowVoter(strings)
    lines = 0
    for r in range(400):
        hits = rng.integers(0, 12, int(rng.integers(0, 9))).tolist()
        want = jv.vote(b"r%d" % r, hits)
        assert tv.vote(b"r%d" % r, hits) == want
        lines += want is not None
        starts = np.sort(rng.choice(200, 40, replace=False))
        ixs = rng.integers(0, 20, 40)
        for sparsity in SPARSITIES:
            assert (t_classify.subsample_hits(starts, ixs, 12, 32, sparsity)
                    == j_classify.subsample_hits(starts, ixs, 12, 32, sparsity))
    assert tv.buffer == jv.buffer and 50 < lines < 400


@pytest.mark.parametrize("do_rc", [True, False], ids=["rc", "forward"])
def test_cli_rank_specific_equals_jax(env, tmp_path, capsys, do_rc):
    """`search --rank-specific` in both CLIs: the same bytes."""
    from utree_tpu.cli import main as jax_main
    from utree_tpu_torch.cli import main

    outs = []
    for run in (jax_main, main):
        out = tmp_path / f"{len(outs)}.txt"
        run(["search", env["ctr"], str(env["dir"] / "reads.fa"), str(out),
             "--rank-specific", "--trace"] + (["--rc"] if do_rc else []))
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and outs[0].count(b"\n") > 100
    assert "on the host" in capsys.readouterr().out


def test_shallow_lib_raises_when_gxx_fails(env, monkeypatch, tmp_path):
    """A g++ that fails makes shallow_lib, and so search_file_shallow,
    raise; utree_tpu returns None there and takes Python paths, the port
    has no fallback."""
    import subprocess

    def failing_run(cmd, **kw):
        return subprocess.CompletedProcess(cmd, 1, "", "g++: error: no compiler")

    _, t_idx = _indexes(env, 4)
    monkeypatch.setattr(t_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(t_native.subprocess, "run", failing_run)
    t_native.shallow_lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ could not build .*shallow.cpp"):
            t_native.shallow_lib()
        with pytest.raises(RuntimeError, match="no compiler"):
            t_search_host.search_file_shallow(t_idx, str(env["dir"] / "reads.fa"),
                                              str(tmp_path / "o.txt"))
    finally:
        t_native.shallow_lib.cache_clear()
