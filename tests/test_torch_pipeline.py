"""The port's pipeline (utree_tpu_torch.pipeline) against utree_tpu's
displaced device-vote pipeline: classifications.txt byte for byte.

The DB comes from make_toy_db -> build_database -> DeviceIndexArrays.from_build
(no oracle), and both pipelines search the same table: the port receives the
JAX pipeline's `_table` through convert.tables_from_jax."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from utree_tpu.build import build_database
from utree_tpu.config import UTreeConfig
from utree_tpu.formats import write_ctr_from_ubt, write_ubt
from utree_tpu.index import DeviceIndexArrays
from utree_tpu.pipeline import SearchPipeline as JaxPipeline
from utree_tpu.testdata import make_toy_db, make_toy_reads
from utree_tpu_torch.convert import tables_from_jax
from utree_tpu_torch.pipeline import SearchPipeline

BATCH = 128
NREADS = 960


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    wd = tmp_path_factory.mktemp("torchdb")
    recs = make_toy_db(str(wd / "refs.fa"), str(wd / "tax.map"), seed=23,
                       num_refs=12)
    make_toy_reads(str(wd / "reads.fa"), recs, num_reads=900, seed=29)
    # chimeras of three refs: 3+ unique labels per read, so a small hist_cap
    # overflows and the host replay runs
    rng = np.random.default_rng(31)
    with open(wd / "reads.fa", "ab") as f:
        for i in range(60):
            refs = rng.choice(len(recs), 3, replace=False)
            parts = []
            for r in refs:
                seq = recs[r][2]
                s = int(rng.integers(0, len(seq) - 50))
                parts.append(seq[s:s + 50])
            f.write(b">chimera%d\n" % i + b"".join(parts) + b"\n")
    cfg = UTreeConfig()
    res = build_database(str(wd / "refs.fa"), str(wd / "tax.map"), cfg)
    index = DeviceIndexArrays.from_build(res.words, res.ixs, res.labels.strings, cfg)
    write_ubt(str(wd / "db.ubt"), res.words, res.ixs, res.labels.strings, cfg)
    write_ctr_from_ubt(str(wd / "db.ubt"), str(wd / "db.ctr"), cfg)
    return {"dir": wd, "index": index, "reads": str(wd / "reads.fa"),
            "ctr": str(wd / "db.ctr"), "jax": {}}


def _jax_run(db, do_rc, hist_cap=8, record_range=None):
    """The JAX pipeline's output bytes and its table (cached per config)."""
    key = (do_rc, hist_cap, record_range)
    if key not in db["jax"]:
        pipe = JaxPipeline(db["index"], do_rc=do_rc, batch_size=BATCH,
                           hist_cap=hist_cap, lookup_mode="displaced")
        assert pipe._devvote and pipe.table_kind == "displaced"
        out = db["dir"] / f"jax_{do_rc}_{hist_cap}_{record_range}.txt"
        pipe.search_file(db["reads"], str(out), record_range=record_range)
        db["jax"][key] = (out.read_bytes(), tables_from_jax(pipe._table))
    return db["jax"][key]


def _port(db, do_rc, hist_cap=8, **kw):
    table = _jax_run(db, do_rc, hist_cap)[1]
    return SearchPipeline(db["index"], device="cpu", do_rc=do_rc,
                          batch_size=BATCH, hist_cap=hist_cap,
                          lookup_mode="displaced", _table=table, **kw)


@pytest.mark.parametrize("do_rc", [True, False], ids=["rc", "forward"])
def test_classifications_equal_jax(db, tmp_path, do_rc):
    want = _jax_run(db, do_rc)[0]
    out = tmp_path / "cls.txt"
    n = _port(db, do_rc).search_file(db["reads"], str(out))
    assert n == NREADS
    assert out.read_bytes() == want
    assert want.count(b"\n") > 500


def test_hist_cap_2_replays_flagged_reads(db, tmp_path):
    """hist_cap=2: reads with 3+ unique labels are flagged on the device and
    replayed exactly on the host."""
    want = _jax_run(db, True, hist_cap=2)[0]
    pipe = _port(db, True, hist_cap=2)
    replayed = []
    orig = pipe._host_hits
    pipe._host_hits = lambda seq: replayed.append(seq) or orig(seq)
    out = tmp_path / "cls.txt"
    pipe.search_file(db["reads"], str(out))
    assert replayed  # the flagged path really ran
    assert out.read_bytes() == want


def test_resume_after_truncated_run(db, tmp_path):
    want = _jax_run(db, True)[0]
    pipe = _port(db, True)
    part = tmp_path / "part.txt"

    class Stop(Exception):
        pass

    orig = pipe._format_devvote
    calls = []

    def bomb(*a, **kw):
        if len(calls) >= 3:
            raise Stop()
        calls.append(1)
        return orig(*a, **kw)

    pipe._format_devvote = bomb
    with pytest.raises(Stop):
        pipe.search_file(db["reads"], str(part))
    pipe._format_devvote = orig
    assert (tmp_path / "part.txt.ckpt").exists()
    assert 0 < part.stat().st_size < len(want)
    assert pipe.search_file(db["reads"], str(part), resume=True) == NREADS
    assert part.read_bytes() == want
    assert not (tmp_path / "part.txt.ckpt").exists()


def test_record_range(db, tmp_path):
    rr = (300, 800)
    want = _jax_run(db, True, record_range=rr)[0]
    out = tmp_path / "range.txt"
    assert _port(db, True).search_file(db["reads"], str(out), record_range=rr) == 500
    assert out.read_bytes() == want


def test_own_tables_equal_jax_tables(db):
    """Without _table the port builds the same tables as the JAX pipeline:
    under `auto` the canonical ladder (this DB is far below 80M records),
    and the displaced table when asked for it; the vote tables with both."""
    want_disp = _jax_run(db, True)[1]
    want_auto = tables_from_jax(JaxPipeline(db["index"], do_rc=True)._table)
    for mode, want in (("auto", want_auto), ("displaced", want_disp)):
        got = SearchPipeline(db["index"], device="cpu", do_rc=True,
                             lookup_mode=mode)._table
        assert sorted(got) == sorted(want), mode
        assert ("c1" if mode == "auto" else "d1") in got
        for k in want:
            assert torch.equal(got[k], want[k]), (mode, k)


def test_cli_search(db, tmp_path):
    """`search --rc --device cpu` on the .ctr round trip of the same DB."""
    from utree_tpu_torch.cli import main

    out = tmp_path / "cli.txt"
    main(["search", db["ctr"], db["reads"], str(out), "--rc", "--device", "cpu",
          "--batch", str(BATCH), "--trace"])
    assert out.read_bytes() == _jax_run(db, True)[0]


def test_port_never_imports_jax():
    code = ("import sys; import utree_tpu_torch.pipeline, utree_tpu_torch.cli, "
            "utree_tpu_torch.kernels, utree_tpu_torch.convert, "
            "utree_tpu_torch.lookup, utree_tpu_torch.classify_device, "
            "utree_tpu_torch.hash_index, utree_tpu_torch.parallel.sharded, "
            "utree_tpu.search_host, bench, chip_smoke; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
            "if m.startswith('jax'))")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=pathlib.Path(__file__).resolve().parent.parent)
    assert r.returncode == 0, r.stderr


def test_cuda_device_without_gpu_raises(db):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        SearchPipeline(db["index"], device="cuda", do_rc=True)


@pytest.mark.parametrize("kw", [
    dict(lookup_mode="hash"), dict(lookup_mode="routed"),
    dict(devices=2), dict(support_ranges=8),
], ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_unsupported_modes_raise(db, kw):
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        SearchPipeline(db["index"], device="cpu", **kw)


def test_explicit_lookup_mode_never_degrades(db):
    """The port's mirror of tests/test_device_pipeline.py's test of that
    name: PACKSIZE=64 has no bsearch replay, so an explicit bsearch raises
    ValueError in both pipelines rather than taking another table."""
    from chip_smoke import index64

    rng = np.random.default_rng(3)
    words = np.zeros(400, [("hi", "<u8"), ("lo", "<u8")])
    words["hi"] = np.sort(rng.integers(0, 1 << 64, 400, dtype=np.uint64))
    words["lo"] = rng.integers(0, 1 << 64, 400, dtype=np.uint64)
    idx64 = index64(words, rng.integers(0, 9, 400), [b"l%d" % i for i in range(9)])
    for make in (lambda: JaxPipeline(idx64, lookup_mode="bsearch", batch_size=8),
                 lambda: SearchPipeline(idx64, device="cpu", lookup_mode="bsearch",
                                        batch_size=8)):
        with pytest.raises(ValueError, match="unsupported for PACKSIZE=64"):
            make()


def test_long_read_raises(db, tmp_path):
    """A 20 kbp read among short ones no longer raises: it is cut into
    chunks whose histograms merge on the host, and the bytes equal the JAX
    pipeline's (more long-read cases are in tests/test_torch_layouts.py)."""
    reads = tmp_path / "long.fa"
    rng = np.random.default_rng(0)
    seq = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), 20_000))
    genomic = b"".join(ln for ln in pathlib.Path(db["dir"] / "refs.fa").read_bytes()
                       .splitlines() if not ln.startswith(b">"))[:20_000]
    reads.write_bytes(b">short\nACGTACGTACGTACGTACGTACGTACGTACGTACGT\n>long\n" + seq
                      + b"\n>genomic\n" + genomic + b"\n"
                      + b"".join(pathlib.Path(db["reads"]).read_bytes()
                                 .splitlines(keepends=True)[:200]))
    jax = JaxPipeline(db["index"], do_rc=True, batch_size=BATCH, lookup_mode="displaced")
    jax.search_file(str(reads), str(tmp_path / "jax.txt"))
    want = (tmp_path / "jax.txt").read_bytes()
    assert any(ln.startswith(b"genomic\t") for ln in want.splitlines())
    _port(db, True).search_file(str(reads), str(tmp_path / "o.txt"))
    assert (tmp_path / "o.txt").read_bytes() == want


def test_unsupported_databases_raise(db):
    """Wide labels (>= 65535) run now, on the ladder under `auto`, with the
    unpacked histogram rows; a PACKSIZE=64 config over 32-mer records
    builds no 64-mer table and raises as the JAX pipeline does."""
    import dataclasses

    rng = np.random.default_rng(1)
    words = np.unique(rng.integers(0, 1 << 64, 2000, dtype=np.uint64))
    n_lab = 0xFFFF
    wide = DeviceIndexArrays.from_build(
        words, rng.integers(0, n_lab, len(words)), [b"l%d" % i for i in range(n_lab)],
        UTreeConfig(ixtype_bytes=4))
    pipe = SearchPipeline(wide, device="cpu")
    assert pipe.table_kind == "canonical" and pipe.layout == "unpacked"
    assert pipe._table["c1"].shape[1] % 4 == 0
    k64 = dataclasses.replace(db["index"], config=UTreeConfig(packsize=64))
    for make in (lambda: JaxPipeline(k64), lambda: SearchPipeline(k64, device="cpu")):
        with pytest.raises(RuntimeError, match="needs the canonical hash table"):
            make()
