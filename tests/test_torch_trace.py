"""The port's spans and counters (`utree_tpu_torch/utils/trace.py`) on the
CPU: how `search_file`'s phases nest (the `batch` and `piece` spans never
inside another phase, none open across a generator's yield), the output
bytes with tracing off, on and under torch.profiler, the profiler's
`phase:` annotations, the process record's set-up spans (`index`,
`table:*`, `build:*`) and counters (`search.*`, `table.attempts`,
`build.compiles`), and the CLI's `--trace` listing."""

import contextlib
import importlib
import json
import pathlib

import numpy as np
import pytest
import torch

from utree_tpu.testdata import make_toy_db, make_toy_reads
from utree_tpu_torch import cli, native
from utree_tpu_torch.build import build_database
from utree_tpu_torch.config import UTreeConfig
from utree_tpu_torch.encode import search_window_words
from utree_tpu_torch.index import DeviceIndexArrays
from utree_tpu_torch.pipeline import SearchPipeline
from utree_tpu_torch.search_host import lookup_words
from utree_tpu_torch.utils import trace
from utree_tpu_torch.utils.trace import PhaseTimer

# the module, which the package's `build` function shadows
kernel_build = importlib.import_module("utree_tpu_torch.kernels.build")
BATCH = 128
LONG = 1000  # the pipelines' long_read_threshold here


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A toy DB's index (its set-up spans kept), 1000 reads of 150 bp (three
    pieces at the 64 KiB floor of `stream_chunk_bytes`), the same reads
    with a 3 kbp read from a reference between their halves, and 600
    chimeric reads of 150 bp."""
    wd = tmp_path_factory.mktemp("trace")
    recs = make_toy_db(str(wd / "refs.fa"), str(wd / "tax.map"), seed=131, num_refs=10)
    make_toy_reads(str(wd / "reads.fa"), recs, num_reads=1000, seed=137)
    shorts = (wd / "reads.fa").read_bytes().split(b">")[1:]
    with open(wd / "mix.fa", "wb") as f:
        f.write(b">" + b">".join(shorts[:500]))
        f.write(b">long\n" + recs[3][2][:3000] + b"\n")
        f.write(b">" + b">".join(shorts[500:]))
    # reads of two references' halves, most of two or more labels
    rng = np.random.default_rng(139)
    with open(wd / "chimera.fa", "wb") as f:
        for i in range(600):
            a, b = rng.choice(len(recs), 2, replace=False)
            at = rng.integers(0, 4000, 2)
            f.write(b">c%d\n" % i + recs[a][2][at[0]:at[0] + 75]
                    + recs[b][2][at[1]:at[1] + 75] + b"\n")
    cfg = UTreeConfig()
    res = build_database(str(wd / "refs.fa"), str(wd / "tax.map"), cfg)
    with trace.scope() as rec:
        index = DeviceIndexArrays.from_build(res.words, res.ixs, res.labels.strings, cfg)
    return {"dir": wd, "index": index, "index_record": rec}


def _pipe(env, **kw):
    pipe = SearchPipeline(env["index"], device="cpu", do_rc=True, batch_size=BATCH, **kw)
    pipe.stream_chunk_bytes = 1
    pipe.long_read_threshold = LONG
    return pipe


class Recording:
    """A tracer that keeps the phases open around each phase as it opens
    and fails when a phase closes out of the order phases opened."""

    def __init__(self):
        self.stack: list[str] = []
        self.parents: dict[str, set] = {}
        self.counts: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name):
        self.parents.setdefault(name, set()).add(self.stack[-1] if self.stack else None)
        self.stack.append(name)
        try:
            yield
        finally:
            assert self.stack.pop() == name, f"{name} closed out of order"

    def count(self, name, n):
        self.counts[name] = self.counts.get(name, 0.0) + n


def test_search_file_phases_nest(env, tmp_path):
    """Every phase closes in order; `batch`, `piece` and `scan` open with no
    phase around them, so none sits inside another and none was open when
    a generator yielded (the consumer's dispatch, drain and long read would
    then open inside it); `pack` stays inside `batch`."""
    rec = Recording()
    pipe = _pipe(env, tracer=rec)
    assert pipe.search_file(str(env["dir"] / "mix.fa"), str(tmp_path / "out.txt")) == 1001
    assert rec.stack == []
    p = rec.parents
    assert {"batch", "piece", "scan", "pack", "dispatch", "drain+vote", "write",
            "long-reads"} <= set(p)
    for name in ("batch", "piece", "scan", "dispatch", "drain+vote", "write", "long-reads"):
        assert p[name] == {None}, (name, p[name])
    assert p["pack"] == {"batch"}
    for name in (n for n in p if n.startswith("drain:")):
        assert p[name] <= {"drain+vote", "long-reads"}, (name, p[name])
    assert rec.counts["reads"] == 1001


def test_output_identical_traced_or_not(env, tmp_path):
    """The same bytes with no tracer, a PhaseTimer and under a CPU
    torch.profiler; the profiler's Chrome trace holds the phases as
    `phase:` annotations (the process record's, with no tracer handed
    over)."""
    outs = {}
    for kind in ("none", "timer", "profiler"):
        pipe = _pipe(env, tracer=PhaseTimer() if kind == "timer" else None)
        out = tmp_path / f"{kind}.txt"
        if kind == "profiler":
            acts = [torch.profiler.ProfilerActivity.CPU]
            with torch.profiler.profile(activities=acts) as prof:
                pipe.search_file(str(env["dir"] / "mix.fa"), str(out))
            prof.export_chrome_trace(str(tmp_path / "trace.json"))
        else:
            pipe.search_file(str(env["dir"] / "mix.fa"), str(out))
        outs[kind] = out.read_bytes()
        if kind == "timer":
            assert {"batch", "piece", "scan", "pack"} <= set(pipe.tracer.phases)
    assert outs["none"].count(b"\n") > 500
    assert outs["timer"] == outs["none"] and outs["profiler"] == outs["none"]
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"phase:batch", "phase:piece", "phase:scan", "phase:pack", "phase:dispatch",
            "phase:drain+vote", "phase:write", "phase:long-reads"} <= names


def test_phase_annotates_only_under_a_profiler(monkeypatch):
    """Without a recording profiler a phase never reaches
    `record_function`; inside one it does."""
    tm = PhaseTimer()

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with tm.phase("a"):
        with tm.phase("b"):
            pass
    monkeypatch.undo()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tm.phase("a"):
            pass
    assert "phase:a" in {e.key for e in prof.key_averages()}
    assert list(tm.phases) == ["a", "b"] and tm.depth == {"a": 0, "b": 1}
    assert tm.phases["a"] >= tm.phases["b"] >= 0.0


def _fasta(path):
    recs = pathlib.Path(path).read_bytes().split(b">")[1:]
    return [r.split(b"\n")[1] for r in recs]


def _labels_a_read(env):
    """Each chimeric read's count of distinct labels hit, both strands, by
    the exact host search (`search_host.lookup_words`)."""
    hidx = env["index"].host_index()
    out = []
    for seq in _fasta(env["dir"] / "chimera.fa"):
        ixs = lookup_words(hidx, search_window_words(seq, 32, True))
        out.append(len(np.unique(ixs[ixs < hidx.num_labels])))
    return np.array(out)


def test_replayed_counts_the_over_cap_reads(env, tmp_path):
    """hist_cap=1 on the packed layout: `search.replayed` counts the reads
    of two or more labels, counted apart by the host search, and
    `search.reads` every read."""
    pipe = _pipe(env, hist_cap=1, device_vote=False, compact_readback=False)
    assert pipe.layout == "packed"
    with trace.scope() as rec:
        n = pipe.search_file(str(env["dir"] / "chimera.fa"), str(tmp_path / "out.txt"))
    over = int((_labels_a_read(env) > 1).sum())
    assert over > 100
    assert rec.counts["search.replayed"] == over
    assert rec.counts["search.reads"] == n == 600
    assert "search.redispatched" not in rec.counts


def test_redispatched_counts_the_compact_redos(env, tmp_path):
    """The compact readback with a block of one row: each batch with more
    than one read of two or more labels goes again through the full rows,
    and `search.redispatched` counts those batches."""
    pipe = _pipe(env, device_vote=False, compact_over_cap=1)
    assert pipe.layout == "compact"
    with trace.scope() as rec:
        pipe.search_file(str(env["dir"] / "chimera.fa"), str(tmp_path / "out.txt"))
    multi = _labels_a_read(env) > 1
    redos = sum(int(multi[a:a + BATCH].sum()) > 1 for a in range(0, len(multi), BATCH))
    assert redos > 0
    assert rec.counts["search.redispatched"] == redos


def test_index_spans(env):
    rec = env["index_record"]
    assert set(rec.phases) == {"index", "index:bins"}
    assert rec.depth == {"index": 0, "index:bins": 1}
    assert 0.0 < rec.phases["index:bins"] <= rec.phases["index"]


@pytest.mark.parametrize("mode, kind", [("auto", "canonical"), ("bsearch", "bsearch")])
def test_table_spans_and_attempts(env, mode, kind):
    """SearchPipeline(...)'s set-up spans, each inside `table`: the native
    libraries, the vote tables, the placement (the ladder's hits, groups
    and tiers) and the copy; one geometry tried for bsearch, at least one
    on the ladder."""
    with trace.scope() as rec:
        pipe = SearchPipeline(env["index"], device="cpu", do_rc=True, lookup_mode=mode)
    assert pipe.table_kind == kind
    spans = {"table", "table:native", "table:vote-tables", "table:place", "table:copy"}
    if kind == "canonical":
        spans |= {"table:groups", "table:hits", "table:tier"}
        assert rec.counts["table.attempts"] >= 1
        assert rec.depth["table:hits"] > rec.depth["table:groups"] > rec.depth["table:place"]
    else:
        assert rec.counts["table.attempts"] == 1
    assert set(rec.phases) - {"build:g++"} == spans
    assert all(rec.depth[s] == 1 for s in ("table:native", "table:place", "table:copy"))
    ph = rec.phases
    assert (ph["table:native"] + ph["table:vote-tables"] + ph["table:place"]
            + ph["table:copy"]) <= ph["table"]


def test_no_build_spans_when_the_libraries_are_built():
    native.fasta_lib()
    native.vote_lib()
    with trace.scope() as rec:
        native._compile("fasta.cpp")
        native._compile("vote.cpp")
    assert not rec.phases and not rec.counts


def test_a_g_plus_plus_build_is_one_compile(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    with trace.scope() as rec:
        so = native._compile("fasta.cpp")
    assert so.parent == tmp_path and so.exists()
    assert rec.counts == {"build.compiles": 1} and list(rec.phases) == ["build:g++"]
    with trace.scope() as rec:
        assert native._compile("fasta.cpp") == so
    assert not rec.phases and not rec.counts


class _FakeNvcc:
    """`nvcc` that writes an empty file where `-o` points."""

    returncode = 0

    def __init__(self, cmd, **kw):
        pathlib.Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")

    def communicate(self):
        return "", ""


def test_an_nvcc_build_is_one_compile(tmp_path, monkeypatch):
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernel_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernel_build.subprocess, "Popen", _FakeNvcc)
    monkeypatch.setattr(kernel_build.subprocess, "run", _FakeNvcc)
    with trace.scope() as rec:
        so, _, _ = kernel_build.build.__wrapped__()
    assert so.parent == tmp_path and so.exists()
    assert rec.counts == {"build.compiles": 1} and list(rec.phases) == ["build:nvcc"]
    with trace.scope() as rec:
        assert kernel_build.build.__wrapped__()[0] == so
    assert not rec.phases and not rec.counts


def test_scope_adds_to_the_record_outside():
    outer = trace.process()
    before = outer.counts.get("test.scope", 0.0)
    with trace.scope() as rec:
        assert trace.process() is rec and rec is not outer
        rec.count("test.scope", 2)
    assert trace.process() is outer
    assert outer.counts["test.scope"] == before + 2


def test_cli_trace_lists_setup_spans_and_counters(env, tmp_path, capsys):
    """search --trace lists the set-up spans under `load-db` and
    `build-table`, the search's phases under `search`, then the counters."""
    d = env["dir"]
    ubt, ctr = str(tmp_path / "db.ubt"), str(tmp_path / "db.ctr")
    cli.main(["build", str(d / "refs.fa"), str(d / "tax.map"), ubt])
    cli.main(["compress", ubt, ctr])
    capsys.readouterr()
    cli.main(["search", ctr, str(d / "reads.fa"), str(tmp_path / "out.txt"), "--rc",
              "--device", "cpu", "--batch", str(BATCH), "--trace"])
    lines = capsys.readouterr().out.splitlines()
    names = [ln.split(" [")[0] for ln in lines if ln.endswith("s]")]
    for name in ("load-db", "  index", "build-table", "  table", "    table:native",
                 "    table:place", "      table:groups", "    table:copy", "search",
                 "  scan", "  piece", "  batch", "    pack", "  dispatch", "  drain+vote",
                 "    drain:vote", "  write"):
        assert name in names, (name, names)
    assert names.index("build-table") < names.index("  table") < names.index("search")
    assert "search.reads: 1,000" in lines and "reads: 1,000" in lines
    assert any(ln.startswith("table.attempts: ") for ln in lines)
    assert any(ln.startswith("throughput: ") for ln in lines)
