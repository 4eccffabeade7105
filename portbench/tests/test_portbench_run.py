"""Whole runs of the harness on the CPU at a tiny size (the kernels' plain
versions), with the look for a card skipped, and the command's own checks.

- a sound run comes out correct, and its rate is all reads over the whole
  window;
- the window calls `search_file` and nothing else of the program;
- with the timed path broken underneath, `correct` comes out false: half of
  each batch left out, one answer altered where it is produced, a step that
  returns its rows unchanged;
- the control (the reference at a lower precision) is not correct either;
- run.py applies the configuration's threads before torch or the program
  loads, and fails, printing no result, without enough cores or a card.
"""

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

from portbench import generate, harness, spec
from portbench.reference.classify import Reference

ROOT = pathlib.Path(__file__).resolve().parents[2]
SEED = 2**31 + 11


def tiny(workload="l2.short150"):
    """A cell at a test's size."""
    cell = spec.load(workload, ROOT)
    cell["config"].update(kmers=60_000)
    cell["config"]["labels"].update(leaves=60, leaves_per_node=[30, 15, 10, 6, 4, 2, 2, 1])
    cell["traffic"].update(reads=3000, batch_size=1024)
    return cell


def run(cell, seconds=0.5, trace=False):
    return harness.run(cell, SEED, seconds, trace, "cpu", log=lambda m: None, age=lambda: 1.0)


@pytest.mark.parametrize("workload", ["l4.short150", "l2.short150"])
def test_sound_run_is_correct(workload):
    r = run(tiny(workload))
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert r["attempted"] >= 3000 and r["attempted"] % 3000 == 0
    assert set(r["metrics"]) == {"reads_per_s", "setup_s"}


def test_traced_run_reports_its_layers():
    r = run(tiny(), trace=True)
    assert r["correct"]
    assert {"scan_share", "pack_share", "dispatch_share", "vote_share", "write_share",
            "uncovered_share", "db_load_s", "table_build_s"} <= set(r["metrics"])
    names = {k for k, _ in r["breakdown"]["idle_gaps"]}
    assert "program:no-phase" in names and "scan" in names


def test_rate_covers_the_whole_window(monkeypatch):
    from utree_tpu_torch.pipeline import SearchPipeline

    real = SearchPipeline.search_file
    calls = []

    def slow(self, *a, **k):
        n = real(self, *a, **k)
        time.sleep(0.3)
        calls.append(n)
        return n

    monkeypatch.setattr(SearchPipeline, "search_file", slow)
    r = run(tiny(), seconds=1.0)
    rate = r["metrics"]["reads_per_s"]["value"]
    window = r["attempted"] / rate
    samples = len(calls) - 1  # the first call is the untimed pass
    assert r["attempted"] == 3000 * samples
    assert window >= 1.0 and window >= 0.3 * samples  # up to the last sample's end


def test_window_calls_only_search_file(monkeypatch):
    import utree_tpu_torch.pipeline as pl

    seen = []

    class Watched(pl.SearchPipeline):
        def __getattribute__(self, name):
            if sys._getframe(1).f_code is harness.run.__code__:
                seen.append(name)
            return super().__getattribute__(name)

    monkeypatch.setattr(pl, "SearchPipeline", Watched)
    r = run(tiny())
    n = r["attempted"] // 3000
    # the log line, the untimed pass, the window's samples, the names kept
    assert seen == ["table_kind", "layout"] + ["search_file"] * (1 + n) + ["table_kind", "layout"]


def _half_batch(monkeypatch):
    from utree_tpu_torch.pipeline import SearchPipeline

    real = SearchPipeline.dispatch_packed

    def half(self, packed, vbits, lens, step=None):
        lens = lens.copy()
        lens[len(lens) // 2:] = 0
        return real(self, packed, vbits, lens, step=step)

    monkeypatch.setattr(SearchPipeline, "dispatch_packed", half)


def _altered_answer(monkeypatch):
    from utree_tpu_torch.pipeline import SearchPipeline

    real = SearchPipeline._format

    def altered(self, *a):
        out = real(self, *a)
        return out.replace(b"\t1\t*", b"\t2\t*", 1)

    monkeypatch.setattr(SearchPipeline, "_format", altered)


def _rows_unchanged(monkeypatch):
    from utree_tpu_torch.pipeline import SearchPipeline

    real = SearchPipeline._readback

    def zero(self, parts):
        return real(self, [p.new_zeros(p.shape) for p in parts])

    monkeypatch.setattr(SearchPipeline, "_readback", zero)


@pytest.mark.parametrize("fault", [_half_batch, _altered_answer, _rows_unchanged],
                         ids=lambda f: f.__name__.strip("_"))
@pytest.mark.parametrize("workload", ["l4.short150", "l2.short150"])
def test_broken_path_is_not_correct(monkeypatch, fault, workload):
    fault(monkeypatch)
    r = run(tiny(workload))
    assert not r["correct"]
    assert r["checks"]["reads_differing"]["value"] > 0


@pytest.mark.parametrize("workload", ["l4.short150", "l2.short150"])
def test_control_is_not_correct(workload):
    cell = tiny(workload)
    config, traffic = cell["config"], cell["traffic"]
    inputs = generate.make_inputs(config, traffic, SEED, "cpu")
    args = (inputs["words"], inputs["ixs"], inputs["strings"], config["taxacut"], "cpu")
    lines = lambda ref: ref.lines(inputs["reads"], generate.read_name, traffic["rc"],
                                  traffic["support_ranges"])
    exact = lines(Reference(*args))
    control = b"".join(x + b"\n" for x in lines(Reference(*args, drop_bases=1)))
    assert harness.compare(control, exact)["reads_differing"]["value"] > 0
    sound = b"".join(x + b"\n" for x in exact)
    assert harness.compare(sound, exact)["reads_differing"]["value"] == 0


def test_declared_metric_reading_nothing_fails_on_a_card():
    from portbench.metrics import Context

    ctx = Context(setup_s=1.0, window_s=1.0, reads=1, samples=1, setup={}, work={}, peaks={})
    units = {"probe_roofline": "%", "setup_s": "s"}
    logged = []
    got = harness.read_metrics(["probe_roofline", "setup_s"], ctx, units, False, logged.append)
    assert set(got) == {"setup_s"} and "probe_roofline" in logged[0]
    with pytest.raises(RuntimeError, match="probe_roofline"):
        harness.read_metrics(["probe_roofline", "setup_s"], ctx, units, True, logged.append)


def test_compare_counts_order_and_tail():
    want = [b"r1\tx", b"r2\ty"]
    assert harness.compare(b"r2\ty\nr1\tx\n", want)["order_faults"]["value"] == 1
    assert harness.compare(b"r1\tx\nr2\ty", want)["order_faults"]["value"] == 1
    assert harness.compare(b"r1\tx\n", want)["reads_differing"]["value"] == 1
    assert harness.compare(b"r1\tx\nr2\ty\nr3\tz\n", want)["reads_differing"]["value"] == 1


def _run_py(*args, env=None, stub=None):
    """run.py in a fresh process, optionally with harness.run replaced by
    `stub` (source of a function) and a card pretended."""
    code = ["import sys, runpy", f"sys.argv = ['run.py', *{list(args)!r}]",
            f"sys.path.insert(0, {str(ROOT)!r})"]
    if stub:
        code += ["import portbench.harness as h", stub, "h.run = stub",
                 "import torch", "torch.cuda.is_available = lambda: True",
                 "torch.cuda.device_count = lambda: 1"]
    code += [f"runpy.run_path({str(ROOT / 'portbench' / 'run.py')!r}, run_name='__main__')"]
    return subprocess.run([sys.executable, "-c", "\n".join(code)], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=120)


STUB = """
def stub(cell, seed, seconds, trace, device, log):
    import os, sys, torch
    return {"omp": os.environ.get("OMP_NUM_THREADS"), "torch": torch.get_num_threads(),
            "program_loaded": any(m.split(".")[0] == "utree_tpu_torch" for m in sys.modules)}
"""


def test_threads_applied_before_the_program_loads():
    p = _run_py("--workload", "l4.short150", "--seed", "1", "--seconds", "1", "--threads", "2",
                stub=STUB)
    assert p.returncode == 0, p.stderr
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got == {"omp": "2", "torch": 2, "program_loaded": False}


def test_too_few_cores_fails():
    p = _run_py("--workload", "l4.short150", "--seed", "1", "--seconds", "1",
                "--threads", str(len(os.sched_getaffinity(0)) + 1), stub=STUB)
    assert p.returncode != 0 and p.stdout == ""
    assert "cores" in p.stderr


def test_no_card_fails_without_a_result():
    p = _run_py("--workload", "l4.short150", "--seed", "1", "--seconds", "1", "--threads", "1")
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "utree_tpu_torch_fake", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.forbidden_modules() == ["jax.numpy"]
