"""Tracing of a search (the port's copy of `utree_tpu/utils/trace.py`).

- PhaseTimer: structured phase timing in the reference's narration style
  (`phase [dt]`, xtree.c:289-473) plus a machine-readable summary and
  throughput counters (reads/s);
- Tracer: `torch.profiler` around a block, the counterpart of the JAX
  package's `jax.profiler` trace; writes a Chrome trace (chrome://tracing,
  Perfetto, TensorBoard's profiler plugin) of the host's operators and, on a
  card, its CUDA kernels.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import time


class PhaseTimer:
    """Named phase timers; prints `phase [dt]` like the reference and keeps a
    summary dict for logs/JSON."""

    def __init__(self, quiet: bool = False):
        self.phases: dict[str, float] = {}
        self.counts: dict[str, float] = {}
        self.quiet = quiet

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            if not self.quiet:
                print(f"{name} [{dt:.3f}s]")

    def count(self, name: str, n: float):
        self.counts[name] = self.counts.get(name, 0.0) + n

    def rate(self, count_name: str, phase_name: str) -> float:
        dt = self.phases.get(phase_name, 0.0)
        return self.counts.get(count_name, 0.0) / dt if dt else 0.0

    def summary(self) -> dict:
        out = {"phases_s": dict(self.phases), "counts": dict(self.counts)}
        if "reads" in self.counts and "search" in self.phases:
            out["reads_per_sec"] = self.rate("reads", "search")
        return out

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


class Tracer:
    """`with Tracer(logdir, device): ...` records the block with
    torch.profiler and writes `<host>_<pid>.<ns>.pt.trace.json` under
    logdir: CPU activity, and on a CUDA `device` the card's kernels too.
    A trace on a card that recorded no kernel raises (CUPTI could not
    trace) and leaves no file.  `Tracer(None)` does nothing."""

    def __init__(self, logdir: str | None, device="cpu"):
        self.logdir = logdir
        self.cuda = str(device).startswith("cuda")
        self.path = None
        self._prof = None

    def __enter__(self):
        if self.logdir:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        prof, self._prof = self._prof, None
        prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        os.makedirs(self.logdir, exist_ok=True)
        path = os.path.join(self.logdir, f"{socket.gethostname()}_{os.getpid()}."
                                         f"{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        if self.cuda and not kernel_names(path):
            os.unlink(path)
            raise RuntimeError("torch.profiler recorded no CUDA kernel on the card "
                               "(CUPTI tracing unavailable?); no trace written")
        self.path = path
        return False


def kernel_names(trace_path: str) -> set[str]:
    """The names of the CUDA kernel events (category "kernel") of a Chrome
    trace that Tracer wrote."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return {e["name"] for e in events if e.get("cat") == "kernel"}
