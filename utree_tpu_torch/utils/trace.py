"""Tracing of a search (the port's copy of `utree_tpu/utils/trace.py`).

- PhaseTimer: inclusive seconds by phase name and named counters; while a
  `torch.profiler` records, each phase is also a profiler annotation
  `phase:<name>`, so a Chrome trace holds the program's phases on the same
  clock as the card's kernels;
- process(): the process's own PhaseTimer.  Set-up spans (`index`,
  `table`, `build:*`) and the search's counters (`search.*`, `table.*`,
  `build.*`) always go there, whatever tracer a search was handed, so they
  can be read after the fact;
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
import sys
import time

PHASE = "phase:"


def _profiling() -> bool:
    """Whether a torch.profiler is recording in this process: the plain
    module flag torch sets at its start and clears at its stop (no torch,
    no profiler)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


class PhaseTimer:
    """Inclusive seconds by phase name (`phases`, in the order each name
    first opened, with the number of phases open around it then in
    `depth`) and counters (`counts`)."""

    def __init__(self):
        self.phases: dict[str, float] = {}
        self.depth: dict[str, int] = {}
        self.counts: dict[str, float] = {}
        self._open = 0

    @contextlib.contextmanager
    def phase(self, name: str):
        if name not in self.phases:
            self.phases[name] = 0.0
            self.depth[name] = self._open
        self._open += 1
        t0 = time.perf_counter()
        try:
            if _profiling():
                from torch.profiler import record_function

                with record_function(PHASE + name):
                    yield
            else:
                yield
        finally:
            self.phases[name] += time.perf_counter() - t0
            self._open -= 1

    def count(self, name: str, n: float):
        self.counts[name] = self.counts.get(name, 0.0) + n

    def rate(self, count_name: str, phase_name: str) -> float:
        dt = self.phases.get(phase_name, 0.0)
        return self.counts.get(count_name, 0.0) / dt if dt else 0.0

    def lines(self) -> list[str]:
        """`name [seconds]` a phase, indented two spaces a phase open
        around it, then `name: count` a counter."""
        return ([f"{'  ' * self.depth[name]}{name} [{s:.3f}s]" for name, s in self.phases.items()]
                + [f"{name}: {n:,.0f}" for name, n in self.counts.items()])

    def add(self, other: "PhaseTimer") -> None:
        """Add `other`'s phases and counters to this timer's."""
        for name, s in other.phases.items():
            self.depth.setdefault(name, other.depth[name])
            self.phases[name] = self.phases.get(name, 0.0) + s
        for name, n in other.counts.items():
            self.count(name, n)


_PROCESS = PhaseTimer()


def process() -> PhaseTimer:
    """This process's PhaseTimer (set-up spans and counters)."""
    return _PROCESS


@contextlib.contextmanager
def scope():
    """A fresh process record for the block (one CLI command, one test),
    added to the record outside it when the block ends."""
    global _PROCESS
    outer, _PROCESS = _PROCESS, PhaseTimer()
    try:
        yield _PROCESS
    finally:
        inner, _PROCESS = _PROCESS, outer
        outer.add(inner)


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
