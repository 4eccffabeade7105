"""Phase timing of a search (the port's copy of `PhaseTimer` from
`utree_tpu/utils/trace.py`): structured phase timing in the reference's
narration style (`phase [dt]`, xtree.c:289-473) plus a machine-readable
summary and throughput counters (reads/s).
"""

from __future__ import annotations

import contextlib
import json
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

