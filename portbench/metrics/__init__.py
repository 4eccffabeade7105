"""The benchmark's metrics, one reader a file: `metrics/<name>.py` holds
`read(ctx) -> float | None` for the metric `name` of `BENCHMARK.json`.  A
reader that finds nothing to read returns None.  On a card the run then
fails, printing no result: a metric reports in every cell that its
`workloads` key lists, or in every cell where it has none.  On the CPU (the
tests) the run leaves it out of its line.  `Context` is what a run hands
every reader."""

from __future__ import annotations

import dataclasses
import importlib.util
import pathlib
import re

HERE = pathlib.Path(__file__).resolve().parent


@dataclasses.dataclass
class Context:
    """What one run measured.  Times are seconds; `work` counts what the
    window's samples asked of the program (its keys are listed in
    `harness.work_counts`); `trace` is the traced window (tracing.Trace) or
    None in an untraced run."""

    setup_s: float
    window_s: float
    reads: int  # reads classified in the window, all samples
    samples: int
    setup: dict  # host clock: db_load_s, table_build_s
    work: dict
    peaks: dict
    trace: object = None

    def share(self, *phases: str) -> float | None:
        """Percent of the traced window that the host spent in `phases`
        (self time)."""
        if self.trace is None:
            return None
        self_s = self.trace.self_s()
        return 100.0 * sum(self_s.get(p, 0.0) for p in phases) / self.trace.window_s

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the traced window's ops whose names match."""
        if self.trace is None:
            return 0.0
        rx = re.compile(pattern)
        return sum(s for name, s in self.trace.ops.items() if rx.search(name))


def reader(name: str):
    """The `read` function of metric `name`."""
    path = HERE / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"metric {name!r} has no reader {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
