"""Spans of a traced run and what the profiler's trace says about them.

The harness hands `Recorder` to `SearchPipeline(tracer=...)`: it has the
`phase()`/`count()` interface of the program's `utils/trace.PhaseTimer`,
and marks each phase as a `torch.profiler` annotation `phase:<name>`.  The
harness marks the window (`portbench:window`) and each sample's
`search_file` call (`portbench:program`) the same way.  After the window the
profiler's Chrome trace holds, on one clock, the host's spans and the card's
kernels and copies; `read_trace` turns them into

- the host's time line over the window, each instant named by the innermost
  span open then: a phase (self time: a nested phase is taken out of its
  parent), `program:no-phase` (inside `search_file`, outside every phase)
  or `harness` (the window's own loop, between samples);
- the device's busy intervals (kernels, copies, memsets), and the idle time
  between them named by the host's time line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re

PHASE = "phase:"
SPAN = "portbench:"
NO_PHASE = "program:no-phase"
HARNESS = "harness"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Recorder:
    """A tracer for `SearchPipeline`: each phase a profiler annotation."""

    def __init__(self):
        self.counts: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        from torch.profiler import record_function

        with record_function(PHASE + name):
            yield

    def count(self, name: str, n: float):
        self.counts[name] = self.counts.get(name, 0.0) + n


def span(name: str, on: bool):
    """A harness span (a profiler annotation) when tracing, else nothing."""
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(SPAN + name)


def op_name(name: str) -> str:
    """A device op's name without its namespace, return type and argument
    list (template arguments stay)."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                return name[:i].strip() or name
    return name


@dataclasses.dataclass
class Trace:
    window: tuple[float, float]  # seconds, on the trace's clock
    segments: list[tuple[float, float, str]]  # the host's time line
    busy: list[tuple[float, float]]  # device busy intervals, merged
    ops: dict[str, float]  # device seconds by op name

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)

    def self_s(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for a, b, name in self.segments:
            out[name] = out.get(name, 0.0) + b - a
        return out

    def idle_s(self) -> dict[str, float]:
        """Device idle seconds by what the host was doing meanwhile."""
        out: dict[str, float] = {}
        busy = self.busy
        j = 0
        for a, b, name in self.segments:
            t, idle = a, 0.0
            while j < len(busy) and busy[j][1] <= a:
                j += 1
            k = j
            while t < b:
                if k < len(busy) and busy[k][0] < b:
                    idle += max(0.0, busy[k][0] - t)
                    t = max(t, busy[k][1])
                    k += 1
                else:
                    idle += b - t
                    t = b
            out[name] = out.get(name, 0.0) + idle
        return out


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def _timeline(spans, lo: float, hi: float):
    """Cover [lo, hi] with (start, end, name) pieces, each named by the
    innermost span open (HARNESS where none is)."""
    out = []
    stack: list[tuple[float, str]] = []  # (end, name)
    cur = lo

    def emit(to):
        nonlocal cur
        to = min(max(to, cur), hi)
        if to > cur:
            out.append((cur, to, stack[-1][1] if stack else HARNESS))
            cur = to

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= a:
            emit(stack[-1][0])
            stack.pop()
        emit(a)
        stack.append((min(b, stack[-1][0]) if stack else b, name))
    while stack:
        emit(stack[-1][0])
        stack.pop()
    emit(hi)
    return out


def read_trace(path: str) -> Trace:
    """The window, the host's time line and the device's busy time of a
    Chrome trace written by torch.profiler around a traced window."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    window = None
    spans, device, ops = [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat"), e.get("name", "")
        a = float(e["ts"]) * 1e-6
        b = a + float(e.get("dur", 0)) * 1e-6
        if cat == "user_annotation":
            if name == SPAN + "window":
                window = (a, b)
            elif name == SPAN + "program":
                spans.append((a, b, NO_PHASE))
            elif name.startswith(PHASE):
                spans.append((a, b, name[len(PHASE):]))
        elif cat in DEVICE_CATS:
            device.append((a, b, op_name(name)))
    if window is None:
        raise RuntimeError(f"{path}: no {SPAN}window span in the trace")
    lo, hi = window
    busy = _merge((max(a, lo), min(b, hi)) for a, b, _ in device if b > lo and a < hi)
    for a, b, name in device:
        if b > lo and a < hi:
            ops[name] = ops.get(name, 0.0) + min(b, hi) - max(a, lo)
    return Trace(window=window, segments=_timeline(spans, lo, hi), busy=busy, ops=ops)
