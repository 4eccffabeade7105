"""The traced window's readings: the host's time line, the device's idle
time by host phase, and the metric readers over hand-worked shapes."""

import json

import numpy as np
import pytest

from portbench import harness, tracing
from portbench.metrics import Context, reader


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def trace_file(tmp_path, events):
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": events}))
    return tracing.read_trace(str(p))


@pytest.fixture
def trace(tmp_path):
    # microseconds: a 1000 us window; one sample 100-900 with phases
    # scan 100-300, drain+vote 400-800 holding drain:vote 500-700; kernels
    # 150-250 and 450-470 (and one before the window, which is left out)
    return trace_file(tmp_path, [
        ev("portbench:window", "user_annotation", 0, 1000),
        ev("portbench:program", "user_annotation", 100, 800),
        ev("phase:scan", "user_annotation", 100, 200),
        ev("phase:drain+vote", "user_annotation", 400, 400),
        ev("phase:drain:vote", "user_annotation", 500, 200),
        ev("void (anonymous namespace)::bsearch_probe_kernel<true>(int const*)", "kernel", 150, 100),
        ev("histogram_kernel<8, (Layout)0>", "kernel", 450, 20),
        ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 460, 20),
        ev("early_kernel", "kernel", -50, 20),
    ])


def test_self_times(trace):
    s = trace.self_s()
    assert trace.window_s == pytest.approx(1000e-6)
    assert s["harness"] == pytest.approx(200e-6)
    assert s["scan"] == pytest.approx(200e-6)
    assert s["drain+vote"] == pytest.approx(200e-6)
    assert s["drain:vote"] == pytest.approx(200e-6)
    assert s["program:no-phase"] == pytest.approx(200e-6)
    assert sum(s.values()) == pytest.approx(1000e-6)


def test_device_busy_and_idle(trace):
    assert trace.busy_s == pytest.approx(130e-6)  # 100 + (450-480)
    idle = trace.idle_s()
    assert idle["scan"] == pytest.approx(100e-6)
    assert idle["drain+vote"] == pytest.approx(170e-6)
    assert idle["harness"] == pytest.approx(200e-6)
    assert sum(idle.values()) == pytest.approx(870e-6)
    assert trace.ops["bsearch_probe_kernel<true>"] == pytest.approx(100e-6)
    assert "early_kernel" not in trace.ops
    assert "histogram_kernel<8, (Layout)0>" in trace.ops
    assert tracing.op_name("Memcpy HtoD (Pinned -> Device)") == "Memcpy HtoD"


def test_no_window_span_is_an_error(tmp_path):
    with pytest.raises(RuntimeError):
        trace_file(tmp_path, [ev("phase:scan", "user_annotation", 0, 10)])


def ctx(trace=None, **work):
    base = dict(batch_positions=[100, 50], ids=300, rows=4, read_bytes=120.0,
                ctr_bytes=10_000, hist_cap=8, id_bytes=2)
    base.update(work)
    return Context(setup_s=12.5, window_s=2.5, reads=1000, samples=4,
                   setup=dict(db_load_s=1.0, table_build_s=2.0), work=base,
                   peaks={"hbm_bytes_per_s": 1e6}, trace=trace)


def test_shares_and_rate(trace):
    c = ctx(trace)
    assert reader("reads_per_s")(c) == 400.0  # all reads over the whole window
    assert reader("setup_s")(c) == 12.5
    assert reader("scan_share")(c) == pytest.approx(20.0)
    assert reader("vote_share")(c) == pytest.approx(40.0)
    assert reader("uncovered_share")(c) == pytest.approx(20.0)
    assert reader("device_idle_share")(c) == pytest.approx(87.0)
    assert reader("scan_share")(ctx()) is None


def test_roofline_bytes(trace):
    # probe: min(32 B a position, the table) per batch + the reads' bytes:
    # 3200 + 1600 + 120 = 4920 B at 1e6 B/s = 4.92 ms over 100 us of K7
    assert reader("probe_roofline")(ctx(trace)) == pytest.approx(100 * 4.92e-3 / 100e-6)
    # a table smaller than a batch's sectors is read once instead
    assert reader("probe_roofline")(ctx(trace, ctr_bytes=1000)) == pytest.approx(
        100 * (1000 + 1000 + 120) / 1e6 / 100e-6)
    # K2: 300 ids at 2 B + 4 rows of 9 four-byte slots = 744 B over 20 us
    assert reader("histogram_roofline")(ctx(trace)) == pytest.approx(100 * 744e-6 / 20e-6)
    assert reader("histogram_roofline")(ctx()) is None


def test_work_counts_by_hand():
    reads = np.frombuffer(b"A" * 40 + b"A" * 10 + b"N" + b"A" * 29 + b"C" * 40, np.uint8).reshape(3, 40)
    traffic = dict(batch_size=2, rc=True, hist_cap=8)
    w = harness.work_counts(reads, traffic, dict(ixtype_bytes=2), records=5, samples=2)
    # 9 windows in a clean 40 bp read, none across the N
    assert w["batch_positions"] == [9, 9, 9, 9]
    assert w["ids"] == 2 * 18 * 2
    assert w["rows"] == 6
    assert w["read_bytes"] == 3 * 120 / 8 * 2
    assert w["ctr_bytes"] == 35 + 4 * ((1 << 24) + 1)
