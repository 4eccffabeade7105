"""The readers of the program's own spans and counters: the window's
`batch` and `piece` phases from a traced window, and the set-up spans and
counters from the program's process record
(`utree_tpu_torch.utils.trace.process()`), each 0 where nothing was
recorded."""

import json

import pytest

from portbench import tracing
from portbench.metrics import Context, reader
from utree_tpu_torch.utils import trace
from utree_tpu_torch.utils.trace import PhaseTimer

SETUP = ("index_bins_s", "table_place_s", "table_copy_s", "table_attempts",
         "native_build_s", "replay_share")


def ctx(timeline=None):
    return Context(setup_s=12.5, window_s=2.5, reads=1000, samples=4,
                   setup=dict(db_load_s=1.0, table_build_s=2.0), work={}, peaks={},
                   trace=timeline)


def window(tmp_path, phases):
    """A 1000 us window holding one sample 0-1000 us with `phases`
    ((name, start, duration) in us)."""
    ev = lambda name, ts, dur: {"ph": "X", "name": name, "cat": "user_annotation",
                                "ts": ts, "dur": dur}
    events = [ev("portbench:window", 0, 1000), ev("portbench:program", 0, 1000)]
    events += [ev("phase:" + n, ts, dur) for n, ts, dur in phases]
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": events}))
    return tracing.read_trace(str(p))


def test_batch_and_piece_shares(tmp_path):
    # batch 100-600 holding pack 200-400; piece 700-750; scan 750-800
    t = window(tmp_path, [("batch", 100, 500), ("pack", 200, 200), ("piece", 700, 50),
                          ("scan", 750, 50)])
    assert reader("batch_share")(ctx(t)) == pytest.approx(30.0)  # pack's self time apart
    assert reader("piece_share")(ctx(t)) == pytest.approx(5.0)
    assert reader("pack_share")(ctx(t)) == pytest.approx(20.0)
    assert reader("uncovered_share")(ctx(t)) == pytest.approx(40.0)


def test_batch_and_piece_absent(tmp_path):
    t = window(tmp_path, [("scan", 100, 100)])
    assert reader("batch_share")(ctx(t)) == 0.0
    assert reader("piece_share")(ctx(t)) == 0.0
    assert reader("batch_share")(ctx()) is None  # no traced window


@pytest.fixture
def record(monkeypatch):
    rec = PhaseTimer()
    monkeypatch.setattr(trace, "process", lambda: rec)
    return rec


def test_setup_spans_and_counters(record):
    record.phases.update({"index": 3.0, "index:bins": 1.25, "table": 9.0,
                          "table:place": 6.5, "table:copy": 1.5, "build:nvcc": 18.0,
                          "build:g++": 2.5})
    record.counts.update({"table.attempts": 2, "search.reads": 4000, "search.replayed": 30})
    c = ctx()
    assert reader("index_bins_s")(c) == 1.25
    assert reader("table_place_s")(c) == 6.5
    assert reader("table_copy_s")(c) == 1.5
    assert reader("table_attempts")(c) == 2
    assert reader("native_build_s")(c) == 20.5
    assert reader("replay_share")(c) == pytest.approx(0.75)


@pytest.mark.parametrize("name", SETUP)
def test_nothing_recorded_reads_zero(record, name):
    assert reader(name)(ctx()) == 0.0


def test_one_build_of_two(record):
    record.phases["build:g++"] = 4.0
    assert reader("native_build_s")(ctx()) == 4.0


@pytest.mark.parametrize("name", SETUP)
def test_a_program_without_a_process_record_reads_zero(monkeypatch, name):
    """A program older than the record (the parent of the change that added
    it): 0, since the harness fails a run on a card where a reader finds
    nothing."""
    monkeypatch.delattr(trace, "process")
    assert reader(name)(ctx()) == 0.0
