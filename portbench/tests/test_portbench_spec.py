"""BENCHMARK.json, and the files it names, as the harness reads them."""

import ast
import json
import pathlib
import re

import pytest

from portbench import spec
from portbench.metrics import reader

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert {m["name"] for m in BENCH["end_to_end"]} == {"reads_per_s", "setup_s"}
    moves = {m["name"] for m in BENCH["end_to_end"]}
    assert all(m["moves"] in moves for m in BENCH["per_layer"])


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_workload_resolves(workload):
    cell = spec.load(workload, ROOT)
    assert cell["cell"]["chips"] == 1
    assert cell["config"]["name"] == cell["cell"]["config"]
    for key in ("kmers", "complevel", "threads", "lookup_mode", "labels", "shared"):
        assert key in cell["config"]
    for key in ("reads", "read_len", "batch_size", "rc", "support_ranges"):
        assert key in cell["traffic"]
    assert set(cell["end_to_end"]) == {"reads_per_s", "setup_s"}
    assert cell["per_layer"]
    for m in cell["end_to_end"] + cell["per_layer"]:
        assert callable(reader(m))


@pytest.mark.parametrize("path", sorted((ROOT / "portbench").glob("*/*.json")),
                         ids=lambda p: p.name)
def test_data_files_parse(path):
    json.loads(path.read_text())


def test_config_files():
    for c in BENCH["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert len(c["source"]) <= 200 and "\n" not in c["source"]


def test_every_metric_file_is_used_or_loads():
    for path in (ROOT / "portbench" / "metrics").glob("*.py"):
        if path.name != "__init__.py":
            assert callable(reader(path.stem))
            ast.parse(path.read_text())
