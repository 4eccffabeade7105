"""A cell as `BENCHMARK.json` names it: its entry, its configuration's
file, its traffic mix's file (`traffic/<name>.json`), and the metrics it
reports.  Plain standard library: run.py reads this before anything else
loads, so that the cell's thread count is set first."""

from __future__ import annotations

import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load(workload: str, root: pathlib.Path = ROOT) -> dict:
    """{"cell", "config", "traffic", "units", "end_to_end", "per_layer"}
    of `workload`; the metric lists hold the names this cell reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                         + ", ".join(sorted(cells)))
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())

    def names(metrics):
        return [m["name"] for m in metrics if workload in m.get("workloads", [workload])]

    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    return dict(cell=cell, config=config, traffic=traffic, units=units,
                end_to_end=names(bench["end_to_end"]), per_layer=names(bench["per_layer"]))


def peaks(device_name: str) -> dict:
    """The published peaks of the card named `device_name`."""
    table = json.loads((HERE / "peaks.json").read_text())
    for prefix, row in table.items():
        if device_name.startswith(prefix):
            return row
    raise SystemExit(f"no peaks for {device_name!r} in {HERE / 'peaks.json'}")
