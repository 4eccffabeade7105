"""Runs of one cell in a row, each a fresh process, and their spread.

    python3 portbench/series.py --workload <name> --seeds 11,12,13 --seconds 10 \
        [--trace 0|1] [--threads N] [--out chiprun_out/series.jsonl]

Each run is `portbench/run.py` with one seed; its result line, exit code and
the end of its standard error are appended to `--out`.  At the end it prints,
for each metric, the values, the median and the spread: the distance between
the first and third quartiles (`statistics.quantiles(values, n=4)`) as a
share of the median.  The card's name and power limit are printed first.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def spread(values: list[float]) -> float:
    if len(values) < 2:
        return 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--threads", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"card: {smi.stdout.strip() or smi.stderr.strip()}", flush=True)
    values: dict[str, list[float]] = {}
    bad = 0
    for seed in [int(s) for s in args.seeds.split(",")]:
        cmd = [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload", args.workload,
               "--seed", str(seed), "--seconds", str(args.seconds), "--trace", str(args.trace)]
        if args.threads:
            cmd += ["--threads", str(args.threads)]
        t = time.perf_counter()
        p = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
        wall = time.perf_counter() - t
        lines = p.stdout.strip().splitlines()
        result = None
        if p.returncode == 0 and lines:
            result = json.loads(lines[-1])
        rec = dict(workload=args.workload, seed=seed, threads=args.threads, rc=p.returncode,
                   wall_s=wall, result=result, stderr=p.stderr[-6000:])
        if args.out:
            with open(ROOT / args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if result is None or not result["correct"]:
            bad += 1
            print(f"seed {seed}: rc {p.returncode}, not correct\n{p.stderr[-3000:]}", flush=True)
            continue
        m = {k: v["value"] for k, v in result["metrics"].items()}
        for k, v in m.items():
            values.setdefault(k, []).append(v)
        print(f"seed {seed}: {wall:.1f} s wall, " + ", ".join(f"{k} {v:.6g}" for k, v in m.items()),
              flush=True)
    for k, v in values.items():
        print(f"{k}: median {statistics.median(v):.6g}, spread {100 * spread(v):.2f}%, "
              f"values {[round(x, 6) for x in v]}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
