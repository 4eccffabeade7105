"""Run one cell of the benchmark once and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the program (`utree_tpu_torch`).  The
last line of standard output is the result (JSON); the last lines of
standard error are the numbers that decided `correct`, each beside its
limit.  With `--trace 0` the metrics are the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read from a torch.profiler trace of the
window.  `--threads` overrides the configuration's thread count, for a sweep.

The configuration's `threads` is applied before the program's native
libraries or torch load: OMP_NUM_THREADS and torch.set_num_threads.  The run
fails, printing no result, when the process may use fewer cores, when no
card or fewer cards than the cell asks for are present, or when JAX or the
JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def fail(msg: str) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--threads", type=int, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import spec

    cell = spec.load(args.workload, ROOT)
    threads = args.threads or cell["config"]["threads"]
    cores = len(os.sched_getaffinity(0))
    if cores < threads:
        return fail(f"the configuration runs {threads} host threads; this process "
                    f"may use {cores} cores")
    os.environ["OMP_NUM_THREADS"] = str(threads)
    import torch

    torch.set_num_threads(threads)
    chips = cell["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return fail(f"the cell needs {chips} CUDA card(s); torch sees "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    from portbench import harness

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    log(f"portbench: {args.workload} seed {args.seed}, {args.seconds:g} s, trace "
        f"{args.trace}, {threads} threads of {cores} cores")
    try:
        result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", log)
    except (ImportError, RuntimeError) as e:
        return fail(f"{type(e).__name__}: {e}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
