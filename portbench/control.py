"""The control of `correct`, at a cell's own size.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 [--drop-bases 1]

For each seed it makes the cell's inputs on the card, as a run does, and
puts the reference computed at a lower precision in the program's place:
k-mer keys compared without their last `--drop-bases` bases (62 of 64 bits
for one base), the step from exact matching that a faster table would tempt
one to take.  Its output is held to the exact reference by the run's own
comparison, and each seed's numbers are printed beside their limits.  A
control that a limit does not catch means the comparison cannot tell a
lower precision from the configuration's, and the limit is no limit.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--drop-bases", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import generate, harness, spec
    from portbench.reference.classify import Reference

    cell = spec.load(args.workload, ROOT)
    config, traffic = cell["config"], cell["traffic"]
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    caught = 0
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed in seeds:
        inputs = generate.make_inputs(config, traffic, seed, "cuda")
        ref = dict(words=inputs["words"], ixs=inputs["ixs"], strings=inputs["strings"],
                   taxacut=config["taxacut"], device="cuda")
        lines = lambda r: r.lines(inputs["reads"], generate.read_name, traffic["rc"],
                                  traffic["support_ranges"])
        t = time.perf_counter()
        exact = lines(Reference(**ref))
        t_exact = time.perf_counter() - t
        control = lines(Reference(**ref, drop_bases=args.drop_bases))
        checks = harness.compare(b"".join(x + b"\n" for x in control), exact)
        bad = any(c["value"] > c["limit"] for c in checks.values())
        caught += bad
        print(json.dumps(dict(workload=args.workload, seed=seed, drop_bases=args.drop_bases,
                              reads=len(inputs["reads"]), exact_lines=len(exact),
                              control_lines=len(control), reference_s=t_exact,
                              checks=checks, control_not_correct=bad)), flush=True)
        torch.cuda.empty_cache()
    print(f"control: not correct on {caught} of {len(seeds)} seeds", flush=True)
    return 0 if caught == len(seeds) else 1


if __name__ == "__main__":
    sys.exit(main())
