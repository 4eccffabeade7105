#!/usr/bin/env python3
"""Time K2's histograms and K11 route_displaced of one or more checkouts of
this repository on one NVIDIA GPU, on the same inputs, at chip_smoke.py's
shapes, with each call's device time split by launch.

    python3 kernel_ab.py [TREE ...] [--out FILE]

Each TREE is the root of a checkout (default: this one); give the same tree
more than once to interleave, e.g. `kernel_ab.py old . . old` for an A/B
(old, new, new, old).  The inputs are made once, by this checkout's code on
the card: chip_smoke's 20M-k-mer tier (4096 labels) and its canonical
ladder;

- K2 `histogram_packed` at each of phase 8's 16 long reads' chunk shapes
  (2-64 rows of 16,832-31,250 ids, as SearchPipeline.classify_long_read
  cuts them), and K2 `histogram` and `histogram_packed` at phase 3's
  shape (65,536 reads of 150 bp, 242 ids a read: the register branch);
- K11 `route_displaced` at phase 15's shard shape (16,384 reads of 192
  positions, 161 windows, 4 owners, capacity 857,344) at the displaced
  table's seed count and at the ladder's b1 (phase 19).

Then each tree runs in a process of its own (its `utree_tpu_torch` first on
sys.path, its kernels built into its own .cuda_build/): every call's mean
time over 200 launches from CUDA events after a warm-up, the host's time
to enqueue one (the wrapper's Python and the launches; where it exceeds
the device time the events measure the host), the device time of 50 calls
queued behind a device sleep (no host time), and, from torch.profiler,
the mean device time of each kernel and memset that the call launches.
The outputs of every tree must be byte-identical.  Prints one JSON line
per tree run and writes them all to FILE (.bench_cache/kernel_ab.json by
default).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
ITERS = 200
QUEUED = 50  # calls queued behind a device sleep of QUEUE_CYCLES (> 50 ms)
QUEUE_CYCLES = 100_000_000
HIST_CAP = 8


def _inputs(path: pathlib.Path, dev, kmers: int = 20_000_000) -> None:
    """Make the inputs with this checkout's code on `dev`; save to path."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from utree_tpu_torch import lookup
    from utree_tpu_torch.hash_index import (_canonical_groups,
                                            build_canonical_hash_index,
                                            canonical_to_device, displaced_nseed)
    from utree_tpu_torch.parallel.routed import CAPACITY_FACTOR
    from utree_tpu_torch.pipeline import SearchPipeline

    t = time.perf_counter()
    index, genome, rng = cs.make_tier(kmers, cs.LABELS)
    canon = build_canonical_hash_index(index)
    ladder = canonical_to_device(canon, dev)
    L, k = index.num_labels, index.config.packsize
    reads = cs.make_reads(genome, rng, cs.BATCH)
    packed, vbits, lens = cs.batch_tensors(dev, reads)
    kw = dict(do_rc=True, bad_ix=0xFFFF, num_labels=L)
    main = lookup.window_ids(ladder, packed, vbits, lens,
                             true_len=(cs.READ_LEN + 7) & ~7, **kw)
    long_ids = [lookup.window_ids(ladder, *cs.long_read_chunks(
        dev, seq, k, SearchPipeline.long_chunk), **kw) for seq in cs.long_reads(genome)]
    S, b = cs.ROUTED_SHARDS, cs.BATCH // cs.ROUTED_SHARDS
    w = packed.shape[1] * 4 - 31
    nseed = displaced_nseed(_canonical_groups(index)[-1])
    while nseed % S:
        nseed *= 2
    cap = max(128, -(-int(b * w / S * CAPACITY_FACTOR) // 128) * 128)
    torch.save({"num_labels": L, "main": main.cpu(), "long": [x.cpu() for x in long_ids],
                "route": [x[:b].cpu() for x in (packed, vbits, lens)],
                "nseed": nseed, "b1": int(canon.t1.shape[0]), "shards": S,
                "capacity": cap}, path)
    print(f"inputs: {len(long_ids)} long reads, main {tuple(main.shape)}, K11 "
          f"{b} reads x {w} windows, nseed {nseed}, b1 {canon.t1.shape[0]}, capacity "
          f"{cap} ({time.perf_counter() - t:.1f} s)", flush=True)


def _digest(outs) -> str:
    h = hashlib.sha1()
    for o in outs if isinstance(outs, (tuple, list)) else (outs,):
        h.update(o.cpu().numpy().tobytes())
    return h.hexdigest()


def _worker(tree: pathlib.Path, inputs: pathlib.Path, dev) -> dict:
    """Time one tree's kernels on the saved inputs, on `dev`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(tree))
    import utree_tpu_torch
    from utree_tpu_torch import lookup
    from utree_tpu_torch.kernels.build import build
    from utree_tpu_torch.parallel import routed as R

    if pathlib.Path(utree_tpu_torch.__file__).resolve().parent.parent != tree:
        raise SystemExit(f"imported {utree_tpu_torch.__file__}, not {tree}'s package")
    inp = torch.load(inputs)
    secs = build()[1]
    L = inp["num_labels"]
    main = inp["main"].to(dev)
    longs = [x.to(dev) for x in inp["long"]]
    packed, vbits, lens = (x.to(dev) for x in inp["route"])
    k11 = dict(num_shards=inp["shards"], capacity=inp["capacity"])
    calls = {"histogram main": lambda: lookup.histogram(main, L, HIST_CAP),
             "histogram_packed main": lambda: lookup.histogram_packed(main, L, HIST_CAP)}
    for x in longs:
        calls[f"histogram_packed {x.shape[0]} x {x.shape[1]}"] = (
            lambda x=x: lookup.histogram_packed(x, L, HIST_CAP))
    for tag, nseed in (("nseed", inp["nseed"]), ("b1", inp["b1"])):
        calls[f"route_displaced {tag}"] = (
            lambda nseed=nseed: R.route_displaced(packed, vbits, lens, nseed=nseed, **k11))
    res = {}
    for name, fn in calls.items():
        digest = _digest(fn())
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        t = time.perf_counter()
        for _ in range(ITERS):
            fn()
        host = time.perf_counter() - t  # the enqueue: launches queue, no sync
        end.record()
        torch.cuda.synchronize()
        # the device time: the calls queued behind a device sleep run back
        # to back (chip_smoke.device_ms)
        q0, q1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(QUEUE_CYCLES)
        q0.record()
        for _ in range(QUEUED):
            fn()
        q1.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        split = {}  # the device's events only: kernels, memsets, copies
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
            if e.device_type == DeviceType.CUDA and us > 0:
                split[e.key[:90]] = {"count": e.count, "mean_us": us / e.count}
        res[name] = {"ms": start.elapsed_time(end) / ITERS, "host_us": host / ITERS * 1e6,
                     "device_ms": q0.elapsed_time(q1) / QUEUED, "sha1": digest,
                     "split": split}
    return {"tree": str(tree), "build_s": secs, "calls": res}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("trees", nargs="*", default=[str(ROOT)])
    ap.add_argument("--out", default=str(ROOT / ".bench_cache" / "kernel_ab.json"))
    ap.add_argument("--worker", nargs=2, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(_worker(pathlib.Path(a.worker[0]).resolve(),
                                 pathlib.Path(a.worker[1]), "cuda")), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip()
    print(card, flush=True)
    cache = ROOT / ".bench_cache"
    cache.mkdir(exist_ok=True)
    inputs = cache / "kernel_ab_inputs.pt"
    _inputs(inputs, torch.device("cuda"))
    runs = []
    for tree in a.trees:
        p = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()),
                            "--worker", str(pathlib.Path(tree).resolve()), str(inputs)],
                           capture_output=True, text=True)
        if p.returncode != 0:
            print(p.stdout, p.stderr, file=sys.stderr)
            return 1
        run = json.loads(p.stdout.strip().splitlines()[-1])
        run["card"] = card
        runs.append(run)
        print(json.dumps(run), flush=True)
    digests = {json.dumps({k: v["sha1"] for k, v in r["calls"].items()}) for r in runs}
    for name in runs[0]["calls"]:
        print(f"{name}: " + ", ".join(f"{r['calls'][name]['ms']:.4f}" for r in runs)
              + " ms; enqueue " + ", ".join(f"{r['calls'][name]['host_us']:.1f}" for r in runs)
              + " us; device " + ", ".join(f"{r['calls'][name]['device_ms'] * 1e3:.2f}"
                                           for r in runs)
              + " us; profiler " + ", ".join(
                  f"{sum(v['mean_us'] for v in r['calls'][name]['split'].values()):.2f}"
                  for r in runs) + " us", flush=True)
    pathlib.Path(a.out).parent.mkdir(exist_ok=True)
    pathlib.Path(a.out).write_text(json.dumps({"card": card, "runs": runs}, indent=1))
    if len(digests) != 1:
        print("kernel_ab: the trees' outputs differ", file=sys.stderr)
        return 1
    print(f"outputs byte-identical across {len(runs)} runs; on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
