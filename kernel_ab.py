#!/usr/bin/env python3
"""Time the probes K1 scan_probe[_wide] and K4 ladder_probe[_wide], K2's
histograms and K11 route_displaced of one or more checkouts of this
repository on one NVIDIA GPU, on the same inputs, at chip_smoke.py's
shapes, with each call's device time split by launch.

    python3 kernel_ab.py [TREE ...] [--out FILE] [--only RE]

Each TREE is the root of a checkout (default: this one); give the same tree
more than once to interleave, e.g. `kernel_ab.py old . . old` for an A/B
(old, new, new, old).  The inputs are made once, by this checkout's code on
the card: chip_smoke's 20M-k-mer tier (4096 labels), its displaced table
and its canonical ladder, and phase 7's 2M-k-mer tier of 70,000 labels
(IXTYPE=u32) with both tables;

- K1 and K4 at phase 3's and phase 6's shape (65,536 reads of 150 bp,
  true_len 152, 121 windows, RC) on the 20M tier's tables, and their
  `_wide` entry points at that shape on the 2M tier's (phase 7's wide
  displaced batch); with the count of 32 B sectors the valid windows'
  first-level rows touch (a narrow row of 24 B straddles two for half the
  row indices), and, as a yardstick, torch.index_select of those rows;
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
default).  --only times the calls whose names match a regular expression
(e.g. 'probe' for K1 and K4 alone).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
ITERS = 200
TRUE_LEN = 152  # chip_smoke's true_len for 150 bp reads: W = 121 windows
QUEUED = 50  # calls queued behind a device sleep of QUEUE_CYCLES (> 50 ms)
QUEUE_CYCLES = 100_000_000
HIST_CAP = 8


def _first_rows(table: dict, packed, vbits, lens) -> tuple:
    """The first-level row (d1 or c1) of each valid window of the batch, by
    the plain functions, and the table's row width in bytes."""
    from utree_tpu_torch import lookup as lk

    p, v = lk._trim(packed, vbits, TRUE_LEN)
    qpre, qhi, qlo, valid = lk.extract_windows(lk.base_codes_packed(p, v, lens))
    klo, khi, _ = lk.canonical_keys(qpre, qhi, qlo)
    if "d1" in table:
        t1, ds = table["d1"], table["ds"]
        bkt = lk.displaced_bucket(klo, khi, valid, 4 * ds.shape[0])
        slot = lk.displaced_slot(klo, khi, lk.displaced_seed(ds, bkt), valid,
                                 2 * t1.shape[0])
        rows = slot >> 1
    else:
        t1 = table["c1"]
        rows = lk.canonical_buckets(klo, khi, valid, t1.shape[0], 8)[0]
    return rows[valid], t1.shape[1] * 4


def _sectors(rows, nb: int) -> dict:
    """32 B sectors the valid windows' first-level rows touch: a row of
    `nb` bytes at offset row * nb spans one sector or two."""
    start = (rows * nb) % 32
    touched = (start + nb + 31) // 32
    return {"valid_windows": int(rows.numel()), "row_bytes": nb,
            "sectors": int(touched.sum()), "straddling": int((touched > 1).sum())}


def _inputs(path: pathlib.Path, dev, kmers: int = 20_000_000) -> None:
    """Make the inputs with this checkout's code on `dev`; save to path."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from utree_tpu_torch import lookup
    from utree_tpu_torch.hash_index import (_canonical_groups,
                                            build_canonical_hash_index,
                                            build_displaced_index,
                                            canonical_to_device, displaced_nseed,
                                            displaced_to_device)
    from utree_tpu_torch.parallel.routed import CAPACITY_FACTOR
    from utree_tpu_torch.pipeline import SearchPipeline

    t = time.perf_counter()
    index, genome, rng = cs.make_tier(kmers, cs.LABELS)
    canon = build_canonical_hash_index(index)
    ladder = canonical_to_device(canon, dev)
    disp = displaced_to_device(
        cs.load_or_build_displaced(index, kmers, cs.LABELS, ROOT / ".bench_cache"), dev)
    L, k = index.num_labels, index.config.packsize
    reads = cs.make_reads(genome, rng, cs.BATCH)
    packed, vbits, lens = cs.batch_tensors(dev, reads)
    # phase 7's wide 2M tier: its displaced table and a ladder of it
    windex, wgenome, wrng = cs.make_tier(cs.WIDE_DISPLACED_KMERS, cs.WIDE_LABELS,
                                         ixtype_bytes=4)
    wtables = {"displaced": displaced_to_device(build_displaced_index(windex), dev),
               "ladder": canonical_to_device(build_canonical_hash_index(windex), dev)}
    wbatch = cs.batch_tensors(dev, cs.make_reads(wgenome, wrng, cs.BATCH))
    batch = (packed, vbits, lens)
    firsts = {name: _first_rows(t, *x) for name, t, x in (
        ("scan_probe", disp, batch), ("ladder_probe", ladder, batch),
        ("scan_probe_wide", wtables["displaced"], wbatch),
        ("ladder_probe_wide", wtables["ladder"], wbatch))}
    sectors = {name: _sectors(*f) for name, f in firsts.items()}
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
    def cpu(tab):
        return {k: v.cpu() for k, v in tab.items()}

    torch.save({"num_labels": L, "main": main.cpu(), "long": [x.cpu() for x in long_ids],
                "route": [x[:b].cpu() for x in batch],
                "nseed": nseed, "b1": int(canon.t1.shape[0]), "shards": S,
                "capacity": cap, "batch": [x.cpu() for x in batch],
                "displaced": cpu(disp), "ladder": cpu(ladder),
                "wide_labels": windex.num_labels, "wide_batch": [x.cpu() for x in wbatch],
                "wide": {k: cpu(v) for k, v in wtables.items()}, "sectors": sectors,
                "first_rows": {name: f[0].cpu() for name, f in firsts.items()}}, path)
    print(f"inputs: {len(long_ids)} long reads, main {tuple(main.shape)}, K11 "
          f"{b} reads x {w} windows, nseed {nseed}, b1 {canon.t1.shape[0]}, capacity "
          f"{cap}; d1 {tuple(disp['d1'].shape)}, c1 {tuple(ladder['c1'].shape)}, wide "
          + ", ".join(f"{k} {tuple(v.shape)}" for t in wtables.values() for k, v in t.items())
          + f"; first-level sectors {json.dumps(sectors)} "
          f"({time.perf_counter() - t:.1f} s)", flush=True)


def _digest(outs) -> str:
    h = hashlib.sha1()
    for o in outs if isinstance(outs, (tuple, list)) else (outs,):
        h.update(o.cpu().numpy().tobytes())
    return h.hexdigest()


def _worker(tree: pathlib.Path, inputs: pathlib.Path, dev, only: str) -> dict:
    """Time one tree's kernels on the saved inputs, on `dev`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(tree))
    import utree_tpu_torch
    from utree_tpu_torch import lookup
    from utree_tpu_torch.kernels.build import build, ptxas_usage
    from utree_tpu_torch.parallel import routed as R

    if pathlib.Path(utree_tpu_torch.__file__).resolve().parent.parent != tree:
        raise SystemExit(f"imported {utree_tpu_torch.__file__}, not {tree}'s package")
    inp = torch.load(inputs)
    _, secs, report = build()
    L = inp["num_labels"]
    main = inp["main"].to(dev)
    longs = [x.to(dev) for x in inp["long"]]
    packed, vbits, lens = (x.to(dev) for x in inp["route"])
    k11 = dict(num_shards=inp["shards"], capacity=inp["capacity"])
    def on(tab):
        return {k: v.to(dev) for k, v in tab.items()}

    probe_in = [x.to(dev) for x in inp["batch"]]
    wide_in = [x.to(dev) for x in inp["wide_batch"]]
    pkw = dict(do_rc=True, true_len=TRUE_LEN)
    probes = (("scan_probe", on(inp["displaced"]), probe_in, 0xFFFF, L),
              ("ladder_probe", on(inp["ladder"]), probe_in, 0xFFFF, L),
              ("scan_probe_wide", on(inp["wide"]["displaced"]), wide_in, 0x7FFFFFFF,
               inp["wide_labels"]),
              ("ladder_probe_wide", on(inp["wide"]["ladder"]), wide_in, 0x7FFFFFFF,
               inp["wide_labels"]))
    calls = {}
    for name, table, args, bad, labels in probes:
        calls[f"{name} main"] = (lambda table=table, args=args, bad=bad, labels=labels:
                                 lookup.window_ids(table, *args, bad_ix=bad,
                                                   num_labels=labels, **pkw))
        # a yardstick, not the probe's function: the same first-level rows
        # gathered by torch.index_select (and written out, rows x row bytes)
        first = table["d1" if "d1" in table else "c1"]
        rows = inp["first_rows"][name].to(dev)
        calls[f"{name} rows by index_select"] = (
            lambda first=first, rows=rows: torch.index_select(first, 0, rows))
    calls.update({"histogram main": lambda: lookup.histogram(main, L, HIST_CAP),
             "histogram_packed main": lambda: lookup.histogram_packed(main, L, HIST_CAP)})
    for x in longs:
        calls[f"histogram_packed {x.shape[0]} x {x.shape[1]}"] = (
            lambda x=x: lookup.histogram_packed(x, L, HIST_CAP))
    for tag, nseed in (("nseed", inp["nseed"]), ("b1", inp["b1"])):
        calls[f"route_displaced {tag}"] = (
            lambda nseed=nseed: R.route_displaced(packed, vbits, lens, nseed=nseed, **k11))
    res = {}
    for name, fn in calls.items():
        if not re.search(only, name):
            continue
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
    usage = {k: v for k, v in ptxas_usage(report)
             if re.search(r"scan_probe|ladder_probe|route", k)}
    return {"tree": str(tree), "build_s": secs, "ptxas": usage, "calls": res}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("trees", nargs="*", default=[str(ROOT)])
    ap.add_argument("--out", default=str(ROOT / ".bench_cache" / "kernel_ab.json"))
    ap.add_argument("--only", default="", help="time only the calls this matches")
    ap.add_argument("--worker", nargs=2, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(_worker(pathlib.Path(a.worker[0]).resolve(),
                                 pathlib.Path(a.worker[1]), "cuda", a.only)), flush=True)
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
                            "--worker", str(pathlib.Path(tree).resolve()), str(inputs),
                            "--only", a.only], capture_output=True, text=True)
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
