#!/usr/bin/env python3
"""Time the probes K1 scan_probe[_wide], K4 ladder_probe[_wide], K7
bsearch_probe, K15 bsearch_probe_shard, K5 scan_probe64 and K6
ladder_probe64, K2's histograms and K11 route_displaced of one or more
checkouts of this repository on one NVIDIA GPU, on the same inputs, at
chip_smoke.py's shapes, with each call's device time split by launch.

    python3 kernel_ab.py [TREE ...] [--out FILE] [--only RE]

Each TREE is the root of a checkout (default: this one); give the same tree
more than once to interleave, e.g. `kernel_ab.py old . . old` for an A/B
(old, new, new, old).  The inputs are made once, by this checkout's code on
the card, and only those the selected calls need: chip_smoke's 20M-k-mer
tier (4096 labels) with its CTR records, its displaced table and its
canonical ladder, phase 7's 2M-k-mer tier of 70,000 labels (IXTYPE=u32)
with both tables, and phase 9's 20M 64-mer tier of 70,000 labels
(chip_smoke.tier64) with its 64-mer ladder and displaced table;

- K1 and K4 at phase 3's and phase 6's shape (65,536 reads of 150 bp,
  true_len 152, 121 windows, RC) on the 20M tier's tables, and their
  `_wide` entry points at that shape on the 2M tier's (phase 7's wide
  displaced batch); with the count of 32 B sectors the valid windows'
  first-level rows touch (a narrow row of 24 B straddles two for half the
  row indices), and, as a yardstick, torch.index_select of those rows;
- K7 at phase 10's shape (the same batch over the 20M tier's records),
  with the count of words whose prefix bin is empty, holds one record or
  more; as a yardstick, not K7's function (the replay differs on merged
  bins), torch.searchsorted of the valid windows' 64-bit words of both
  strands over the records' sorted 64-bit keys;
- K15 at phase 18's (1, 8) shape: slice 0 of the 20M tier's records cut
  eight ways, the batch's reads packed by K14 at width 150, RC;
- K6 and K5 at phase 9's shape (65,536 ASCII reads of 150 bp in rows of
  192, 129 windows of which 87 valid, RC) on the 64-mer ladder and
  displaced table, with the count of valid windows whose key reaches
  c64_2 and c64_3; as a yardstick, torch.index_select of the valid
  windows' c64_1 rows;
- K2 `histogram_packed` at each of phase 8's 16 long reads' chunk shapes
  (2-64 rows of 16,834-31,250 ids, as SearchPipeline.classify_long_read
  cuts them; calls `histogram_packed long read 0` to `15`, their shapes
  in the inputs line), and K2 `histogram` and `histogram_packed` at phase 3's
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
the mean device time of each kernel and memset that the call launches
(so a tree whose entry point launches a split of its kernel, kept under
`.ab/` and never committed, reports each part), and ptxas's registers,
shared memory and spills of the probes.  The outputs of every tree must
be byte-identical.  Prints one JSON line per tree run and writes them all
to FILE (.bench_cache/kernel_ab.json by default).  --only times the calls
whose names match a regular expression, and makes only their inputs,
e.g. 'bsearch' (K7, K15 and the searchsorted yardstick), 'probe64' (K5,
K6 and the c64_1 yardstick), '^(scan|ladder)_probe ' (K1 and K4 narrow),
'histogram' or 'route'.
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
from collections.abc import Callable

import chip_smoke as cs

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


def _bsearch_words(bs: dict, packed, vbits, lens):
    """The searchsorted yardstick's operands: the records' 64-bit words
    (prefix << 40 | suffix), sorted, and the valid windows' words of both
    strands."""
    import torch

    from utree_tpu_torch import lookup as lk

    bin_ix = bs["bin_ix"].long()
    n = bs["suf_hi"].shape[0] - 1
    pre = torch.repeat_interleave(torch.arange(bin_ix.shape[0] - 1, device=bin_ix.device),
                                  bin_ix[1:] - bin_ix[:-1])
    keys = ((pre << 40) | (bs["suf_hi"][:n].long() << 32)
            | (bs["suf_lo"][:n].long() & 0xFFFFFFFF)).sort().values
    p, v = lk._trim(packed, vbits, TRUE_LEN)
    qpre, qhi, qlo, valid = lk.extract_windows(lk.base_codes_packed(p, v, lens))
    words = [((a << 40) | (h << 32) | lo)[valid] for a, h, lo in
             ((qpre, qhi, qlo), lk.rc_word_lanes(qpre, qhi, qlo))]
    return keys, torch.cat(words)


def _c64_1_rows(tab: dict, reads, lens):
    """The c64_1 row of each valid window of an ASCII batch, by the plain
    functions."""
    from utree_tpu_torch import lookup as lk

    k0, k1, k2, k3, valid = lk.extract_windows64(lk.base_codes(reads, lens))
    *c, _ = lk.canonicalize64(k0, k1, k2, k3)
    return (lk._fold64(c) & (tab["c64_1"].shape[0] - 1))[valid]


def _inputs(path: pathlib.Path, dev, want: set[str], kmers: int = 20_000_000) -> str:
    """Make the inputs of the groups in `want` with this checkout's code on
    `dev`; save to path.  Returns what it made, as a line."""
    import numpy as np
    import torch

    from utree_tpu_torch import lookup
    from utree_tpu_torch.hash_index import (_canonical_groups, bsearch_to_device,
                                            build_canonical_hash_index,
                                            build_displaced_index,
                                            canonical64_to_device,
                                            canonical_to_device, displaced64_to_device,
                                            displaced_nseed, displaced_to_device)
    from utree_tpu_torch.hash_index64 import (build_canonical_hash_index64,
                                              build_displaced_index64)
    from utree_tpu_torch.parallel import sharded as S
    from utree_tpu_torch.parallel.routed import CAPACITY_FACTOR
    from utree_tpu_torch.pipeline import SearchPipeline

    def cpu(tab):
        return {k: v.cpu() for k, v in tab.items()}

    t = time.perf_counter()
    out, notes = {"groups": sorted(want)}, []
    if "tier" in want:
        index, genome, rng = cs.make_tier(kmers, cs.LABELS)
        L = index.num_labels
        reads = cs.make_reads(genome, rng, cs.BATCH)
        packed, vbits, lens = batch = cs.batch_tensors(dev, reads)
        tb = time.perf_counter()
        bs = bsearch_to_device(index, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        bins = cs.bsearch_bins(bs["bin_ix"], *batch, TRUE_LEN)
        keys, words = _bsearch_words(bs, *batch)
        # K15 at phase 18's (1, 8) shape: slice 0, the reads packed by K14
        sh = S.ShardedIndex.from_index(index, 8)
        s0 = {k: torch.from_numpy(np.ascontiguousarray(a[0]).view(np.int32))
              for k, a in (("bin_ix", sh.bin_ix), ("suf_hi", sh.suf_hi),
                           ("suf_lo", sh.suf_lo), ("ix", sh.ix))}
        rt = torch.from_numpy(np.ascontiguousarray(reads)).to(dev)
        rl = torch.full((rt.shape[0],), cs.READ_LEN, dtype=torch.int32, device=dev)
        spk, svb = lookup.ascii_pack(rt, rl)
        out.update(num_labels=L, probe_iters=index.probe_iters,
                   batch=[x.cpu() for x in batch], bsearch=cpu(bs), bins=bins,
                   bs_keys=keys.cpu(), bs_words=words.cpu(),
                   shard=dict(table=s0, batch=[x.cpu() for x in (spk, svb, rl)],
                              prefix_lo=int(sh.prefix_lo[0]), width=cs.READ_LEN))
        notes.append(f"K7: {kmers:,} records on the card in {time.perf_counter() - tb:.2f} s "
                     f"({', '.join(f'{k} {tuple(v.shape)}' for k, v in bs.items())}); "
                     f"words by bin size {json.dumps(bins)}; searchsorted "
                     f"{words.numel():,} words over {keys.numel():,} keys; K15 slice 0 of 8, "
                     f"{s0['suf_hi'].shape[0]:,} records")
    if "tables" in want:
        canon = build_canonical_hash_index(index)
        ladder = canonical_to_device(canon, dev)
        disp = displaced_to_device(
            cs.load_or_build_displaced(index, kmers, cs.LABELS, ROOT / ".bench_cache"), dev)
        k = index.config.packsize
        firsts = {name: _first_rows(tab, *batch) for name, tab in (
            ("scan_probe", disp), ("ladder_probe", ladder))}
        kw = dict(do_rc=True, bad_ix=0xFFFF, num_labels=L)
        main = lookup.window_ids(ladder, packed, vbits, lens,
                                 true_len=(cs.READ_LEN + 7) & ~7, **kw)
        long_ids = [lookup.window_ids(ladder, *cs.long_read_chunks(
            dev, seq, k, SearchPipeline.long_chunk), **kw) for seq in cs.long_reads(genome)]
        shards, b = cs.ROUTED_SHARDS, cs.BATCH // cs.ROUTED_SHARDS
        w = packed.shape[1] * 4 - 31
        nseed = displaced_nseed(_canonical_groups(index)[-1])
        while nseed % shards:
            nseed *= 2
        cap = max(128, -(-int(b * w / shards * CAPACITY_FACTOR) // 128) * 128)
        out.update(main=main.cpu(), long=[x.cpu() for x in long_ids],
                   route=[x[:b].cpu() for x in batch], nseed=nseed,
                   b1=int(canon.t1.shape[0]), shards=shards, capacity=cap,
                   displaced=cpu(disp), ladder=cpu(ladder))
        notes.append(f"K1/K4/K2/K11: long reads 0-{len(long_ids) - 1} "
                     f"{[tuple(x.shape) for x in long_ids]}, main {tuple(main.shape)}, "
                     f"K11 {b} reads x {w} windows, nseed {nseed}, b1 {canon.t1.shape[0]}, "
                     f"capacity {cap}; d1 {tuple(disp['d1'].shape)}, c1 "
                     f"{tuple(ladder['c1'].shape)}")
    if "wide" in want:
        windex, wgenome, wrng = cs.make_tier(cs.WIDE_DISPLACED_KMERS, cs.WIDE_LABELS,
                                             ixtype_bytes=4)
        wtables = {"displaced": displaced_to_device(build_displaced_index(windex), dev),
                   "ladder": canonical_to_device(build_canonical_hash_index(windex), dev)}
        wbatch = cs.batch_tensors(dev, cs.make_reads(wgenome, wrng, cs.BATCH))
        firsts = {**(firsts if "tables" in want else {}),
                  **{name: _first_rows(tab, *wbatch) for name, tab in (
                      ("scan_probe_wide", wtables["displaced"]),
                      ("ladder_probe_wide", wtables["ladder"]))}}
        out.update(wide_labels=windex.num_labels, wide_batch=[x.cpu() for x in wbatch],
                   wide={k: cpu(v) for k, v in wtables.items()})
        notes.append("wide " + ", ".join(f"{k} {tuple(v.shape)}" for tab in wtables.values()
                                         for k, v in tab.items()))
    if "tables" in want or "wide" in want:
        sectors = {name: _sectors(*f) for name, f in firsts.items()}
        out.update(sectors=sectors, first_rows={name: f[0].cpu() for name, f in firsts.items()})
        notes.append(f"first-level sectors {json.dumps(sectors)}")
    if "k64" in want:
        index64, genome64, rng64 = cs.tier64(kmers, cs.WIDE_LABELS)
        reads64 = cs.make_reads(genome64, rng64, cs.BATCH)
        ascii_ = np.zeros((reads64.shape[0], 192), np.uint8)  # phase 9's rows
        ascii_[:, :cs.READ_LEN] = reads64
        rt = torch.from_numpy(ascii_).to(dev)
        rl = torch.full((rt.shape[0],), cs.READ_LEN, dtype=torch.int32, device=dev)
        t64 = {"ladder64": canonical64_to_device(build_canonical_hash_index64(index64), dev),
               "displaced64": displaced64_to_device(build_displaced_index64(index64), dev)}
        rows64 = _c64_1_rows(t64["ladder64"], rt, rl)
        reach = {"lanes": rt.shape[0] * (rt.shape[1] - 63), "valid": int(rows64.numel()),
                 **cs.ladder64_reach(t64["ladder64"], rt, rl)}
        out.update(k64={"labels": index64.num_labels, "reads": rt.cpu(), "lens": rl.cpu(),
                        "rows": rows64.cpu(), "reach": reach,
                        **{k: cpu(v) for k, v in t64.items()}})
        notes.append(f"K5/K6: {index64.num_records:,} 64-mers, " + ", ".join(
            f"{k} {tuple(v.shape)}" for tab in t64.values() for k, v in tab.items())
                     + f"; windows {json.dumps(reach)}")
    torch.save(out, path)
    note = "inputs: " + "; ".join(notes) + f" ({time.perf_counter() - t:.1f} s)"
    print(note, flush=True)
    return note


def _digest(outs) -> str:
    h = hashlib.sha1()
    for o in outs if isinstance(outs, (tuple, list)) else (outs,):
        h.update(o.cpu().numpy().tobytes())
    return h.hexdigest()


def _calls(inp: dict | None, dev) -> list[tuple[str, str, Callable]]:
    """Every call this script times, as (input group, name, make): make()
    moves the call's saved inputs from `inp` to `dev` (each once) and
    returns the call.  The names need no inputs, so main() makes the input
    groups of the calls that --only selects from this list alone (a long
    read's shape is in its inputs line, not its name)."""
    import torch

    from utree_tpu_torch import lookup
    from utree_tpu_torch.parallel import routed as R
    from utree_tpu_torch.parallel import sharded as S

    held = {}

    def get(*keys):
        """inp[keys[0]][keys[1]]..., moved to dev once."""
        if keys not in held:
            x = inp
            for k in keys:
                x = x[k]
            held[keys] = ({k: v.to(dev) for k, v in x.items()} if isinstance(x, dict)
                          else [v.to(dev) for v in x] if isinstance(x, list) else x.to(dev))
        return held[keys]

    pkw = dict(do_rc=True, true_len=TRUE_LEN)

    def k7():
        bs, batch = get("bsearch"), get("batch")
        return lambda: lookup.window_ids(bs, *batch, bad_ix=0xFFFF, num_labels=inp["num_labels"],
                                         probe_iters=inp["probe_iters"], **pkw)

    def searchsorted():
        # a yardstick, not K7's function: a binary search of the same words
        keys, words = get("bs_keys"), get("bs_words")
        return lambda: torch.searchsorted(keys, words)

    def k15():
        sh, s0, sb = inp["shard"], get("shard", "table"), get("shard", "batch")
        return lambda: S.shard_probe(s0, *sb, prefix_lo=sh["prefix_lo"], width=sh["width"],
                                     do_rc=True, probe_iters=inp["probe_iters"])

    def probe(tab, batch, labels, bad):
        table, args = get(*tab), get(batch)
        return lambda: lookup.window_ids(table, *args, bad_ix=bad, num_labels=inp[labels],
                                         **pkw)

    def rows(name, tab):
        # a yardstick, not the probe's function: the same first-level rows
        # gathered by torch.index_select (and written out, rows x row bytes)
        table, r = get(*tab), get("first_rows", name)
        first = table["d1" if "d1" in table else "c1"]
        return lambda: torch.index_select(first, 0, r)

    def hist(fn, *ids):
        x = get(*ids)
        return lambda: fn(x, inp["num_labels"], HIST_CAP)

    def route(tag):
        packed, vbits, lens = get("route")
        kw = dict(num_shards=inp["shards"], capacity=inp["capacity"], nseed=inp[tag])
        return lambda: R.route_displaced(packed, vbits, lens, **kw)

    def probe64(key):
        tab, reads, lens = get("k64", key), get("k64", "reads"), get("k64", "lens")
        return lambda: lookup.window_ids64(tab, reads, lens, do_rc=True, bad_ix=0x7FFFFFFF)

    def c64_rows():
        # a yardstick, not K6's function: the valid windows' c64_1 rows
        c1, r = get("k64", "ladder64")["c64_1"], get("k64", "rows")
        return lambda: torch.index_select(c1, 0, r)

    out = [("tier", "bsearch_probe main", k7),
           ("tier", "bsearch_probe words by searchsorted", searchsorted),
           ("tier", "bsearch_probe_shard (1, 8) slice 0", k15)]
    for group, sfx, batch, labels, bad, tabs in (
            ("tables", "", "batch", "num_labels", 0xFFFF, (("displaced",), ("ladder",))),
            ("wide", "_wide", "wide_batch", "wide_labels", 0x7FFFFFFF,
             (("wide", "displaced"), ("wide", "ladder")))):
        for kind, tab in zip(("scan_probe", "ladder_probe"), tabs):
            out += [(group, f"{kind}{sfx} main",
                     lambda tab=tab, batch=batch, labels=labels, bad=bad:
                     probe(tab, batch, labels, bad)),
                    (group, f"{kind}{sfx} rows by index_select",
                     lambda name=kind + sfx, tab=tab: rows(name, tab))]
    out += [("tables", "histogram main", lambda: hist(lookup.histogram, "main")),
            ("tables", "histogram_packed main", lambda: hist(lookup.histogram_packed, "main"))]
    out += [("tables", f"histogram_packed long read {i}",
             lambda i=i: hist(lookup.histogram_packed, "long", i))
            for i in range(cs.LONG_READS)]
    out += [("tables", f"route_displaced {tag}", lambda tag=tag: route(tag))
            for tag in ("nseed", "b1")]
    out += [("k64", "ladder_probe64 main", lambda: probe64("ladder64")),
            ("k64", "scan_probe64 main", lambda: probe64("displaced64")),
            ("k64", "ladder_probe64 rows by index_select", c64_rows)]
    return out


def groups(only: str) -> set[str]:
    """The input groups of the calls `only` selects ('tables' needs the
    tier's)."""
    want = {group for group, name, _ in _calls(None, None) if re.search(only, name)}
    return want | ({"tier"} if "tables" in want else set())


def _worker(tree: pathlib.Path, inputs: pathlib.Path, dev, only: str) -> dict:
    """Time one tree's kernels on the saved inputs, on `dev`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(tree))
    import utree_tpu_torch
    from utree_tpu_torch.kernels.build import build, ptxas_usage

    if pathlib.Path(utree_tpu_torch.__file__).resolve().parent.parent != tree:
        raise SystemExit(f"imported {utree_tpu_torch.__file__}, not {tree}'s package")
    inp = torch.load(inputs)
    _, secs, report = build()
    calls = {name: make() for group, name, make in _calls(inp, dev)
             if group in inp["groups"] and re.search(only, name)}
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
    usage = {k: v for k, v in ptxas_usage(report)
             if re.search(r"probe|route|k[67]_", k)}
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
    note = _inputs(inputs, torch.device("cuda"), groups(a.only))
    runs, failed = [], []
    for tree in a.trees:
        p = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()),
                            "--worker", str(pathlib.Path(tree).resolve()), str(inputs),
                            "--only", a.only], capture_output=True, text=True)
        if p.returncode != 0:  # the other trees still run; the call fails
            print(f"kernel_ab: {tree} failed\n{p.stdout[-4000:]}\n{p.stderr[-8000:]}",
                  file=sys.stderr, flush=True)
            failed.append(tree)
            continue
        run = json.loads(p.stdout.strip().splitlines()[-1])
        run["card"] = card
        runs.append(run)
        print(json.dumps(run), flush=True)
    if not runs:
        return 1
    digests = {json.dumps({k: v["sha1"] for k, v in r["calls"].items()}) for r in runs}
    for r in runs:
        for k, v in r["ptxas"].items():
            print(f"ptxas {r['tree']}: {k}: {v}", flush=True)
    for name in runs[0]["calls"]:
        print(f"{name}: " + ", ".join(f"{r['calls'][name]['ms']:.4f}" for r in runs)
              + " ms; enqueue " + ", ".join(f"{r['calls'][name]['host_us']:.1f}" for r in runs)
              + " us; device " + ", ".join(f"{r['calls'][name]['device_ms'] * 1e3:.2f}"
                                           for r in runs)
              + " us; profiler " + ", ".join(
                  f"{sum(v['mean_us'] for v in r['calls'][name]['split'].values()):.2f}"
                  for r in runs) + " us", flush=True)
        for i, r in enumerate(runs):
            parts = r["calls"][name]["split"]
            if len(parts) > 1:  # a split tree's kernels, or a call's memsets
                print(f"  run {i}: " + "; ".join(f"{k} {v['mean_us']:.2f} us x{v['count']}"
                                                 for k, v in parts.items()), flush=True)
    pathlib.Path(a.out).parent.mkdir(exist_ok=True)
    print(note, flush=True)  # again, beside the times
    pathlib.Path(a.out).write_text(json.dumps({"card": card, "inputs": note, "runs": runs},
                                              indent=1))
    if len(digests) != 1:
        print("kernel_ab: the trees' outputs differ", file=sys.stderr)
        return 1
    if failed:
        return 1
    print(f"outputs byte-identical across {len(runs)} runs; on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
