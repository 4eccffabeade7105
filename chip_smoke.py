#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (utree_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--kmers 20000000] [--reads 262144]

Phases; each passes or the script exits non-zero:

1. card: nvidia-smi name and power limit, torch and CUDA versions;
2. build: compile the three CUDA kernels from utree_tpu_torch/csrc;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes (B=65536 reads of 150 bp, RC, hist_cap 8) on the
   phase-4 table; equality is exact (torch.equal: every output is an
   integer); both times from CUDA events;
4. end to end: GG search with RC through SearchPipeline(device="cuda") over
   bench.py's synthetic tier (--kmers k-mers, 4096 labels, displaced table
   cached in .bench_cache/) and --reads reads of 150 bp written as bench.py
   writes them; every kernel's launch count must rise during the run;
5. check: the first 2048 reads through utree_tpu.search_host (the exact host
   path) must give the same bytes as the port's lines for them.

Prints the card line, a {"kernels": [...]} JSON line and, last, the
{"ok": true, "device": {...}} line.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
ACGT = b"ACGT"
BATCH = 65536
READ_LEN = 150
LABELS = 4096
HIST_CAP = 8
CHECK_READS = 2048


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def log(msg: str):
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters runs after one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(got, want) -> int:
    """Max |got - want| over paired integer tensors; fails if not equal."""
    import torch

    err = max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
              for a, b in zip(got, want))
    if err or not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail(f"kernel disagrees with its plain version (max abs err {err})")
    return err


def make_reads(genome, rng, n: int):
    """bench.py's read mix: 150 bp sampled from the genome, 1% mutation,
    10% random reads.  Returns an (n, 150) uint8 ASCII matrix."""
    import numpy as np

    acgt = np.frombuffer(ACGT, np.uint8)
    starts = rng.integers(0, len(genome) - READ_LEN, size=n)
    reads = genome[starts[:, None] + np.arange(READ_LEN)[None, :]]
    mut = rng.random(reads.shape) < 0.01
    reads[mut] = rng.choice(acgt, size=int(mut.sum()))
    rand_rows = rng.random(n) < 0.10
    reads[rand_rows] = rng.choice(acgt, size=(int(rand_rows.sum()), READ_LEN))
    return reads


def write_fasta(path: pathlib.Path, reads) -> None:
    with open(path, "wb") as f:
        f.write(b"".join(b">r%d\n" % i + reads[i].tobytes() + b"\n"
                         for i in range(len(reads))))


def phase_kernels(dev, table, reads, index, max_iters):
    """Phase 3: K1, K2, K3 against their plain versions at B=65536."""
    import numpy as np
    import torch

    from utree_tpu_torch import lookup
    from utree_tpu_torch.classify_device import aufbau_walk, pack_vote, vote_rows

    b = min(BATCH, len(reads))
    width = 192  # the pipeline's batch width for 150 bp reads
    ascii_ = np.zeros((b, width), np.uint8)
    ascii_[:, :READ_LEN] = reads[:b]
    packed, vbits, lens = (torch.from_numpy(a).to(dev) for a in lookup.pack_reads_host(
        ascii_, np.full(b, READ_LEN, np.int32)))
    kw = dict(do_rc=True, bad_ix=0xFFFF, true_len=(READ_LEN + 7) & ~7)
    vt = {k[3:]: v for k, v in table.items() if k.startswith("vt_")}
    vkw = dict(taxacut=index.config.taxacut, max_iters=max_iters)
    L = index.num_labels
    ids = lookup.window_ids(table, packed, vbits, lens, **kw)
    hist = lookup.histogram(ids, L, HIST_CAP)
    rows = vote_rows(vt, *hist, **vkw)
    cases = [
        ("scan_probe", "scan_probe.cu", "utree_tpu/lookup.py:887",
         lambda: lookup.window_ids(table, packed, vbits, lens, **kw),
         lambda: lookup.window_ids_plain(table, packed, vbits, lens, **kw)),
        ("histogram", "histogram.cu", "utree_tpu/lookup.py:621",
         lambda: lookup.histogram(ids, L, HIST_CAP),
         lambda: lookup.compact_histogram(ids, L, HIST_CAP)),
        ("aufbau_vote", "aufbau.cu", "utree_tpu/classify_device.py:113",
         lambda: vote_rows(vt, *hist, **vkw),
         lambda: pack_vote(*aufbau_walk(vt, *hist, **vkw), hist[2], hist[3])),
    ]
    out = []
    for name, source, replaces, kernel, plain in cases:
        got, want = kernel(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max_abs_err(got, want)
        ms, plain_ms = cuda_ms(kernel, 20), cuda_ms(plain, 3)
        log(f"kernel {name}: equal to plain at B={b}; {ms:.4f} ms vs plain "
            f"{plain_ms:.4f} ms")
        out.append({"name": name, "route": "cuda",
                    "source": f"utree_tpu_torch/csrc/{source}",
                    "replaces": replaces, "launches": 0, "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms})
    flags = int(((rows[:, 0].long() >> 24) & 1).sum())
    nuniq = hist[2].long()
    log(f"batch profile: hits/read {float(hist[3].float().mean()):.2f}, "
        f"nuniq>=2 {int((nuniq >= 2).sum())}, flagged {flags} of {b}")
    return out


def run(dev, kmers: int, nreads: int, work: pathlib.Path) -> dict:
    """Phases 3-5 on `dev`; returns what main() checks and prints."""
    import torch

    import bench
    from utree_tpu.classify_device import build_aufbau_tables
    from utree_tpu.search_host import search_file as host_search_file
    from utree_tpu.utils.trace import PhaseTimer
    from utree_tpu_torch import kernels
    from utree_tpu_torch.classify_device import aufbau_tables_to_device
    from utree_tpu_torch.hash_index import displaced_to_device
    from utree_tpu_torch.pipeline import SearchPipeline

    t0 = time.perf_counter()
    index, _sw, _ixs, _labels, genome, _cfg, rng = bench.make_tier_index(kmers, LABELS)
    # bench's labels carry NUL bytes (its rank tokens are int64 codes turned
    # into bytes); the C formatter reads them as terminators and the Python
    # host path does not, so phase 5 could not compare the two.  Stripping
    # them gives every path the same label strings.
    index.strings = [s.replace(b"\x00", b"") for s in index.strings]
    disp = bench.load_or_build_displaced(index, kmers, LABELS, str(ROOT / ".bench_cache"))
    vtab = build_aufbau_tables(index.strings)
    max_iters = (vtab.max_len + 4) * (HIST_CAP + 2) + 16
    table = displaced_to_device(disp, dev)
    table.update({"vt_" + k: v for k, v in aufbau_tables_to_device(vtab, dev).items()})
    log(f"tier: {kmers} k-mers, {index.num_labels} labels, d1 {tuple(disp.t1.shape)}, "
        f"d3 {tuple(disp.t3.shape)}, set-up {time.perf_counter() - t0:.1f} s")
    reads = make_reads(genome, rng, nreads)
    work.mkdir(parents=True, exist_ok=True)
    reads_fa, out_txt = work / "smoke_reads.fa", work / "smoke_out.txt"
    write_fasta(reads_fa, reads)

    kern = phase_kernels(dev, table, reads, index, max_iters)

    # phase 4: the main path, twice over the same pipeline (pass 1 counts
    # the launches; pass 2 is the steady state)
    pipe = SearchPipeline(index, device=dev, do_rc=True, batch_size=BATCH,
                          hist_cap=HIST_CAP, _table=table)
    passes = []
    for p in range(2):
        pipe.tracer = PhaseTimer(quiet=True)
        if p == 0:
            kernels.reset_launches()
        t = time.perf_counter()
        n = pipe.search_file(str(reads_fa), str(out_txt))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if p == 0:
            for k in kern:
                k["launches"] = kernels.launches[k["name"]]
        if n != nreads:
            fail(f"search_file processed {n} of {nreads} reads")
        passes.append({"reads_per_s": nreads / dt, "seconds": dt,
                       "phases_s": dict(pipe.tracer.phases)})
        log(f"e2e pass {p + 1}: {nreads} reads in {dt:.3f} s = "
            f"{nreads / dt:,.0f} reads/s; phases "
            + ", ".join(f"{k} {v:.3f}s" for k, v in pipe.tracer.phases.items()))

    # phase 5: independent check against the exact host path
    port_lines = out_txt.read_bytes().splitlines(keepends=True)
    if not port_lines:
        fail("the port wrote no output lines")
    head = []
    for ln in port_lines:
        if int(ln.split(b"\t", 1)[0][1:]) >= CHECK_READS:
            break
        head.append(ln)
    sub_fa, host_out = work / "smoke_reads_check.fa", work / "smoke_host.txt"
    write_fasta(sub_fa, reads[:CHECK_READS])
    host_search_file(index.host_index(), str(sub_fa), str(host_out), do_rc=True)
    if host_out.read_bytes() != b"".join(head):
        fail(f"the port's lines for the first {CHECK_READS} reads differ from "
             "utree_tpu.search_host")
    log(f"check: first {CHECK_READS} reads ({len(head)} lines) byte-identical "
        "to utree_tpu.search_host")
    return {"kernels": kern, "passes": passes, "lines": len(port_lines)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kmers", type=int, default=20_000_000,
                    help="tier size (bench.py's headline tier is 150000000)")
    ap.add_argument("--reads", type=int, default=262_144)
    a = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    if not (ROOT / "utree_tpu_torch" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository (no utree_tpu_torch/)")
    sys.path.insert(0, str(ROOT))

    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    # phase 2: build
    from utree_tpu_torch.kernels import build, library

    so, secs, ptxas = build()
    library()
    log(f"build: {so.name} in {secs:.1f} s (0.0 = already built)")
    for ln in ptxas.splitlines():
        if "registers" in ln or "spill" in ln:
            log(f"  ptxas: {ln.strip()}")

    res = run(torch.device("cuda"), a.kmers, a.reads, ROOT / ".bench_cache")
    for k in res["kernels"]:
        if k["launches"] < 1:
            fail(f"kernel {k['name']} was not launched by the main path")
    best = max(p["reads_per_s"] for p in res["passes"])
    log(f"e2e: {best:,.0f} reads/s (best of 2 passes) at {a.kmers} k-mers, "
        f"RC, batch {BATCH}, on {card}")
    print(json.dumps({"kernels": res["kernels"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
