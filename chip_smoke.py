#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (utree_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--kmers 20000000] [--reads 262144]

Phases; each passes or the script exits non-zero:

1. card: nvidia-smi name and power limit, torch and CUDA versions;
2. build: compile the CUDA kernels from utree_tpu_torch/csrc (one nvcc per
   source, all started together);
3. kernels: K1 scan_probe, K2 histogram and K3 aufbau_vote against their
   plain PyTorch versions on the card, at the main path's shapes (B=65536
   reads of 150 bp, RC, hist_cap 8) on the phase-4 table; equality is exact
   (torch.equal: every output is an integer); both times from CUDA events;
4. end to end: GG search with RC through SearchPipeline(device="cuda") over
   the synthetic tier of bench.py's recipe (`make_tier`: --kmers k-mers,
   4096 labels, displaced table cached in .bench_cache/) and --reads reads
   of 150 bp written as bench.py writes them;
5. check: the first 2048 reads through utree_tpu_torch.search_host (the
   port's exact host path) must give the same bytes as the port's lines for
   them;
6. ladder: the same tier under lookup_mode="auto" with no table given, which
   must resolve to the canonical ladder (below 80M records); its geometry
   and build time; K4 ladder_probe against its plain version; the reads end
   to end twice; the output must equal phase 4's byte for byte and the host
   path's for the first 2048 reads;
7. wide labels: bench's tier with 70,000 labels (IXTYPE=u32): the ladder at
   --kmers k-mers under auto, and the displaced table on a 2M-k-mer tier;
   for each, the wide probe (and K2 histogram_unpacked) against the plain
   versions, a run end to end, and the host check;
8. long reads: on the phase-6 ladder, 8192 short reads mixed with 16 long
   reads of 20 kbp to 1 Mbp (about 4.3 Mbp, 1% mutation); K2
   histogram_packed (its streamed branch) against pack_hist at each long
   read's chunk shape (2-64 rows of 16,834-31,250 ids), timed at each;
   the whole output must equal the host path's; reads/s and bases/s;
9. PACKSIZE=64 + IXTYPE=u32 (BASELINE config 4): bench's recipe at k=64
   (--kmers 64-mers, 70,000 labels); `auto` must resolve to the 64-mer
   ladder and lookup_mode="displaced" gives the 64-mer displaced table; for
   each, K6 ladder_probe64 or K5 scan_probe64 and K2 histogram_unpacked
   against their plain versions at B=65536 ASCII reads (K6's bound counts
   the c64_2 and c64_3 rows its windows read, each level at most once),
   the reads end to end twice and the host check; the two outputs must be
   byte-identical; 2048
   short and 4 long reads (20-200 kbp) through the ladder, whose whole
   output must equal the host path's;
10. bsearch: the phase-4 tier under lookup_mode="bsearch" (the records on
   the card, timed, and their 16 B rows built on the host, timed apart);
   K7 bsearch_probe against its plain version at phase 3's shapes, with the
   bound of the records' 16 B rows and of the three arrays; the reads end
   to end twice; the output must equal phase 4's byte for byte;
11. compact readback: K8 hist_compact against its plain version on phase
   3's batch, and its time on 1024 of those rows; on the phase-4 tier (displaced table, RC) with the first
   131,072 reads: support_ranges=8 twice through the compact layout (K1,
   K2 histogram_packed, K8), its first 2048 reads equal to the host path at
   support 8 and every line's first five fields equal to phase 4's; the
   same with a 64-row overflow block, which redispatches every batch, byte
   for byte; support_ranges=1 with device_vote=False (compact rows, the C
   vote), whose output must equal phase 4's byte for byte;
12. xtree: a synthetic reference set (`xtree_refs`: 64 references of
   312,500 bp, one line each, about 20M pods at k=29) through the port's
   build_xtree_db, a .xtr write and read back; XtreeAligner(device="cuda")
   (the displaced table over the pods, K9 xtree_probe) and the host engine
   (device=None); K9 against its plain version at (8192, 192); ALIGN of
   262,144 queries of 150 bp (2% mutation, 10% random) with perq, ref, tax
   and cov out, twice through K9 and once through the host engine, every
   output byte-identical; the first 32,768 queries with --redistribute on
   both; queries/s of each and where the time goes;
13. hash: the phase-4 tier under lookup_mode="hash" (the legacy two-table
   hash, placed on the host and copied to the card, timed); K10 hash_probe
   against its plain version at phase 3's shapes; the reads end to end
   twice (K10, K2, K3), the output equal to phase 4's byte for byte; then
   phase 7's 2M-k-mer tier of 70,000 labels under "hash" (K10, K2
   unpacked), its output equal to phase 7's displaced run byte for byte;
14. rank-specific: search_file_shallow with RC (the host search; the
   g++/OpenMP build of csrc/host/shallow.cpp) over the phase-4 tier's host
   index and reads, reads/s; the first 2048 reads' hits from
   shallow_scan_batch equal scan_shallow_literal's, and their lines the
   Python-driven vote's (ShallowVoter over those hits);
15. routed: the phase-4 tier sharded four ways by seed bucket, the shards
   on the one card: K11-K13 against their plain versions, and K11 at 16
   owners too; the reads end to end (and at capacity 8, through the
   fallback) equal to phase 4's; the wide 2M tier's routed step against
   CPU shards;
16. data parallel: two shards of the phase-4 table on the card, equal to
   phase 4's output;
17. multi-host: two processes over gloo on the card, the merged output
   equal to phase 4's;
18. sharded: K14 ascii_pack (both modes) on phase 3's 65,536 ASCII reads;
   search_step at k=32 over the displaced, ladder, bsearch and hash tables
   of phases 4, 6, 10 and 13, each equal to window_ids on the reads packed
   on the host after the trim to L-31 windows, and search_step_hist at
   k=32 (bsearch, hash) equal to its plain rows; the replicated step on a
   (2, 1) mesh and the prefix-sharded step on (2, 4) and (1, 8) meshes
   (K15), RC on and off, equal to the single-device search_step; K15 on
   slice 0 of a 4-way ShardedIndex; the long-read histogram on a (4, 2)
   mesh over phase 8's long reads (K16) equal to bincounts of the
   single-device ids; K16 at one device's chunk of the 1 Mbp read, timed
   beside torch.bincount on the same ids;
   dryrun.dryrun_multichip(8) with the eight shards on the card (its routed
   blocks on the full (4, 2) mesh: K11-K13, K17, K18);
19. routed canonical: phase 6's ladder sharded four ways by t1 bucket
   range (`ShardedCanonicalIndex`), every shard on the card: K11 at b1
   buckets, K17 canonical_owner_probe and K18 routed_canonical_finish
   against their plain versions; the reads in four batches through the
   routed step on a (1, 4) mesh, equal to the single-device ladder's
   search_step_hist_packed rows, overflow column 0; at capacity 8 every
   row flagged; the fallback equal to the single device; on a (2, 4) mesh
   the canonical step and fallback and phase 15's displaced step and
   fallback, all equal; a ladder of phase 7's wide 2M tier through the
   _wide entry points, equal to the single device and (first 4096 reads)
   to CPU shards; each step's rate, device work only (no pipeline reaches
   these steps).

Every path run (phases 4, 6-13, 15-19) starts with every launch count at 0
and reads them just after; each kernel its path needs must have launched.
Each kernel row prints events ms and device ms; K6 and K5 (phase 9), K7
(phase 10), K10 (phase 13) and K15 (phase 18) also print ptxas's
registers, shared memory and spills.
Prints the card line, a {"kernels": [...]} JSON line and, last, the
{"ok": true, "device": {...}} line.  Imports nothing of JAX or of the JAX
package: the tier recipe, the table cache and the host oracle are the
port's own.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
ACGT = b"ACGT"
BATCH = 65536
READ_LEN = 150
LABELS = 4096
WIDE_LABELS = 70_000
WIDE_DISPLACED_KMERS = 2_000_000
HIST_CAP = 8
CHECK_READS = 2048
COMPACT_READS = 131_072  # phase 11's reads
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA's data sheet)
SECTOR = 32  # bytes of one device-memory sector
# device_ms: the device sleeps QUEUE_CYCLES (at least 50 ms at the H100's
# 1.98 GHz top clock) while the host queues the calls; QUEUE_S is the most
# queueing time trusted
QUEUE_CYCLES = 100_000_000
QUEUE_S = 0.025
LONG_SHORT_READS = 8192
LONG_READS = 16
LONG_BP = (20_000, 1_000_000)  # shortest and longest long read
LONG64_BP = (20_000, 200_000)  # phase 9's four long reads
XT_REFS, XT_REF_LEN = 64, 312_500  # phase 12's references (about 20M pods)
XT_QUERIES = 262_144
XT_REDIST_QUERIES = 32_768
XT_K = 29
XT_OUTS = ("perq", "ref", "tax", "cov")
ROUTED_SHARDS = 4  # phase 15's shards, all on the one card
MANY_SHARDS = 16  # phase 15's K11 check above 8 owners
DP_SHARDS = 2  # phase 16's
WIDE_ROUTED_CHECK = 4096  # phase 15's wide reads held to the CPU shards

# launches summed over the path runs (each one counted from 0)
PATH_LAUNCHES: dict[str, int] = {}
# (entry function, usage) from the build's ptxas report (phase 2)
PTXAS: list[tuple[str, str]] = []
# the entry points whose rows print their kernels' ptxas usage, by the
# kernel function's name in the mangled entry function
PTXAS_ROWS = {"ladder_probe64": "ladder_probe64_kernel", "scan_probe64": "scan_probe64_kernel",
              "bsearch_probe": "bsearch_probe_kernel",
              "bsearch_probe_shard": "bsearch_probe_shard_kernel",
              "hash_probe": "hash_probe_kernel", "xtree_probe": "xtree_probe_kernel",
              "aufbau_vote": "aufbau_vote_kernel", "hist_compact": "compact"}


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


def device_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters runs after one warm-up run, the
    runs queued while the device sleeps (QUEUE_CYCLES) so that they then
    run back to back: unlike cuda_ms it leaves out the host's time to
    enqueue each one, which sets cuda_ms where a call's device work is
    shorter than its wrapper.  Fails if the host took too long to queue
    them (or fn waits for the device)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    queued = time.perf_counter() - t
    end.record()
    torch.cuda.synchronize()
    if queued > QUEUE_S:
        fail(f"device_ms: queueing {iters} calls took {queued * 1e3:.1f} ms, more than "
             f"the device's {QUEUE_S * 1e3:.0f} ms sleep")
    return start.elapsed_time(end) / iters


def max_abs_err(got, want) -> int:
    """Max |got - want| over paired integer tensors; fails if not equal."""
    import torch

    err = max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
              for a, b in zip(got, want))
    if err or not all(torch.equal(a, b) for a, b in zip(got, want)):
        fail(f"kernel disagrees with its plain version (max abs err {err})")
    return err


def nbytes(*tensors) -> int:
    """Bytes of the tensors (each read or written once)."""
    return sum(t.numel() * t.element_size() for t in tensors)


def windows(lens, k: int) -> int:
    """Windows of k bases in reads of these lengths (the reads hold no N)."""
    return int((lens.long() - (k - 1)).clamp(min=0).sum())


def probe_bytes(packed, vbits, lens, ids, k: int, sectors: int, table) -> int:
    """A probe's bytes: the packed reads in, the ids out, and `sectors` 32 B
    sectors of `table`'s rows for each valid window of k bases (one row a
    window at 24 or 32 B, two at 48 B), the table read at most once."""
    return nbytes(packed, vbits, lens, ids) + min(SECTOR * sectors * windows(lens, k),
                                                  nbytes(table))


def span_sectors(first, last) -> int:
    """32 B sectors that the byte ranges [first, last] span, each counted
    once (first, last: int64 tensors of byte offsets, last >= first)."""
    import torch

    if not first.numel():
        return 0
    lo, hi = first // SECTOR, last // SECTOR
    span = torch.arange(int((hi - lo).max()) + 1, device=first.device)
    sec = lo[:, None] + span[None, :]
    return int(torch.unique(sec[sec <= hi[:, None]]).numel())


def vote_bytes(hist, vt: dict, rows) -> int:
    """K3's bytes on this batch: labels, nuniq and found read once and the
    rows written once; the counts rows of the reads of two or more labels
    only (a read of at most one is packed from labels[:, 0]), as the 32 B
    sectors they span; of `rank`, the sectors those reads' labels hit; the
    walk's other tables at most once, and only where a read walks."""
    labels, counts, nuniq, found = hist
    C = labels.shape[1]
    q = (nuniq >= 2).nonzero().flatten()
    row = C * counts.element_size()
    moved = nbytes(labels, nuniq, found, rows) + SECTOR * span_sectors(q * row, (q + 1) * row - 1)
    lab = labels[q].flatten().long()
    lab = lab[lab >= 0].clamp(max=vt["rank"].numel() - 1) * vt["rank"].element_size()
    moved += SECTOR * span_sectors(lab, lab)
    walks = (nuniq[q] <= C) & (found[q] >= 2)
    if bool(walks.any()):
        moved += nbytes(*(vt[k] for k in ("st", "slen", "semi", "und", "spos")))
    return moved


def check_kernel(name, source, replaces, kernel, plain, what: str, moved: int,
                 library=None) -> dict:
    """One entry point against its plain version; both timed with CUDA
    events (ms), the entry point also with its calls queued ahead of the
    device (device_ms, no host time).  `moved` is the bytes the function
    must move on these inputs (inputs read once, outputs written once, one
    sector per table row or record a valid window needs, each table at
    most once); its time at the card's memory rate is the row's bound.
    The work is integer compares and adds, a few per byte, far under the
    card's operation rates, so bytes bound every kernel.
    `library`, where PyTorch computes the same function (K16's bincount),
    must give the kernel's values and is timed as library_ms; elsewhere no
    PyTorch call computes it and library_ms is null.  Returns its row of
    the kernels line."""
    got, want = kernel(), plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max_abs_err(got, want)
    ms, plain_ms, dev_ms = cuda_ms(kernel, 20), cuda_ms(plain, 3), device_ms(kernel, 20)
    library_ms, lib = None, ""
    if library is not None:
        max_abs_err(got, (library().to(got[0].dtype),))
        library_ms = cuda_ms(library, 20)
        lib = f", library {library_ms:.4f} ms"
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    log(f"kernel {name}: equal to plain at {what}; {ms:.4f} ms ({dev_ms:.4f} on the "
        f"device) vs plain {plain_ms:.4f} ms{lib}; bound {bound_ms:.4f} ms "
        f"({moved:,} bytes)")
    for fn, usage in PTXAS:
        if name in PTXAS_ROWS and PTXAS_ROWS[name] in fn:
            log(f"  ptxas {name}: {fn}: {usage}")
    return {"name": name, "route": "cuda", "source": f"utree_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": library_ms}


def drive(path: str, expect, fn):
    """Run one path with every launch count set to 0 just before it and read
    just after; fail unless each kernel in `expect` launched."""
    import torch

    from utree_tpu_torch import kernels

    kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    got = dict(kernels.launches)
    missing = [k for k in expect if got[k] < 1]
    if missing:
        fail(f"{path}: kernels {missing} were not launched (counts {got})")
    for k, n in got.items():
        PATH_LAUNCHES[k] = PATH_LAUNCHES.get(k, 0) + n
    log(f"{path}: launches " + ", ".join(f"{k} {n}" for k, n in got.items() if n))
    return out


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


def batch_tensors(dev, reads, start: int = 0):
    """BATCH reads from `start` (the first by default) as the pipeline packs
    them (width 192)."""
    import numpy as np
    import torch

    from utree_tpu_torch import lookup

    b = min(BATCH, len(reads) - start)
    ascii_ = np.zeros((b, 192), np.uint8)  # the pipeline's width for 150 bp
    ascii_[:, :READ_LEN] = reads[start:start + b]
    return [torch.from_numpy(a).to(dev) for a in lookup.pack_reads_host(
        ascii_, np.full(b, READ_LEN, np.int32))]


def e2e(pipe, reads_fa, out_txt, nreads: int, path: str, expect, passes: int = 2):
    """`passes` timed runs of search_file; returns the best reads/s."""
    from utree_tpu_torch.utils.trace import PhaseTimer

    best = 0.0
    for p in range(passes):
        pipe.tracer = PhaseTimer(quiet=True)
        t = time.perf_counter()
        n = drive(f"{path} pass {p + 1}", expect,
                  lambda: pipe.search_file(str(reads_fa), str(out_txt)))
        dt = time.perf_counter() - t
        if n != nreads:
            fail(f"{path}: search_file processed {n} of {nreads} reads")
        best = max(best, nreads / dt)
        log(f"{path} pass {p + 1}: {nreads} reads in {dt:.3f} s = "
            f"{nreads / dt:,.0f} reads/s; phases "
            + ", ".join(f"{k} {v:.3f}s" for k, v in pipe.tracer.phases.items()))
    return best


def host_check(host_index, reads, out_txt, work: pathlib.Path, tag: str,
               support_ranges: int = 1) -> None:
    """The port's lines for the first CHECK_READS reads (named r<i>) must
    equal the exact host path's (utree_tpu_torch.search_host) bytes."""
    from utree_tpu_torch.search_host import search_file as host_search_file

    port_lines = out_txt.read_bytes().splitlines(keepends=True)
    if not port_lines:
        fail(f"{tag}: the port wrote no output lines")
    head = []
    for ln in port_lines:
        if int(ln.split(b"\t", 1)[0][1:]) >= CHECK_READS:
            break
        head.append(ln)
    sub_fa, host_out = work / f"{tag}_check.fa", work / f"{tag}_host.txt"
    write_fasta(sub_fa, reads[:CHECK_READS])
    host_search_file(host_index, str(sub_fa), str(host_out), do_rc=True,
                     support_ranges=support_ranges)
    if host_out.read_bytes() != b"".join(head):
        fail(f"{tag}: the port's lines for the first {CHECK_READS} reads differ "
             "from the host path's")
    log(f"{tag} check: first {CHECK_READS} reads ({len(head)} lines) "
        "byte-identical to the host path (search_host)")


def phase_kernels(dev, table, reads, index, max_iters):
    """Phase 3: K1, K2, K3 against their plain versions at B=65536."""
    from utree_tpu_torch import lookup
    from utree_tpu_torch.classify_device import VoteTables, aufbau_walk, pack_vote, vote_rows

    packed, vbits, lens = batch_tensors(dev, reads)
    b = packed.shape[0]
    L = index.num_labels
    kw = dict(do_rc=True, bad_ix=0xFFFF, true_len=(READ_LEN + 7) & ~7, num_labels=L)
    vt = {k[3:]: v for k, v in table.items() if k.startswith("vt_")}
    vkw = dict(taxacut=index.config.taxacut, max_iters=max_iters)
    prepared = VoteTables(vt)  # as SearchPipeline places them
    ids = lookup.window_ids(table, packed, vbits, lens, **kw)
    hist = lookup.histogram(ids, L, HIST_CAP)
    rows = vote_rows(prepared, *hist, **vkw)
    what = f"B={b}"
    out = [
        check_kernel("scan_probe", "scan_probe.cu", "utree_tpu/lookup.py:887",
                     lambda: lookup.window_ids(table, packed, vbits, lens, **kw),
                     lambda: lookup.window_ids_plain(table, packed, vbits, lens, **kw),
                     what, probe_bytes(packed, vbits, lens, ids, 32, 1, table["d1"])),
        check_kernel("histogram", "histogram.cu", "utree_tpu/lookup.py:621",
                     lambda: lookup.histogram(ids, L, HIST_CAP),
                     lambda: lookup.compact_histogram(ids, L, HIST_CAP), what,
                     nbytes(ids, *hist)),
        check_kernel("aufbau_vote", "aufbau.cu", "utree_tpu/classify_device.py:113",
                     lambda: vote_rows(prepared, *hist, **vkw),
                     lambda: pack_vote(*aufbau_walk(vt, *hist, **vkw), hist[2], hist[3]),
                     what, vote_bytes(hist, vt, rows)),
    ]
    flags = int(((rows[:, 0].long() >> 24) & 1).sum())
    nuniq = hist[2].long()
    log(f"batch profile: hits/read {float(hist[3].float().mean()):.2f}, "
        f"nuniq>=2 {int((nuniq >= 2).sum())}, flagged {flags} of {b}")
    return out


def phase_ladder(dev, base: dict, work: pathlib.Path):
    """Phase 6: the narrow ladder that `auto` resolves to at this size."""
    from utree_tpu_torch import lookup
    from utree_tpu_torch.pipeline import SearchPipeline

    index, reads = base["index"], base["reads"]
    t0 = time.perf_counter()
    pipe = SearchPipeline(index, device=dev, do_rc=True, batch_size=BATCH,
                          hist_cap=HIST_CAP)
    build_s = time.perf_counter() - t0
    if pipe.table_kind != "canonical":
        fail(f"auto resolved to {pipe.table_kind} at {index.num_records} records")
    t = base["k32_tables"]["c1"] = pipe._tables[0]
    geo = {k: tuple(t[k].shape) for k in ("c1", "c2", "c3")}
    log(f"ladder: auto -> canonical at {index.num_records:,} records; built in "
        f"{build_s:.1f} s; slots {geo['c1'][1] // 3}/{geo['c2'][1] // 3}/"
        f"{geo['c3'][1] // 3}; c1 {geo['c1']}, c2 {geo['c2']}, c3 {geo['c3']}")
    packed, vbits, lens = batch_tensors(dev, reads)
    kw = dict(do_rc=True, bad_ix=0xFFFF, true_len=(READ_LEN + 7) & ~7,
              num_labels=index.num_labels)
    ids = lookup.window_ids(t, packed, vbits, lens, **kw)
    row = check_kernel("ladder_probe", "ladder_probe.cu", "utree_tpu/lookup.py:349",
                       lambda: lookup.window_ids(t, packed, vbits, lens, **kw),
                       lambda: lookup.window_ids_plain(t, packed, vbits, lens, **kw),
                       f"B={packed.shape[0]}", probe_bytes(packed, vbits, lens, ids, 32, 1,
                                                           t["c1"]))
    out_txt = work / "smoke_ladder.txt"
    rps = e2e(pipe, base["reads_fa"], out_txt, len(reads), "ladder e2e",
              ("ladder_probe", "histogram", "aufbau_vote"))
    if out_txt.read_bytes() != base["out_txt"].read_bytes():
        fail("the ladder's output differs from the displaced table's")
    log("ladder: whole output byte-identical to the displaced run (phase 4)")
    host_check(base["host"], reads, out_txt, work, "ladder")
    return pipe, row, {"reads_per_s": rps, "build_s": build_s, "geometry": geo}


def tier_labels(rng, labels: int) -> list[bytes]:
    """bench.py's region labels (8 ranks of a 4-letter token and the region
    number mod 97), drawn from `rng` as bench.py draws them.  bench.py makes
    its tokens' bytes from an int64 array, so its labels carry NUL bytes,
    which the C formatter reads as terminators and the Python host path does
    not; they are stripped here, so that every path sees the same strings."""
    ranks = b"kpcofgst"
    out = []
    for i in range(labels):
        tok = bytes(97 + rng.integers(0, 26, size=4))  # int64 bytes, as bench.py
        out.append(b";".join(ranks[d:d + 1] + b"__" + tok + str(i % 97).encode()
                             for d in range(8)).replace(b"\x00", b""))
    return out


def tier_kmers(kmers: int, labels: int):
    """bench.py's synthetic tier (its make_tier_index recipe): a genome of
    kmers+31 bases (rng seed 0), its dense 32-mer set sorted and
    de-duplicated, `labels` contiguous regions of one label each (a read
    hits about one label, two near a border).  Returns (sorted words, their
    label ids, genome, rng); the rng draws tier_labels next."""
    import numpy as np

    from utree_tpu_torch.encode import sample_build_kmers

    rng = np.random.default_rng(0)
    genome = rng.choice(np.frombuffer(ACGT, np.uint8), size=kmers + 31).astype(np.uint8)
    words = sample_build_kmers(genome.tobytes(), 32, 0)
    pos_labels = (np.arange(len(words), dtype=np.int64) * labels) // len(words)
    order = np.argsort(words, kind="stable")
    sw = words[order]
    keep = np.ones(len(sw), bool)
    keep[1:] = sw[1:] != sw[:-1]
    return sw[keep], pos_labels[order][keep], genome, rng


def make_tier(kmers: int, labels: int, ixtype_bytes: int = 2):
    """The tier of tier_kmers as an index (IXTYPE=u32 for wide labels).
    Returns (index, genome, rng)."""
    from utree_tpu_torch.config import UTreeConfig
    from utree_tpu_torch.index import DeviceIndexArrays

    sw, ixs, genome, rng = tier_kmers(kmers, labels)
    index = DeviceIndexArrays.from_build(sw, ixs, tier_labels(rng, labels),
                                         UTreeConfig(ixtype_bytes=ixtype_bytes))
    return index, genome, rng


def load_or_build_displaced(index, kmers: int, labels: int, cache: pathlib.Path):
    """The tier's displaced table (hash_index.build_displaced_index), loaded
    from its npz cache or placed and cached (bench.py's cache: same file
    name and fields)."""
    import numpy as np

    from utree_tpu_torch.hash_index import DisplacedHashArrays, build_displaced_index

    f = cache / f"disp_{kmers}_{labels}.npz"
    if f.exists():
        z = np.load(f)
        log(f"displaced table loaded from {f}")
        return DisplacedHashArrays(t1=z["t1"], seeds=z["seeds"], t3=z["t3"],
                                   slots3=int(z["slots3"]), num_entries=int(z["ne"]),
                                   wide=bool(z["wide"]))
    t = time.perf_counter()
    disp = build_displaced_index(index)
    log(f"displaced placement took {time.perf_counter() - t:.1f} s")
    cache.mkdir(parents=True, exist_ok=True)
    np.savez(f, t1=disp.t1, seeds=disp.seeds, t3=disp.t3, slots3=disp.slots3,
             ne=disp.num_entries, wide=disp.wide)
    return disp


def lowest_bin_drop(words) -> int:
    """How many of the first sorted, de-duplicated W128 words index64 drops.
    The 64-mer table builders (the port's and the JAX package's alike) raise
    OverflowError when the lowest populated prefix bin holds a single record
    whose suffix is not below the next bin's first one (ROADMAP §C): the
    reference folds that record into the next bin, and the builders' slow
    path for the unsorted bin this makes shifts an np.int64 by 104 bits.  So
    while the lowest bin holds one such record, that k-mer is dropped from
    the DB; reads that hit it then miss in every path alike."""
    import numpy as np

    hi, lo = words["hi"], words["lo"]
    pre, suf = hi >> np.uint64(40), hi & np.uint64((1 << 40) - 1)
    drop = 0
    while (len(words) - drop > 1 and pre[drop] != pre[drop + 1]
           and (suf[drop], lo[drop]) >= (suf[drop + 1], lo[drop + 1])):
        log(f"tier64: dropped k-mer {drop} (alone in prefix bin {int(pre[drop])}, "
            "it would unsort the next bin), working around the 64-mer "
            "builders' fault, ROADMAP §C")
        drop += 1
    return drop


def index64(words, ixs, strings, ixtype_bytes: int = 4):
    """DeviceIndexArrays.from_build of a PACKSIZE=64 DB (IXTYPE=u32 unless
    asked) from sorted, de-duplicated W128 words, less the lowest_bin_drop
    first ones."""
    from utree_tpu_torch.config import UTreeConfig
    from utree_tpu_torch.index import DeviceIndexArrays

    drop = lowest_bin_drop(words)
    return DeviceIndexArrays.from_build(
        words[drop:], ixs[drop:], strings,
        UTreeConfig(packsize=64, ixtype_bytes=ixtype_bytes))


def tier64(kmers: int, labels: int):
    """bench.py's tier recipe at k=64 (BASELINE config 4): a genome
    of kmers+63 bases (rng seed 0), its dense 64-mer set sorted and
    de-duplicated, `labels` region labels with NUL bytes stripped, as an
    IXTYPE=u32 index (index64).  Returns (index, genome, rng)."""
    import numpy as np

    from utree_tpu_torch.encode import sample_build_kmers

    rng = np.random.default_rng(0)
    genome = rng.choice(np.frombuffer(ACGT, np.uint8), size=kmers + 63).astype(np.uint8)
    words = sample_build_kmers(genome.tobytes(), 64, 0)
    pos_labels = (np.arange(len(words), dtype=np.int64) * labels) // len(words)
    order = np.lexsort((words["lo"], words["hi"]))
    sw = words[order]
    keep = np.ones(len(sw), bool)
    keep[1:] = (sw["hi"][1:] != sw["hi"][:-1]) | (sw["lo"][1:] != sw["lo"][:-1])
    return (index64(sw[keep], pos_labels[order][keep], tier_labels(rng, labels)),
            genome, rng)


def phase_wide(dev, kmers: int, base: dict, work: pathlib.Path):
    """Phase 7: wide labels on the ladder (--kmers, auto) and on the
    displaced table (2M k-mers)."""
    from utree_tpu_torch import lookup
    from utree_tpu_torch.pipeline import SearchPipeline

    rows, stats = [], {}
    for kind, n_kmers in (("ladder", kmers), ("displaced", WIDE_DISPLACED_KMERS)):
        t0 = time.perf_counter()
        index, genome, rng = make_tier(n_kmers, WIDE_LABELS, ixtype_bytes=4)
        pipe = SearchPipeline(index, device=dev, do_rc=True, batch_size=BATCH,
                              hist_cap=HIST_CAP,
                              lookup_mode="auto" if kind == "ladder" else "displaced")
        build_s = time.perf_counter() - t0
        if pipe.table_kind != ("canonical" if kind == "ladder" else "displaced"):
            fail(f"wide {kind}: resolved to {pipe.table_kind}")
        if pipe.layout != "unpacked":
            fail(f"wide {kind}: layout {pipe.layout}, expected unpacked")
        t = pipe._tables[0]
        log(f"wide {kind}: {index.num_labels} labels, {n_kmers} k-mers, set-up "
            f"{build_s:.1f} s, " + ", ".join(f"{k} {tuple(v.shape)}" for k, v in t.items()))
        if kind == "ladder":
            reads, reads_fa = base["reads"], base["reads_fa"]
        else:
            reads = make_reads(genome, rng, len(base["reads"]))
            reads_fa = work / "smoke_wide_reads.fa"
            write_fasta(reads_fa, reads)
        packed, vbits, lens = batch_tensors(dev, reads)
        L = index.num_labels
        kw = dict(do_rc=True, bad_ix=0x7FFFFFFF, true_len=(READ_LEN + 7) & ~7,
                  num_labels=L)
        name, source, replaces = (
            ("ladder_probe_wide", "ladder_probe.cu", "utree_tpu/lookup.py:349")
            if kind == "ladder" else
            ("scan_probe_wide", "scan_probe.cu", "utree_tpu/lookup.py:887"))
        what = f"B={packed.shape[0]}, {L} labels"
        ids = lookup.window_ids(t, packed, vbits, lens, **kw)
        rows.append(check_kernel(
            name, source, replaces,
            lambda: lookup.window_ids(t, packed, vbits, lens, **kw),
            lambda: lookup.window_ids_plain(t, packed, vbits, lens, **kw), what,
            probe_bytes(packed, vbits, lens, ids, 32, 1, t["d1" if "d1" in t else "c1"])))
        if kind == "ladder":
            hist = lookup.histogram_unpacked(ids, L, HIST_CAP)
            rows.append(check_kernel(
                "histogram_unpacked", "histogram.cu", "utree_tpu/lookup.py:820",
                lambda: lookup.histogram_unpacked(ids, L, HIST_CAP),
                lambda: lookup.unpacked_hist(ids, L, HIST_CAP), what, nbytes(ids, hist)))
        out_txt = work / f"smoke_wide_{kind}.txt"
        rps = e2e(pipe, reads_fa, out_txt, len(reads), f"wide {kind} e2e",
                  (name, "histogram_unpacked"))
        host_check(index.host_index(), reads, out_txt, work, f"wide_{kind}")
        stats[kind] = {"reads_per_s": rps, "setup_s": build_s}
        del pipe, t
    return rows, stats


def long_reads(genome) -> list[bytes]:
    """Phase 8's LONG_READS long reads, LONG_BP[0] to LONG_BP[1] bp on a
    geometric scale, sampled from the genome with 1% mutation (seed 8)."""
    import numpy as np

    rng = np.random.default_rng(8)
    acgt = np.frombuffer(ACGT, np.uint8)
    longs = []
    for size in np.geomspace(*LONG_BP, LONG_READS).astype(np.int64):
        s = int(rng.integers(0, len(genome) - size))
        seq = genome[s:s + size].copy()
        mut = rng.random(size) < 0.01
        seq[mut] = rng.choice(acgt, int(mut.sum()))
        longs.append(seq.tobytes())
    return longs


def long_read_chunks(dev, seq: bytes, k: int, long_chunk: int):
    """One long read cut and packed as SearchPipeline.classify_long_read
    hands it to the histogram step: a power-of-two count of chunks of at
    most `long_chunk` windows, padded to a multiple of 8 positions.
    Returns (packed, vbits, lens) on `dev`."""
    import numpy as np
    import torch

    from utree_tpu_torch import lookup
    from utree_tpu_torch.parallel.sharded import split_long_read

    n_chunks = 1
    while n_chunks * long_chunk < len(seq) - k + 1:
        n_chunks *= 2
    chunks, clens = split_long_read(seq, n_chunks, k)
    chunks = np.pad(chunks, ((0, 0), (0, (-chunks.shape[1]) % 8)))
    return [torch.from_numpy(a).to(dev) for a in lookup.pack_reads_host(chunks, clens)]


def phase_long(dev, pipe, base: dict, work: pathlib.Path):
    """Phase 8: long reads mixed with short ones on the phase-6 ladder."""
    import numpy as np

    from utree_tpu_torch import lookup
    from utree_tpu_torch.search_host import search_file as host_search_file
    from utree_tpu_torch.utils.trace import PhaseTimer

    genome, index = base["genome"], base["index"]
    longs = long_reads(genome)
    sizes = np.array([len(s) for s in longs], np.int64)
    base["long_reads"] = longs
    shorts = base["reads"][:LONG_SHORT_READS]
    every = LONG_SHORT_READS // LONG_READS
    reads_fa = work / "smoke_long_reads.fa"
    with open(reads_fa, "wb") as f:
        for i in range(LONG_SHORT_READS):
            f.write(b">r%d\n" % i + shorts[i].tobytes() + b"\n")
            if i % every == every // 2:
                f.write(b">long%d\n" % (i // every) + longs[i // every] + b"\n")
    nreads = LONG_SHORT_READS + LONG_READS
    bases = int(sizes.sum()) + LONG_SHORT_READS * READ_LEN
    log(f"long reads: {LONG_READS} of {sizes.min():,}-{sizes.max():,} bp "
        f"({int(sizes.sum()):,} bp) among {LONG_SHORT_READS} short reads")

    # histogram_packed at each long read's chunk shape (the streamed branch,
    # 2-64 rows): equal to pack_hist at every shape and timed at each; the
    # row is the 1 Mbp read's 64 chunks, with the 20 kbp read's 2 chunks
    # checked the same way and every shape's time under "shapes"
    k, L = index.config.packsize, index.num_labels
    shapes, rows = [], {}
    for i, seq in enumerate(longs):
        ids = lookup.window_ids(pipe._tables[0], *long_read_chunks(dev, seq, k, pipe.long_chunk),
                                do_rc=True, bad_ix=0xFFFF, num_labels=L)
        out = lookup.histogram_packed(ids, L, HIST_CAP)
        moved = nbytes(ids, out)
        what = f"{len(seq):,} bp read: {ids.shape[0]} chunks x {ids.shape[1]} ids"
        if i in (0, len(longs) - 1):
            rows[i] = check_kernel("histogram_packed", "histogram.cu",
                                   "utree_tpu/lookup.py:811",
                                   lambda: lookup.histogram_packed(ids, L, HIST_CAP),
                                   lambda: lookup.pack_hist(ids, L, HIST_CAP), what, moved)
            ms, dms = rows[i]["ms"], rows[i]["device_ms"]
        else:
            max_abs_err((out,), (lookup.pack_hist(ids, L, HIST_CAP),))
            ms = cuda_ms(lambda: lookup.histogram_packed(ids, L, HIST_CAP), 20)
            dms = device_ms(lambda: lookup.histogram_packed(ids, L, HIST_CAP), 20)
        shapes.append({"rows": ids.shape[0], "ids": ids.shape[1], "ms": ms,
                       "device_ms": dms, "bound_ms": moved / HBM_BYTES_PER_S * 1e3})
    del ids, out
    row = rows[len(longs) - 1]
    row["shapes"] = shapes
    log("histogram_packed at phase 8's launch shapes (rows x ids: ms, device ms): "
        + ", ".join(f"{s['rows']} x {s['ids']:,}: {s['ms']:.4f}, {s['device_ms']:.4f}"
                    for s in shapes)
        + f"; plain {rows[0]['plain_ms']:.4f} ms at the shortest read's shape")
    out_txt = work / "smoke_long.txt"
    pipe.tracer = PhaseTimer(quiet=True)
    t = time.perf_counter()
    n = drive("long reads", ("ladder_probe", "histogram", "aufbau_vote",
                             "histogram_packed"),
              lambda: pipe.search_file(str(reads_fa), str(out_txt)))
    dt = time.perf_counter() - t
    if n != nreads:
        fail(f"long reads: search_file processed {n} of {nreads} reads")
    log(f"long reads e2e: {nreads} reads ({bases:,} bp) in {dt:.3f} s = "
        f"{nreads / dt:,.0f} reads/s, {bases / dt:,.0f} bases/s; phases "
        + ", ".join(f"{k} {v:.3f}s" for k, v in pipe.tracer.phases.items()))
    host_out = work / "smoke_long_host.txt"
    t = time.perf_counter()
    host_search_file(base["host"], str(reads_fa), str(host_out), do_rc=True)
    if host_out.read_bytes() != out_txt.read_bytes():
        fail("long reads: the port's output differs from the host path's")
    log(f"long reads check: whole output ({len(host_out.read_bytes().splitlines())} "
        f"lines) byte-identical to the host path ({time.perf_counter() - t:.1f} s)")
    return row, {"reads_per_s": nreads / dt, "bases_per_s": bases / dt, "seconds": dt}


def phase_k64(dev, kmers: int, nreads: int, work: pathlib.Path):
    """Phase 9: PACKSIZE=64 + IXTYPE=u32 (BASELINE config 4) on the 64-mer
    ladder (`auto`) and the 64-mer displaced table; a long-read file on the
    ladder."""
    import numpy as np
    import torch

    from utree_tpu_torch import lookup
    from utree_tpu_torch.pipeline import SearchPipeline

    t0 = time.perf_counter()
    index, genome, rng = tier64(kmers, WIDE_LABELS)
    log(f"tier64: {index.num_records:,} 64-mers, {index.num_labels} labels, "
        f"set-up {time.perf_counter() - t0:.1f} s")
    reads = make_reads(genome, rng, nreads)
    reads_fa = work / "smoke64_reads.fa"
    write_fasta(reads_fa, reads)
    host = index.host_index()
    b = min(BATCH, nreads)
    ascii_ = np.zeros((b, 192), np.uint8)  # the pipeline's width for 150 bp
    ascii_[:, :READ_LEN] = reads[:b]
    rt = torch.from_numpy(ascii_).to(dev)
    lt = torch.full((b,), READ_LEN, dtype=torch.int32, device=dev)
    L = index.num_labels
    kw = dict(do_rc=True, bad_ix=0x7FFFFFFF)
    rows, stats, outs = [], {}, {}
    for mode, kind, name in (("auto", "canonical64", "ladder_probe64"),
                             ("displaced", "displaced64", "scan_probe64")):
        t = time.perf_counter()
        pipe = SearchPipeline(index, device=dev, do_rc=True, batch_size=BATCH,
                              hist_cap=HIST_CAP, lookup_mode=mode)
        build_s = time.perf_counter() - t
        if pipe.table_kind != kind or pipe.layout != "unpacked":
            fail(f"k64 {mode}: resolved to {pipe.table_kind}, layout {pipe.layout}")
        tab = pipe._tables[0]
        log(f"k64 {kind}: table built in {build_s:.1f} s, "
            + ", ".join(f"{k} {tuple(v.shape)}" for k, v in tab.items()))
        what = f"B={b} ASCII reads, L=192, {L} labels"
        ids = lookup.window_ids64(tab, rt, lt, **kw)
        # a 64-mer slot row is 48 B: two sectors a window; on the ladder
        # the windows c64_1 does not hold read a c64_2 row (and c64_3);
        # each level at most once
        first = tab["c64_1" if mode == "auto" else "d64_1"]
        moved = nbytes(rt, lt, ids) + min(SECTOR * 2 * windows(lt, 64), nbytes(first))
        if mode == "auto":
            reach = ladder64_reach(tab, rt, lt)
            for k in ("c64_2", "c64_3"):
                rb = tab[k].shape[1] * 4  # row bytes
                moved += min(reach[k] * SECTOR * -(-rb // SECTOR), nbytes(tab[k]))
            log(f"k64 {kind}: {windows(lt, 64):,} valid windows, {reach['c64_2']:,} read "
                f"c64_2, {reach['c64_3']:,} read c64_3 (the plain levels)")
        rows.append(check_kernel(
            name, f"{name}.cu", "utree_tpu/lookup.py:" + ("460" if mode == "auto" else "521"),
            lambda: lookup.window_ids64(tab, rt, lt, **kw),
            lambda: lookup.window_ids64_plain(tab, rt, lt, **kw), what, moved))
        check_kernel("histogram_unpacked", "histogram.cu", "utree_tpu/lookup.py:662",
                     lambda: lookup.histogram_unpacked(ids, L, HIST_CAP),
                     lambda: lookup.unpacked_hist(ids, L, HIST_CAP), what + f", {kind} ids",
                     nbytes(ids, lookup.histogram_unpacked(ids, L, HIST_CAP)))
        out_txt = work / f"smoke64_{kind}.txt"
        rps = e2e(pipe, reads_fa, out_txt, nreads, f"k64 {kind} e2e",
                  (name, "histogram_unpacked"))
        host_check(host, reads, out_txt, work, f"k64_{kind}")
        outs[kind] = out_txt.read_bytes()
        stats[kind] = {"reads_per_s": rps, "table_s": build_s}
        if mode == "auto":
            stats["long"] = long64(pipe, genome, reads, host, work)
        del pipe, tab, ids
    if outs["canonical64"] != outs["displaced64"]:
        fail("k64: the ladder's and the displaced table's outputs differ")
    log("k64: the two tables' whole outputs are byte-identical")
    return rows, stats


def ladder64_reach(tab: dict, reads, lens) -> dict:
    """Valid windows whose key c64_1 does not hold (they read a c64_2 row)
    and those no earlier level holds (a c64_3 row), by the plain functions;
    0 for an absent (8-row) level, which is never read."""
    from utree_tpu_torch import lookup as lk
    from utree_tpu_torch._u32 import i32

    k0, k1, k2, k3, valid = lk.extract_windows64(lk.base_codes(reads, lens))
    *c, _ = lk.canonicalize64(k0, k1, k2, k3)
    ci = [i32(x) for x in c]

    def missed(k, h):
        t = tab[k]
        va, vb = lk.probe_rows64(t[h & (t.shape[0] - 1)], ci, t.shape[1] // 6)
        return (va | vb) == 0

    miss = valid & missed("c64_1", lk._fold64(c))
    present = {k: tab[k].shape[0] > 8 for k in ("c64_2", "c64_3")}
    out = {"c64_2": int(miss.sum()) if present["c64_2"] else 0}
    if present["c64_2"]:
        miss &= missed("c64_2", lk.mix4(*c, 0x5BD1E995))
    out["c64_3"] = int(miss.sum()) if present["c64_3"] else 0
    return out


def bsearch_bins(bin_ix, packed, vbits, lens, true_len: int) -> dict:
    """The batch's words (both strands) by the size of their prefix bin, by
    the plain functions: invalid, empty bin, one record, more."""
    from utree_tpu_torch import lookup as lk

    p, v = lk._trim(packed, vbits, true_len)
    qpre, qhi, qlo, valid = lk.extract_windows(lk.base_codes_packed(p, v, lens))
    out = {"invalid": 2 * int((~valid).sum()), "empty": 0, "one": 0, "more": 0}
    for pre in (qpre, lk.rc_word_lanes(qpre, qhi, qlo)[0]):
        pre = pre[valid]
        size = bin_ix[pre + 1].long() - bin_ix[pre].long()
        for k, m in (("empty", size == 0), ("one", size == 1), ("more", size > 1)):
            out[k] += int(m.sum())
    return out


def long64(pipe, genome, reads, host, work: pathlib.Path) -> dict:
    """Phase 9's long-read file: CHECK_READS short reads and 4 long reads of
    LONG64_BP (1% mutation) through the PACKSIZE=64 ladder; the whole output
    must equal the host path's."""
    import numpy as np

    from utree_tpu_torch.search_host import search_file as host_search_file

    rng = np.random.default_rng(9)
    acgt = np.frombuffer(ACGT, np.uint8)
    longs = []
    for size in np.geomspace(*LONG64_BP, 4).astype(np.int64):
        s = int(rng.integers(0, len(genome) - size))
        seq = genome[s:s + size].copy()
        mut = rng.random(size) < 0.01
        seq[mut] = rng.choice(acgt, int(mut.sum()))
        longs.append(seq.tobytes())
    reads_fa = work / "smoke64_long.fa"
    with open(reads_fa, "wb") as f:
        for i in range(CHECK_READS):
            f.write(b">r%d\n" % i + reads[i].tobytes() + b"\n")
            if i % 512 == 256:
                f.write(b">long%d\n" % (i // 512) + longs[i // 512] + b"\n")
    out_txt, host_out = work / "smoke64_long.txt", work / "smoke64_long_host.txt"
    t = time.perf_counter()
    drive("k64 long reads", ("ladder_probe64", "histogram_unpacked"),
          lambda: pipe.search_file(str(reads_fa), str(out_txt)))
    dt = time.perf_counter() - t
    bases = sum(map(len, longs)) + CHECK_READS * READ_LEN
    host_search_file(host, str(reads_fa), str(host_out), do_rc=True)
    if host_out.read_bytes() != out_txt.read_bytes():
        fail("k64 long reads: the port's output differs from the host path's")
    log(f"k64 long reads: {CHECK_READS} short + 4 long reads ({bases:,} bp) in "
        f"{dt:.3f} s = {bases / dt:,.0f} bases/s; whole output "
        f"({len(out_txt.read_bytes().splitlines())} lines) byte-identical to "
        "the host path")
    return {"bases_per_s": bases / dt, "seconds": dt}


def phase_bsearch(dev, base: dict, work: pathlib.Path):
    """Phase 10: the bsearch replay over the phase-4 tier's CTR records."""
    import torch

    from utree_tpu_torch import lookup
    from utree_tpu_torch.hash_index import bsearch_records
    from utree_tpu_torch.pipeline import SearchPipeline

    index, reads = base["index"], base["reads"]
    t = time.perf_counter()
    pipe = SearchPipeline(index, device=dev, do_rc=True, batch_size=BATCH,
                          hist_cap=HIST_CAP, lookup_mode="bsearch")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    if pipe.table_kind != "bsearch" or pipe.layout != "vote":
        fail(f"bsearch: resolved to {pipe.table_kind}, layout {pipe.layout}")
    tab = base["k32_tables"]["bsearch"] = pipe._tables[0]
    place_s = time.perf_counter() - t
    t = time.perf_counter()
    bsearch_records(index)
    log(f"bsearch: the pipeline built, its records on the card, in {place_s:.2f} s; "
        f"their 16 B rows rec ({nbytes(tab['rec']):,} bytes) take "
        f"{time.perf_counter() - t:.2f} s of that to build on the host (timed again "
        f"alone); probe_iters {index.probe_iters}, " + ", ".join(
            f"{k} {tuple(v.shape)}" for k, v in tab.items() if not k.startswith("vt_")))
    packed, vbits, lens = batch_tensors(dev, reads)
    kw = dict(do_rc=True, bad_ix=0xFFFF, true_len=(READ_LEN + 7) & ~7,
              num_labels=index.num_labels, probe_iters=index.probe_iters)
    ids = lookup.window_ids(tab, packed, vbits, lens, **kw)
    # each valid word (both strands) reads a bin offset, each whose bin is
    # not empty the record its descent ends on, each table at most once:
    # K7's 16 B records, or, as the plain version reads them, the three
    # arrays (a found word's id sector apart from its suffix's)
    bins = bsearch_bins(tab["bin_ix"], packed, vbits, lens, kw["true_len"])
    words, hit = sum(bins[k] for k in ("empty", "one", "more")), bins["one"] + bins["more"]
    moved = nbytes(packed, vbits, lens, ids) + min(nbytes(tab["bin_ix"]), SECTOR * words)
    arrays = moved + sum(min(nbytes(tab[k]), SECTOR * hit) for k in ("suf_hi", "suf_lo", "ix"))
    moved += min(nbytes(tab["rec"]), SECTOR * hit)
    log(f"bsearch: valid words by bin size {bins}; the three arrays' layout moves "
        f"{arrays:,} bytes, a bound of {arrays / HBM_BYTES_PER_S * 1e3:.4f} ms")
    row = check_kernel("bsearch_probe", "bsearch_probe.cu", "utree_tpu/lookup.py:149",
                       lambda: lookup.window_ids(tab, packed, vbits, lens, **kw),
                       lambda: lookup.window_ids_plain(tab, packed, vbits, lens, **kw),
                       f"B={packed.shape[0]}", moved)
    out_txt = work / "smoke_bsearch.txt"
    rps = e2e(pipe, base["reads_fa"], out_txt, len(reads), "bsearch e2e",
              ("bsearch_probe", "histogram", "aufbau_vote"))
    if out_txt.read_bytes() != base["out_txt"].read_bytes():
        fail("the bsearch replay's output differs from the displaced table's")
    log("bsearch: whole output byte-identical to the displaced run (phase 4)")
    return row, {"reads_per_s": rps}


def phase_compact(dev, base: dict, work: pathlib.Path):
    """Phase 11: the compact readback (K8) and support_ranges=8 on the
    phase-4 tier (displaced table, RC), with its first COMPACT_READS reads."""
    from utree_tpu_torch import kernels, lookup
    from utree_tpu_torch.pipeline import SearchPipeline

    index = base["index"]
    table = {k: v for k, v in base["table"].items() if not k.startswith("vt_")}
    L = index.num_labels
    # (a) K8 against its plain version on phase 3's batch
    packed, vbits, lens = batch_tensors(dev, base["reads"])
    rows = lookup.histogram_packed(lookup.window_ids(
        table, packed, vbits, lens, do_rc=True, bad_ix=0xFFFF,
        true_len=(READ_LEN + 7) & ~7, num_labels=L), L, HIST_CAP)
    over_cap = max(64, BATCH // 8)
    vec = lookup.hist_compact(rows, over_cap)
    row = check_kernel("hist_compact", "hist_compact.cu", "utree_tpu/lookup.py:726",
                       lambda: lookup.hist_compact(rows, over_cap),
                       lambda: lookup.compact_rows(rows, over_cap),
                       f"B={rows.shape[0]}, cap {HIST_CAP}, over_cap {over_cap}",
                       nbytes(rows, vec))
    log(f"compact readback: {vec.numel():,} int32 ({nbytes(vec):,} B) against "
        f"{nbytes(rows):,} B of full rows; n_over {int(vec[2 * rows.shape[0]])}")
    # K8 on a 64th of the batch: about the full batch's time where its
    # launch, not its bytes, sets it
    small = rows[:1024].contiguous()
    small_ms = cuda_ms(lambda: lookup.hist_compact(small, 64), 20)
    small_dev = device_ms(lambda: lookup.hist_compact(small, 64), 20)
    log(f"kernel hist_compact at B=1024, over_cap 64: {small_ms:.4f} ms ({small_dev:.4f} "
        f"on the device; B={rows.shape[0]}: {row['ms']:.4f} ms, {row['device_ms']:.4f})")

    reads = base["reads"][:COMPACT_READS]
    n = len(reads)
    reads_fa = work / "smoke_compact_reads.fa"
    write_fasta(reads_fa, reads)
    # phase 4's lines of these reads
    want = [ln for ln in base["out_txt"].read_bytes().splitlines(keepends=True)
            if int(ln.split(b"\t", 1)[0][1:]) < n]
    expect = ("scan_probe", "histogram_packed", "hist_compact")

    def pipeline(**kw):
        pipe = SearchPipeline(index, device=dev, do_rc=True, batch_size=BATCH,
                              hist_cap=HIST_CAP, lookup_mode="displaced",
                              _table=table, **kw)
        if pipe.layout != "compact":
            fail(f"compact {kw}: layout {pipe.layout}")
        return pipe

    # (b) support_ranges=8 end to end, twice
    out8 = work / "smoke_support8.txt"
    rps8 = e2e(pipeline(support_ranges=8), reads_fa, out8, n, "support-8 e2e", expect)
    host_check(base["host"], reads, out8, work, "support8", support_ranges=8)
    got = out8.read_bytes().splitlines(keepends=True)
    if len(got) != len(want):
        fail(f"support 8: {len(got)} lines, phase 4 has {len(want)} for these reads")
    for g, w in zip(got, want):
        f = g.split(b"\t")
        if (len(f) == 12 and b"\t".join(f[:5]) + b"\n" != w) or (len(f) == 5 and g != w) \
                or len(f) not in (5, 12):
            fail(f"support 8: line {g[:80]!r} disagrees with phase 4's {w[:80]!r}")
    log(f"support 8: whole output ({len(got)} lines) agrees with phase 4 in its "
        "first five fields")

    # (c) a 64-row block: every batch overflows it and is redispatched
    out_c = work / "smoke_support8_redispatch.txt"
    e2e(pipeline(support_ranges=8, compact_over_cap=64), reads_fa, out_c, n,
        "support-8 redispatch e2e", expect, passes=1)
    batches = kernels.launches["hist_compact"]
    if kernels.launches["histogram_packed"] != 2 * batches:
        fail(f"redispatch: {kernels.launches['histogram_packed']} histogram_packed "
             f"launches for {batches} compact batches")
    if out_c.read_bytes() != out8.read_bytes():
        fail("support 8: the redispatched output differs")
    log(f"support 8 redispatch: all {batches} batches redispatched; output "
        "byte-identical")

    # (d) support_ranges=1 without the device vote: compact rows, the C vote
    out1 = work / "smoke_compact_cvote.txt"
    rps1 = e2e(pipeline(device_vote=False), reads_fa, out1, n, "compact C-vote e2e",
               expect)
    if out1.read_bytes() != b"".join(want):
        fail("compact + C vote: output differs from phase 4's")
    log("compact + C vote: whole output byte-identical to phase 4's lines")
    return row, {"support8_reads_per_s": rps8, "cvote_reads_per_s": rps1,
                 "readback_bytes": nbytes(vec), "full_bytes": nbytes(rows)}


def xtree_refs(refs_fa: pathlib.Path, map_path: pathlib.Path, refs: int,
               ref_len: int, seed: int = 5, lineages: int = 10):
    """A synthetic xtree reference set, as utree_tpu.testdata.make_toy_db
    lays it out: `refs` random references of ref_len bases (0.2% N), one
    line each, every odd one sharing its first third with the one before
    (shared pods: ambiguous runs, deep calls); a 3-column map of
    `lineages` six-rank lineages with a species each and `func__<i % 4>`.
    Returns the (refs, ref_len) uint8 genomes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    genomes = rng.choice(np.frombuffer(ACGT, np.uint8), (refs, ref_len))
    genomes[rng.random(genomes.shape) < 0.002] = ord("N")
    for i in range(1, refs, 2):
        genomes[i, :ref_len // 3] = genomes[i - 1, :ref_len // 3]
    with open(refs_fa, "wb") as fa, open(map_path, "wb") as mp:
        for i in range(refs):
            lin = i % lineages
            tax = (b"k__Bacteria;p__phy%d;c__cls%d;o__ord%d;f__fam%d;g__gen%d;s__sp%d"
                   % (lin % 3, lin % 5, lin, lin, lin, i))
            fa.write(b">ref%04d\n" % i + genomes[i].tobytes() + b"\n")
            mp.write(b"ref%04d\t" % i + tax + b"\tfunc__%d\n" % (i % 4))
    return genomes


def xtree_queries(path: pathlib.Path, genomes, n: int, seed: int = 6):
    """tools/bench_align.py's query mix: 150 bp from the references, 2%
    mutation, 10% random.  Writes `>q<i>` records; returns the (n, 150)
    matrix."""
    import numpy as np

    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(ACGT, np.uint8)
    which = rng.integers(0, genomes.shape[0], n)
    starts = rng.integers(0, genomes.shape[1] - READ_LEN, n)
    q = genomes[which[:, None], starts[:, None] + np.arange(READ_LEN)]
    mut = rng.random(q.shape) < 0.02
    q[mut] = rng.choice(acgt, int(mut.sum()))
    rand = rng.random(n) < 0.10
    q[rand] = rng.choice(acgt, (int(rand.sum()), READ_LEN))
    with open(path, "wb") as f:
        f.write(b"".join(b">q%d\n" % i + q[i].tobytes() + b"\n" for i in range(n)))
    return q


def valid_windows(reads, lens, k: int):
    """(B, T-k+1) bool: the windows of k ACGT bases within each length."""
    import numpy as np

    ok = np.isin(reads, np.frombuffer(b"ACGTacgt", np.uint8))
    ok &= np.arange(reads.shape[1])[None, :] < lens[:, None]
    bad = np.concatenate([np.zeros((len(reads), 1), np.int64),
                          np.cumsum(~ok, axis=1)], axis=1)
    return bad[:, k:] - bad[:, :-k] == 0


@contextlib.contextmanager
def timed(tm, *targets):
    """Within the block each (owner, name, label) callable adds its
    synchronised wall time to tm's phase `label`; restored after.  The
    instrumentation of phase 12's breakdown."""
    import torch

    saved = [(owner, name, vars(owner).get(name)) for owner, name, _ in targets]

    def wrap(fn, label):
        def wrapper(*args, **kw):
            with tm.phase(label):
                out = fn(*args, **kw)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
            return out
        return wrapper

    for owner, name, label in targets:
        setattr(owner, name, wrap(getattr(owner, name), label))
    try:
        yield tm
    finally:
        for owner, name, old in saved:
            if old is None:
                delattr(owner, name)
            else:
                setattr(owner, name, old)


def phase_xtree(dev, work: pathlib.Path):
    """Phase 12: xtree BUILD and ALIGN, the device front end (K9) against
    the host engine."""
    import numpy as np
    import torch

    from utree_tpu_torch import native
    from utree_tpu_torch.utils.trace import PhaseTimer
    from utree_tpu_torch.xtree.align import AlignOptions, XtreeAligner
    from utree_tpu_torch.xtree.build import build_xtree_db, read_xtr, write_xtr
    from utree_tpu_torch.xtree.device import xtree_step, xtree_step_plain

    refs_fa, map_path = work / "xt_refs.fa", work / "xt_tax.map"
    genomes = xtree_refs(refs_fa, map_path, XT_REFS, XT_REF_LEN)
    queries = xtree_queries(work / "xt_queries.fa", genomes, XT_QUERIES)
    sub_fa = work / "xt_queries_redist.fa"
    with open(sub_fa, "wb") as f:
        f.write(b"".join(b">q%d\n" % i + queries[i].tobytes() + b"\n"
                         for i in range(XT_REDIST_QUERIES)))
    t = time.perf_counter()
    db = build_xtree_db(str(refs_fa), str(map_path), k=XT_K, comp=0)
    build_s = time.perf_counter() - t
    xtr = work / "xt_db.xtr"
    t = time.perf_counter()
    write_xtr(db, str(xtr))
    back = read_xtr(str(xtr))
    io_s = time.perf_counter() - t
    size = xtr.stat().st_size
    xtr.unlink()
    for f in ("bin_offsets", "sfx", "rix", "ref_names", "h_strings", "num_refs",
              "h_pairs"):
        a, b = getattr(db, f), getattr(back, f)
        same = (np.array_equal(a, b) if isinstance(a, np.ndarray)
                else all(map(np.array_equal, a, b)) if f == "h_pairs" else a == b)
        if not same:
            fail(f"xtree: {f} differs after the .xtr round trip")
    log(f"xtree: {db.num_refs} refs x {XT_REF_LEN:,} bp, {db.num_kmers:,} pods at "
        f"k={XT_K}; build {build_s:.1f} s; .xtr of {size:,} B written and read back "
        f"in {io_s:.1f} s, identical")
    del back
    t = time.perf_counter()
    host = XtreeAligner(db, device=None)
    host_s = time.perf_counter() - t
    t = time.perf_counter()
    al = XtreeAligner(db, device=dev)
    dev_s = time.perf_counter() - t
    tab = al.tables
    log(f"xtree: host engine set-up {host_s:.1f} s; device index {dev_s:.1f} s, "
        f"{al._dev_index.num_entries:,} entries, "
        + ", ".join(f"{k} {tuple(v.shape)}" for k, v in tab.items()))

    # K9 at the main path's chunk shape: 8192 queries of 150 bp in rows of 192
    b = min(al.chunk_queries, len(queries))
    rows = np.zeros((b, 192), np.uint8)
    rows[:, :READ_LEN] = queries[:b]
    lens_np = np.full(b, READ_LEN, np.int32)
    rt, lt = torch.from_numpy(rows).to(dev), torch.from_numpy(lens_np).to(dev)
    kw = dict(k=al.k, sl=al.sl)
    out = xtree_step(tab, rt, lt, **kw)
    valid = torch.from_numpy(valid_windows(rows, lens_np, al.k)).to(dev)
    nvalid = int(valid.sum())
    misses = int((valid & (out[0] < 0) & (out[1] < 0)).sum())
    # the queries, the four outputs, and per valid window one 32 B d1 row
    # and one seed-word sector (the seed table read at most once), plus a
    # d3 sector per window that misses d1 and d3 alike (a lower count of
    # the tail's reads: a d3 hit is not told apart from a d1 hit)
    tail = min(nbytes(tab["d3"]), SECTOR * misses) if tab["d3"].shape[0] > 8 else 0
    moved = (nbytes(rt, lt, *out) + min(nbytes(tab["d1"]), SECTOR * nvalid)
             + min(nbytes(tab["ds"]), SECTOR * nvalid) + tail)
    row = check_kernel("xtree_probe", "xtree_probe.cu", "utree_tpu/xtree/device.py:178",
                       lambda: xtree_step(tab, rt, lt, **kw),
                       lambda: xtree_step_plain(tab, rt, lt, **kw),
                       f"B={b}, T=192, k={al.k}", moved)
    hits = int((out[0] >= 0).sum() + (out[1] >= 0).sum())
    log(f"xtree K9 batch: {nvalid:,} valid windows, {hits:,} strand hits, "
        f"{misses:,} windows missing on both strands")
    del out, rt, lt, valid

    def opts(tag, **kw):
        return AlignOptions(**{f"{o}_out": str(work / f"xt_{tag}.{o}") for o in XT_OUTS},
                            **kw)

    def outputs(tag):
        return [(work / f"xt_{tag}.{o}").read_bytes() for o in XT_OUTS]

    def align(aligner, tag: str, label: str):
        """One ALIGN of every query with each output; its queries/s and
        breakdown: the record scan, the front end (the C scan, or the
        device step: pad, h2d, K9, d2h, scan-order rebuild), the ref tally
        and the writers; the rest is the taxonomy calls and the per-query
        tail."""
        tm = PhaseTimer(quiet=True)
        targets = [(native, "xt_scan_queries", "record scan"),
                   (aligner, "_batch_ref_tally", "ref tally"),
                   (aligner, "_write_outputs", "writers")]
        if aligner._dev_step is None:
            targets.append((native, "xt_scan_hits", "front end"))
        else:
            targets += [(aligner, "_batch_hits_device", "front end"),
                        (aligner, "_dev_step", "front end: K9")]
        with timed(tm, *targets):
            t = time.perf_counter()
            aligner.align_file(str(work / "xt_queries.fa"), opts(tag))
            dt = time.perf_counter() - t
        rest = dt - sum(v for k, v in tm.phases.items() if k != "front end: K9")
        stats[label] = {"queries_per_s": XT_QUERIES / dt, "seconds": dt,
                        "phases": {**tm.phases, "rest": rest}}
        log(f"xtree {label}: {XT_QUERIES} queries in {dt:.3f} s = "
            f"{XT_QUERIES / dt:,.0f} queries/s; phases "
            + ", ".join(f"{k} {v:.3f}s" for k, v in tm.phases.items())
            + f", rest {rest:.3f}s")
        return dt

    stats = {}
    align(host, "host", "host engine")
    want = outputs("host")
    if want[0].count(b"\n") != XT_QUERIES or b"\tNo matches found" not in want[0]:
        fail("xtree: the host engine's perq output is not one line a query")
    best = 0.0
    for p in range(2):
        dt = drive(f"xtree e2e pass {p + 1}", ("xtree_probe",),
                   lambda: align(al, "dev", f"device pass {p + 1}"))
        for o, g, w in zip(XT_OUTS, outputs("dev"), want):
            if g != w:
                fail(f"xtree pass {p + 1}: the device front end's {o} output differs "
                     "from the host engine's")
        log(f"xtree pass {p + 1}: perq, ref, tax, cov byte-identical to the host engine")
        best = max(best, XT_QUERIES / dt)
    stats["device_queries_per_s"] = best

    # --redistribute on the first XT_REDIST_QUERIES queries, both engines
    for tag, aligner, expect in (("rhost", host, ()), ("rdev", al, ("xtree_probe",))):
        t = time.perf_counter()
        drive(f"xtree redistribute ({tag})", expect, lambda: aligner.align_file(
            str(sub_fa), opts(tag, do_redist=True)))
        stats[f"redistribute {tag[1:]}"] = {"seconds": time.perf_counter() - t}
    if outputs("rdev") != outputs("rhost"):
        fail("xtree --redistribute: the device front end's outputs differ from the "
             "host engine's")
    log(f"xtree redistribute: {XT_REDIST_QUERIES} queries, perq, ref, tax, cov "
        f"byte-identical (device {stats['redistribute dev']['seconds']:.3f} s, host "
        f"{stats['redistribute host']['seconds']:.3f} s)")
    stats.update(build_s=build_s, device_index_s=dev_s, pods=db.num_kmers)
    return row, stats


def phase_hash(dev, base: dict, work: pathlib.Path):
    """Phase 13: the legacy two-table hash (K10) on the phase-4 tier, then
    on phase 7's 2M-k-mer tier of 70,000 labels."""
    import torch

    from utree_tpu_torch import lookup
    from utree_tpu_torch.pipeline import SearchPipeline

    index, reads = base["index"], base["reads"]
    t = time.perf_counter()
    pipe = SearchPipeline(index, device=dev, do_rc=True, batch_size=BATCH,
                          hist_cap=HIST_CAP, lookup_mode="hash")
    place_s = time.perf_counter() - t
    if pipe.table_kind != "hash" or pipe.layout != "vote":
        fail(f"hash: resolved to {pipe.table_kind}, layout {pipe.layout}")
    tab = base["k32_tables"]["t1"] = pipe._tables[0]
    log(f"hash: build_hash_index and the copy to the card in {place_s:.1f} s; "
        f"t1 {tuple(tab['t1'].shape)} ({nbytes(tab['t1']):,} B), "
        f"t2 {tuple(tab['t2'].shape)} ({nbytes(tab['t2']):,} B)")
    packed, vbits, lens = batch_tensors(dev, reads)
    kw = dict(do_rc=True, bad_ix=0xFFFF, true_len=(READ_LEN + 7) & ~7,
              num_labels=index.num_labels)
    ids = lookup.window_ids(tab, packed, vbits, lens, **kw)
    # the words that read a t2 row: the valid ones t1 does not answer,
    # counted by the plain version over t1 alone (an empty 8-row t2)
    t1_only = {"t1": tab["t1"], "t2": torch.full((8, 24), -1, dtype=torch.int32,
                                                 device=dev)}
    words = 2 * windows(lens, 32)
    t1_miss = int((lookup.window_ids_plain(t1_only, packed, vbits, lens, **kw)
                   == 0xFFFF).sum()) - (ids.numel() - words)
    # every valid word reads one 96 B t1 row (3 sectors), and each t1 miss a
    # t2 row, the t2 read at most once
    moved = (probe_bytes(packed, vbits, lens, ids, 32, 6, tab["t1"])
             + min(nbytes(tab["t2"]), 3 * SECTOR * t1_miss))
    log(f"hash batch: {words:,} words, {t1_miss:,} missing t1 "
        f"({t1_miss / words:.1%}), {int((ids != 0xFFFF).sum()):,} hits")
    row = check_kernel("hash_probe", "hash_probe.cu", "utree_tpu/lookup.py:205",
                       lambda: lookup.window_ids(tab, packed, vbits, lens, **kw),
                       lambda: lookup.window_ids_plain(tab, packed, vbits, lens, **kw),
                       f"B={packed.shape[0]}", moved)
    del t1_only, ids, packed, vbits, lens
    out_txt = work / "smoke_hash.txt"
    rps = e2e(pipe, base["reads_fa"], out_txt, len(reads), "hash e2e",
              ("hash_probe", "histogram", "aufbau_vote"))
    if out_txt.read_bytes() != base["out_txt"].read_bytes():
        fail("the legacy hash's output differs from the displaced table's")
    log("hash: whole output byte-identical to the displaced run (phase 4)")
    del pipe, tab

    t = time.perf_counter()
    windex, _, _ = make_tier(WIDE_DISPLACED_KMERS, WIDE_LABELS, ixtype_bytes=4)
    wpipe = SearchPipeline(windex, device=dev, do_rc=True, batch_size=BATCH,
                           hist_cap=HIST_CAP, lookup_mode="hash")
    wide_s = time.perf_counter() - t
    if wpipe.table_kind != "hash" or wpipe.layout != "unpacked":
        fail(f"wide hash: resolved to {wpipe.table_kind}, layout {wpipe.layout}")
    log(f"wide hash: {windex.num_labels} labels, {WIDE_DISPLACED_KMERS} k-mers, "
        f"set-up {wide_s:.1f} s, t1 {tuple(wpipe._tables[0]['t1'].shape)}, "
        f"t2 {tuple(wpipe._tables[0]['t2'].shape)}")
    out_w = work / "smoke_wide_hash.txt"
    wrps = e2e(wpipe, work / "smoke_wide_reads.fa", out_w, len(reads), "wide hash e2e",
               ("hash_probe", "histogram_unpacked"))
    if out_w.read_bytes() != (work / "smoke_wide_displaced.txt").read_bytes():
        fail("wide hash: output differs from the wide displaced run (phase 7)")
    log("wide hash: whole output byte-identical to the wide displaced run (phase 7)")
    del wpipe
    return row, {"reads_per_s": rps, "place_s": place_s, "wide_reads_per_s": wrps,
                 "t1_miss_share": t1_miss / words}


def phase_shallow(base: dict, work: pathlib.Path) -> dict:
    """Phase 14: the rank-specific search (host only: the g++/OpenMP build
    of csrc/host/shallow.cpp) over the phase-4 tier's host index and reads."""
    from utree_tpu_torch.classify import ShallowVoter
    from utree_tpu_torch.encode import encode_bases, revcomp_text
    from utree_tpu_torch.native import shallow_scan_batch
    from utree_tpu_torch.search_host import scan_shallow_literal, search_file_shallow

    host, reads = base["host"], base["reads"]
    out_txt = work / "smoke_shallow.txt"
    t = time.perf_counter()
    n = search_file_shallow(host, str(base["reads_fa"]), str(out_txt), do_rc=True)
    dt = time.perf_counter() - t
    if n != len(reads):
        fail(f"rank-specific: {n} of {len(reads)} reads")
    lines = out_txt.read_bytes().splitlines(keepends=True)
    head = [ln for ln in lines if int(ln.split(b"\t", 1)[0][1:]) < CHECK_READS]
    if not head:
        fail(f"rank-specific: no line for the first {CHECK_READS} reads")
    seqs = [reads[i].tobytes() for i in range(CHECK_READS)]
    t = time.perf_counter()
    hits = shallow_scan_batch(host, [encode_bases(s + b"N" + revcomp_text(s))
                                     for s in seqs])
    if hits != [scan_shallow_literal(host, s, True) for s in seqs]:
        fail("rank-specific: shallow_scan_batch differs from scan_shallow_literal")
    voter = ShallowVoter(host.strings, host.config.tolerance, host.config.slack)
    py = [voter.vote(b"r%d" % i, h) for i, h in enumerate(hits)]
    if b"".join(x + b"\n" for x in py if x is not None) != b"".join(head):
        fail("rank-specific: the native lines differ from the Python-driven vote")
    log(f"rank-specific: {n} reads in {dt:.3f} s = {n / dt:,.0f} reads/s, "
        f"{len(lines)} lines; the first {CHECK_READS} reads' hits equal "
        f"scan_shallow_literal and their {len(head)} lines the Python-driven vote "
        f"({time.perf_counter() - t:.1f} s)")
    return {"reads_per_s": n / dt, "seconds": dt, "lines": len(lines)}


def tail_sectors(t) -> int:
    """32 B sectors of one row of a table."""
    return -(-t.shape[1] * 4 // SECTOR)


def routed_parts(sh, table: dict, b: int, w: int) -> dict:
    """What sets the displaced routed step (K12 owner_probe, K13
    routed_finish) apart from the canonical one (K17 canonical_owner_probe,
    K18 routed_canonical_finish), on one shard's `table`, narrow or wide by
    the table: the buckets K11 routes by; the owner probe and the finish as
    (name, source, replaces, kernel, plain), the one a function of the
    receive lanes, the other of K11's records and the replies; the bytes of
    table the owner reads for `written` lanes; and the tail bytes the
    finish reads, with a note, given the records and each lane's routed
    value (0 for slot -1)."""
    from utree_tpu_torch.lookup import canonical_buckets
    from utree_tpu_torch.parallel import routed as R

    S, wide = sh.num_shards, sh.wide
    sfx = "_wide" if wide else ""
    fin = dict(b=b, w=w, do_rc=True, bad_ix=0x7FFFFFFF if wide else 0xFFFF, wide=wide)
    if isinstance(sh, R.ShardedDisplacedIndex):
        t1, ds, t3 = table["t1"], table["ds"], table["t3"]
        own = dict(per_seed=sh.nseed // S, wide=wide)

        def tail(rec, got, miss1):
            # a valid lane whose routed value misses reads one d3 row (t3 at
            # most once)
            miss = int(miss1.sum())
            return min(nbytes(t3), SECTOR * miss), f"{miss:,} of shard 0's miss d1"

        return dict(
            nbkt=sh.nseed,
            owner=("owner_probe" + sfx, "owner_probe.cu", "utree_tpu/parallel/routed.py:405",
                   lambda lanes, base=0: R.owner_probe(t1, ds, lanes, **own, base=base),
                   lambda lanes, base=0: R.owner_probe_plain(t1, ds, lanes, **own,
                                                             base=base)),
            finish=("routed_finish" + sfx, "routed_finish.cu",
                    "utree_tpu/parallel/routed.py:462",
                    lambda rec, reply: R.routed_finish(rec, reply, t3, **fin),
                    lambda rec, reply: R.routed_finish_plain(rec, reply, t3, **fin)),
            # a d1 row a written lane, bucket 0's row once for the unwritten
            # slots, d1 and the seed words at most once each
            owner_bytes=lambda written: (min(nbytes(t1), SECTOR * (written + 1))
                                         + min(nbytes(ds), SECTOR * written)),
            tail=tail)
    t1, t2, t3 = table["t1"], table["t2"], table["t3"]
    own = dict(per_shard=sh.b1 // S, wide=wide)

    def tail(rec, got, miss1):
        # a valid lane whose routed value misses reads a c2 row, and one c2
        # misses too a c3 row (each table at most once; an 8-row table is
        # absent)
        valid = (rec[:, 3] & 1) == 1
        moved, miss2 = 0, miss1
        if t2.shape[0] > 8:
            klo, khi = rec[:, 1].long() & 0xFFFFFFFF, rec[:, 2].long() & 0xFFFFFFFF
            bkt2 = canonical_buckets(klo, khi, valid, 1, t2.shape[0])[1]
            v1 = (got[:, 0], got[:, 1]) if wide else got[:, 0]
            # t3[:0] holds no row, so only c2 is probed
            v2 = R.tail_probe_plain(v1, t2, t3[:0], bkt2, klo, khi, valid, wide=wide)
            miss2 = valid & ((v2[0] | v2[1]) == 0 if wide else v2 == 0)
            moved += min(nbytes(t2), SECTOR * tail_sectors(t2) * int(miss1.sum()))
        if t3.shape[0] > 8:
            moved += min(nbytes(t3), SECTOR * tail_sectors(t3) * int(miss2.sum()))
        return moved, (f"{int(miss1.sum()):,} of shard 0's miss c1, {int(miss2.sum()):,} "
                       f"miss c2 too; c1 {tuple(t1.shape)} a shard, c2 {tuple(t2.shape)}, "
                       f"c3 {tuple(t3.shape)}")

    return dict(
        nbkt=sh.b1,
        owner=("canonical_owner_probe" + sfx, "owner_probe.cu",
               "utree_tpu/parallel/routed.py:153",
               lambda lanes, base=0: R.canonical_owner_probe(t1, lanes, **own, base=base),
               lambda lanes, base=0: R.canonical_owner_probe_plain(t1, lanes, **own,
                                                                   base=base)),
        finish=("routed_canonical_finish" + sfx, "routed_finish.cu",
                "utree_tpu/parallel/routed.py:95",
                lambda rec, reply: R.routed_canonical_finish(rec, reply, t2, t3, **fin),
                lambda rec, reply: R.routed_canonical_finish_plain(rec, reply, t2, t3,
                                                                   **fin)),
        # a c1 row a written lane, row 0 once for the unwritten slots, c1
        # at most once
        owner_bytes=lambda written: min(nbytes(t1), SECTOR * tail_sectors(t1) * (written + 1)),
        tail=tail)


def routed_checks(sharded, tables, mesh, packed, vbits, lens, tag: str) -> list[dict]:
    """K11 and the routed step's owner probe and finish (`routed_parts`:
    K12 and K13 or K17 and K18) against their plain versions at the step's
    shapes for this batch on a (1, S) mesh: shard 0's rows (B/S reads),
    owner 0's receive buffer, shard 0's records and replies; then the time
    of the copies between the shards.  K11's row is the displaced narrow
    table's; at b1 buckets and on the wide tier its time is logged only."""
    from utree_tpu_torch.parallel import routed as R

    S = mesh.size
    b, w = packed.shape[0] // S, packed.shape[1] * 4 - 31
    # the step's capacity
    c = max(128, math.ceil(b * w / S * R.CAPACITY_FACTOR / 128) * 128)
    parts = [routed_parts(sharded, t, b, w) for t in tables]
    nbkt = parts[0]["nbkt"]
    # the step's sequence (parallel.routed._routed_step): each shard's K11,
    # the receive buffers, the owners' probes, the replies
    routed = [R.route_displaced(packed[s * b:(s + 1) * b], vbits[s * b:(s + 1) * b],
                                lens[s * b:(s + 1) * b], nseed=nbkt, num_shards=S,
                                capacity=c) for s in range(S)]
    recv = mesh.all_to_all([r[0] for r in routed])
    vals = [parts[o]["owner"][3](recv[o].reshape(S * c, 3)) for o in range(S)]
    vals = [v.reshape((S, c, 2) if sharded.wide else (S, c)) for v in vals]
    reply = mesh.all_to_all(vals)
    p0, v0, l0 = packed[:b], vbits[:b], lens[:b]
    send, rec, counts = routed[0]
    what = f"{tag}: B/S={b} reads, W={w}, {S} shards, C={c}"
    k11 = dict(nseed=nbkt, num_shards=S, capacity=c)
    k11_row = check_kernel(
        "route_displaced", "route_displaced.cu", "utree_tpu/parallel/routed.py:422",
        lambda: R.route_displaced(p0, v0, l0, **k11),
        lambda: R.route_displaced_plain(p0, v0, l0, **k11), f"{what}, {nbkt} buckets",
        nbytes(p0, v0, l0, send, rec, counts))
    displaced_narrow = isinstance(sharded, R.ShardedDisplacedIndex) and not sharded.wide
    rows = [k11_row] if displaced_narrow else []
    lanes = recv[0].reshape(S * c, 3)
    written = sum(min(int(r[2][0]), c) for r in routed)
    name, src, line, kernel, plain = parts[0]["owner"]
    rows.append(check_kernel(name, src, line, lambda: kernel(lanes), lambda: plain(lanes),
                             what, nbytes(lanes, vals[0]) + parts[0]["owner_bytes"](written)))
    log(f"{tag}: owner 0's receive buffer {lanes.shape[0]:,} lanes, {written:,} written, "
        f"{lanes.shape[0] - written:,} unwritten (K11's zeroed tail)")
    # the fallback's lanes: K11 as one shard with room for every lane
    # (global buckets), each shard's owner probe at its base
    glanes = R.route_displaced(p0, v0, l0, nseed=nbkt, num_shards=1,
                               capacity=b * w)[0].reshape(-1, 3)
    for s in range(S):
        _, _, _, kernel_s, plain_s = parts[s]["owner"]
        max_abs_err((kernel_s(glanes, s * (nbkt // S)),), (plain_s(glanes, s * (nbkt // S)),))
    log(f"{tag}: {name} equal to plain on the fallback's {glanes.shape[0]:,} lanes "
        f"(shard 0's rows, global buckets) at each of the {S} shards' bases")
    name, src, line, kernel, plain = parts[0]["finish"]
    ids = kernel(rec, reply[0])
    slot, valid = rec[:, 0].long(), (rec[:, 3] & 1) == 1
    got = reply[0].reshape(S * c, -1)[slot.clamp(min=0)] * (slot >= 0)[:, None]
    tail, note = parts[0]["tail"](rec, got, valid & (got == 0).all(1))
    rows.append(check_kernel(name, src, line, lambda: kernel(rec, reply[0]),
                             lambda: plain(rec, reply[0]), what,
                             nbytes(rec, reply[0], ids) + tail))
    a2a = cuda_ms(lambda: mesh.all_to_all([r[0] for r in routed]), 20)
    back = cuda_ms(lambda: mesh.all_to_all(vals), 20)
    flags = [r[2][S:] for r in routed]
    ps = cuda_ms(lambda: mesh.psum(flags), 20)
    log(f"{tag} copies per batch: all_to_all out {a2a:.4f} ms "
        f"({nbytes(*(r[0] for r in routed)):,} B), back {back:.4f} ms "
        f"({nbytes(*vals):,} B), overflow psum {ps:.4f} ms; "
        f"{sum(int(r[2][:S].sum()) for r in routed):,} valid lanes, {note}; "
        f"overflow {[int(r[2][S]) for r in routed]}")
    return rows


def k11_at_many_shards(nseed: int, packed, vbits, lens) -> None:
    """K11 at MANY_SHARDS owners (a warp looks back for several) on one
    shard's rows of the batch, at the step's capacity: equal to its plain
    version on the same inputs, and timed."""
    from utree_tpu_torch.parallel import routed as R

    S = MANY_SHARDS
    b, w = packed.shape[0] // S, packed.shape[1] * 4 - 31
    c = max(128, math.ceil(b * w / S * R.CAPACITY_FACTOR / 128) * 128)
    args, kw = (packed[:b], vbits[:b], lens[:b]), dict(nseed=nseed, num_shards=S, capacity=c)

    def k11():
        return R.route_displaced(*args, **kw)

    want = R.route_displaced_plain(*args, **kw)
    err = max_abs_err(k11(), want)
    counts = want[2]
    log(f"kernel route_displaced at {S} shards: equal to plain (max abs err {err}) at "
        f"B/S={b} reads, W={w}, C={c}, nseed {nseed}; {cuda_ms(k11, 20):.4f} ms "
        f"({device_ms(k11, 20):.4f} on the device); owner lanes "
        f"{int(counts[:S].min())}-{int(counts[:S].max())}, overflow {int(counts[S])}")


def phase_routed(dev, base: dict, work: pathlib.Path):
    """Phase 15: the phase-4 tier sharded ROUTED_SHARDS ways by seed bucket,
    the shards on one card (`_shard_devices`); then the wide 2M tier's
    routed step, held to the same step over CPU shards."""
    import torch

    from utree_tpu_torch.parallel import routed as R
    from utree_tpu_torch.parallel.mesh import ShardMesh
    from utree_tpu_torch.pipeline import SearchPipeline

    index, reads, S = base["index"], base["reads"], ROUTED_SHARDS
    t = time.perf_counter()
    pipe = SearchPipeline(index, device=dev, do_rc=True, batch_size=BATCH,
                          hist_cap=HIST_CAP, devices=S, lookup_mode="routed",
                          _shard_devices=[dev] * S)
    place_s = time.perf_counter() - t
    if pipe.table_kind != "routed-displaced" or pipe.layout != "packed":
        fail(f"routed: resolved to {pipe.table_kind}, layout {pipe.layout}")
    sh, mesh, tabs = pipe._sharded, pipe._mesh, pipe._tables
    base["routed_displaced"] = sh  # phase 19 runs it on a (2, 4) mesh
    log(f"routed: ShardedDisplacedIndex.build ({S} shards) and the copy to the card "
        f"in {place_s:.1f} s; nseed {sh.nseed}, t1 {tuple(sh.t1.shape)}, seeds "
        f"{tuple(sh.seeds.shape)}, t3 {tuple(sh.t3.shape)}")
    batch = batch_tensors(dev, reads)
    rows = routed_checks(sh, tabs, mesh, *batch, "routed")
    k11_at_many_shards(sh.nseed, *batch)
    out_txt = work / "smoke_routed.txt"
    expect = ("route_displaced", "owner_probe", "routed_finish", "histogram_packed")
    rps = e2e(pipe, base["reads_fa"], out_txt, len(reads), "routed e2e", expect)
    if out_txt.read_bytes() != base["out_txt"].read_bytes():
        fail("routed: output differs from the displaced run (phase 4)")
    log("routed: whole output byte-identical to the displaced run (phase 4)")

    # capacity 8: every batch overflows and goes through the fallback
    step = pipe._step_routed
    pipe._step_routed = R.routed_displaced_search_step(
        mesh, sh, do_rc=True, num_labels=index.num_labels, cap=HIST_CAP,
        bad_ix=index.config.bad_ix, capacity=8)
    calls, fallback = [], pipe._fallback_step
    pipe._fallback_step = lambda *a: calls.append(1) or fallback(*a)
    fb_txt = work / "smoke_routed_fallback.txt"
    fb_rps = e2e(pipe, base["reads_fa"], fb_txt, len(reads), "routed fallback e2e",
                 expect, passes=1)
    batches = -(-len(reads) // BATCH)
    if len(calls) != batches or fb_txt.read_bytes() != base["out_txt"].read_bytes():
        fail(f"routed fallback: {len(calls)} of {batches} batches redispatched, or "
             "its output differs from phase 4's")
    log(f"routed fallback: all {batches} batches flagged and redispatched; whole "
        "output byte-identical to phase 4's")
    pipe._step_routed, pipe._fallback_step = step, fallback
    del pipe, tabs

    n = torch.cuda.device_count()
    if n >= 2:
        k = min(n, S)
        pipe = SearchPipeline(index, device=dev, do_rc=True, batch_size=BATCH,
                              hist_cap=HIST_CAP, devices=k, lookup_mode="routed")
        cards_txt = work / "smoke_routed_cards.txt"
        e2e(pipe, base["reads_fa"], cards_txt, len(reads), f"routed on {k} cards",
            expect, passes=1)
        if cards_txt.read_bytes() != base["out_txt"].read_bytes():
            fail(f"routed on {k} cards: output differs from phase 4's")
        del pipe
    else:
        log(f"routed on distinct cards: skipped, {n} card on this machine")

    # the wide tier (IXTYPE=u32): the step only (the pipeline refuses wide
    # routed DBs, as utree_tpu's does), held to the same step on CPU shards
    windex, genome, rng = make_tier(WIDE_DISPLACED_KMERS, WIDE_LABELS, ixtype_bytes=4)
    wsh = R.ShardedDisplacedIndex.build(windex, S)
    wmesh, cpu = ShardMesh([dev] * S), ShardMesh(["cpu"] * S)
    wtabs = wsh.to_devices(wmesh)
    wbatch = batch_tensors(dev, make_reads(genome, rng, BATCH))
    rows += routed_checks(wsh, wtabs, wmesh, *wbatch, "routed wide")
    kw = dict(do_rc=True, num_labels=windex.num_labels, cap=HIST_CAP,
              bad_ix=windex.config.bad_ix)
    wstep = R.routed_displaced_search_step(wmesh, wsh, **kw)
    got = drive("routed wide step", ("route_displaced", "owner_probe_wide",
                                     "routed_finish_wide", "histogram_packed"),
                lambda: torch.cat(wstep(wtabs, *wbatch)))
    sub = [x[:WIDE_ROUTED_CHECK].cpu() for x in wbatch]
    want = torch.cat(R.routed_displaced_search_step(cpu, wsh, **kw)(
        wsh.to_devices(cpu), *sub))
    if not torch.equal(got[:WIDE_ROUTED_CHECK].cpu(), want):
        fail("routed wide step: the card's rows differ from the CPU shards' "
             f"(first {WIDE_ROUTED_CHECK} reads)")
    hits = int(((got[:, 0] & 0xFFFF) != 0).sum())
    log(f"routed wide step: {windex.num_labels} labels, rows of the first "
        f"{WIDE_ROUTED_CHECK} reads equal the CPU shards'; {hits} of {BATCH} reads "
        f"hit; overflow column {int(got[0, -1])}")
    return rows, {"reads_per_s": rps, "fallback_reads_per_s": fb_rps, "place_s": place_s}


def phase_data_parallel(dev, base: dict, work: pathlib.Path) -> dict:
    """Phase 16: devices=DP_SHARDS over the phase-4 table replicated on
    one card (`_shard_devices`), the batch rows split over the shards."""
    from utree_tpu_torch.pipeline import SearchPipeline

    pipe = SearchPipeline(base["index"], device=dev, do_rc=True, batch_size=BATCH,
                          hist_cap=HIST_CAP, lookup_mode="displaced", _table=base["table"],
                          devices=DP_SHARDS, _shard_devices=[dev] * DP_SHARDS)
    if pipe.layout != "vote" or len(pipe._tables) != DP_SHARDS:
        fail(f"data parallel: layout {pipe.layout}, {len(pipe._tables)} shards")
    out_txt = work / "smoke_dp.txt"
    rps = e2e(pipe, base["reads_fa"], out_txt, len(base["reads"]), "data-parallel e2e",
              ("scan_probe", "histogram", "aufbau_vote"))
    if out_txt.read_bytes() != base["out_txt"].read_bytes():
        fail("data parallel: output differs from the displaced run (phase 4)")
    log(f"data parallel ({DP_SHARDS} shards): whole output byte-identical to phase 4's")
    return {"reads_per_s": rps}


def multihost_worker(rank: int, port: int, kmers: int, reads_fa: str, out: str,
                     device: str) -> int:
    """One process of phase 17: the phase-4 tier and its cached table, the
    gloo process group on 127.0.0.1, search_file_multihost."""
    import torch

    from utree_tpu_torch.hash_index import displaced_to_device
    from utree_tpu_torch.parallel.distributed import (init_distributed,
                                                      search_file_multihost)
    from utree_tpu_torch.pipeline import SearchPipeline

    index, _, _ = make_tier(kmers, LABELS)
    disp = load_or_build_displaced(index, kmers, LABELS, ROOT / ".bench_cache")
    init_distributed(f"127.0.0.1:{port}", 2, rank)
    pipe = SearchPipeline(index, device=device, do_rc=True, batch_size=BATCH,
                          hist_cap=HIST_CAP, lookup_mode="displaced",
                          _table=displaced_to_device(disp, "cpu"))
    t = time.perf_counter()
    n = search_file_multihost(pipe, reads_fa, out)
    log(f"worker {rank}: {n} reads in {time.perf_counter() - t:.3f} s")
    torch.distributed.destroy_process_group()
    return 0


def phase_multihost(dev, base: dict, kmers: int, work: pathlib.Path) -> dict:
    """Phase 17: two processes share the card, meet over gloo and run
    search_file_multihost; the merged output must be phase 4's and the
    merged tally (reads, lines)."""
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    out = work / "smoke_multihost.txt"
    t = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(pathlib.Path(__file__).resolve()),
                               "--multihost-worker", str(r), str(port), str(kmers),
                               str(base["reads_fa"]), str(out), str(dev)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=600)
            outs.append(o)
            if p.returncode != 0:
                fail(f"multihost worker exited {p.returncode}: {e[-2000:]}")
    finally:
        for p in procs:
            p.kill()
            p.wait()
    dt = time.perf_counter() - t
    for o in outs:
        for ln in o.splitlines():
            log(f"  {ln}")
    nreads, lines = len(base["reads"]), base["out_txt"].read_bytes().count(b"\n")
    want = f"multihost: {nreads} reads searched, {lines} classified across 2 hosts"
    if want not in outs[0]:
        fail(f"multihost: rank 0 did not report the merged tally '{want}'")
    if out.read_bytes() != base["out_txt"].read_bytes():
        fail("multihost: the merged output differs from phase 4's")
    log(f"multihost: two processes on one card, merged output byte-identical to phase "
        f"4's, tally ({nreads}, {lines}); {dt:.1f} s with both workers' set-up")
    return {"seconds": dt}


K32_PROBES = {"d1": "scan_probe", "c1": "ladder_probe", "bsearch": "bsearch_probe",
              "t1": "hash_probe"}


def timed_step(fn, passes: int = 3) -> float:
    """Best host-clock seconds of fn() over `passes` runs, each ended by a
    synchronize (the sharded steps are host loops over devices)."""
    import torch

    best = math.inf
    for _ in range(passes):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t)
    return best


def phase_sharded(dev, base: dict):
    """Phase 18: the ASCII k=32 search step (K14 and the probes of phases
    4, 6, 10 and 13) and the three modes of parallel/sharded.py with every
    device on the one card: the replicated step, the prefix-sharded step
    (K15), the long-read histogram (K16) and the dryrun."""
    import numpy as np
    import torch

    from utree_tpu_torch import dryrun, lookup
    from utree_tpu_torch.parallel import sharded as S
    from utree_tpu_torch.parallel.mesh import make_mesh

    index, tabs = base["index"], base["k32_tables"]
    L = index.num_labels
    b = min(BATCH, len(base["reads"]))
    reads = torch.from_numpy(np.ascontiguousarray(base["reads"][:b])).to(dev)
    lens = torch.full((b,), READ_LEN, dtype=torch.int32, device=dev)
    w = READ_LEN - 31
    what = f"B={b} x {READ_LEN} bp"
    packed, vbits = lookup.ascii_pack(reads, lens)
    max_abs_err(lookup.ascii_pack(reads, lens, True), lookup.ascii_pack_plain(reads, lens, True))
    log("kernel ascii_pack: append_rc mode (2L+1 positions) equal to plain")
    rows = [check_kernel("ascii_pack", "ascii_pack.cu", "utree_tpu/lookup.py:31",
                         lambda: lookup.ascii_pack(reads, lens),
                         lambda: lookup.ascii_pack_plain(reads, lens), what,
                         nbytes(reads, lens, packed, vbits))]

    # the ASCII k=32 step: search_step on each table = window_ids on the reads
    # packed on the host (width 192, true_len 152), trimmed to W = L-31
    hp, hv, hl = batch_tensors(dev, base["reads"])
    kw = dict(k=32, do_rc=True, probe_iters=index.probe_iters, bad_ix=0xFFFF, num_labels=L)
    for kind, table in tabs.items():
        got = drive(f"search_step k=32 ({kind})", ("ascii_pack", K32_PROBES[kind]),
                    lambda: lookup.search_step(table, reads, lens, **kw))
        ref = lookup.window_ids(table, hp, hv, hl, do_rc=True, bad_ix=0xFFFF, num_labels=L,
                                true_len=(READ_LEN + 7) & ~7, probe_iters=index.probe_iters)
        w8 = ref.shape[1] // 2
        if not torch.equal(got, torch.cat([ref[:, :w], ref[:, w8:w8 + w]], 1)):
            fail(f"search_step k=32 ({kind}) differs from window_ids on host-packed reads")
        ms = cuda_ms(lambda: lookup.search_step(table, reads, lens, **kw), 5)
        log(f"search_step k=32 ({kind}): equal to window_ids after the trim; {ms:.4f} ms "
            f"a batch, {int((got < L).sum()):,} hits")
        if kind in ("bsearch", "t1"):
            hkw = {k: v for k, v in kw.items() if k != "num_labels"}
            hist = drive(f"search_step_hist k=32 ({kind})", ("ascii_pack", "histogram_unpacked"),
                         lambda: lookup.search_step_hist(table, reads, lens, num_labels=L,
                                                         cap=HIST_CAP, **hkw))
            if not torch.equal(hist, lookup.unpacked_hist(got, L, HIST_CAP)):
                fail(f"search_step_hist k=32 ({kind}) differs from its plain version")
    log("search_step_hist k=32: bsearch and hash rows equal the plain histogram")

    # the sharded modes, every device on this card
    bs = tabs["bsearch"]
    single = {rc: lookup.search_step(bs, reads, lens, **{**kw, "do_rc": rc})
              for rc in (True, False)}
    stats = {}
    m21 = make_mesh(2, 1, [dev] * 2)
    rstep, rtabs = S.replicated_search_step(m21, index, do_rc=True), m21.replicate(bs)
    got = drive("replicated (2, 1)", ("ascii_pack", "bsearch_probe"),
                lambda: rstep(rtabs, reads, lens))
    if not torch.equal(got, single[True]):
        fail("replicated step (2, 1) differs from the single-device search_step")
    stats["replicated_reads_per_s"] = b / timed_step(lambda: rstep(rtabs, reads, lens))
    for shape in ((2, 4), (1, 8)):
        mesh = make_mesh(*shape, [dev] * (shape[0] * shape[1]))
        sh = S.ShardedIndex.from_index(index, shape[1])
        stabs = sh.to_devices(mesh)
        steps = {rc: S.sharded_search_step(mesh, sh, do_rc=rc) for rc in (True, False)}
        for rc, step in steps.items():
            got = drive(f"prefix-sharded {shape} rc={rc}", ("ascii_pack", "bsearch_probe_shard"),
                        lambda: step(stabs, reads, lens))
            if not torch.equal(got, single[rc]):
                fail(f"prefix-sharded step {shape} rc={rc} differs from search_step")
        tag = f"sharded_{shape[0]}x{shape[1]}_reads_per_s"
        stats[tag] = b / timed_step(lambda: steps[True](stabs, reads, lens))
        if shape == (2, 4):  # K15 on slice 0 of the 4-way index
            s0, lo, per = stabs[0], int(sh.prefix_lo[0]), int(sh.bin_ix.shape[1] - 1)
    log(f"sharded steps equal the single-device search_step; replicated (2, 1) "
        f"{stats['replicated_reads_per_s']:,.0f}, prefix-sharded (2, 4) "
        f"{stats['sharded_2x4_reads_per_s']:,.0f}, (1, 8) "
        f"{stats['sharded_1x8_reads_per_s']:,.0f} reads/s (best of 3, host clock)")
    pkw = dict(prefix_lo=lo, width=READ_LEN, do_rc=True, probe_iters=index.probe_iters)
    ix, found = S.shard_probe(s0, packed, vbits, lens, **pkw)
    qpre, _, _, valid = lookup.window_lanes(reads, lens, 32, True)
    mine = valid & (qpre >= lo) & (qpre < lo + per)
    in_range = int(mine.sum())
    local = (qpre[mine] - lo).long()
    bins = s0["bin_ix"].long()
    filled = int((bins[local + 1] > bins[local]).sum())
    del qpre, valid, mine, local, bins
    # K15's function needs, for each in-range word, a bin_ix sector and,
    # where its bin is not empty, its records' (suf_hi, suf_lo) sectors (a
    # found word its id too), each array at most once, plus the outputs:
    # the bound is the smaller of two layouts' counts.  The three arrays
    # need about three sectors a word; `rec`, which K15 reads, needs one
    # 16 B record (a sector) a word, but also carries an all-zero fourth
    # column, so at this shape its count is the larger, printed beside the
    # bound as the layout's cost.
    rec_bytes = (min(nbytes(s0["bin_ix"]), SECTOR * in_range)
                 + min(nbytes(s0["rec"]), SECTOR * filled))
    arrays_bytes = (sum(min(nbytes(s0[k]), SECTOR * in_range)
                        for k in ("bin_ix", "suf_hi", "suf_lo"))
                    + min(nbytes(s0["ix"]), SECTOR * int(found.sum())))
    out_bytes = nbytes(packed, vbits, lens, ix, found)
    k15_bytes = out_bytes + min(rec_bytes, arrays_bytes)
    log(f"K15 bound: {k15_bytes:,} bytes ({in_range:,} words in range, {filled:,} "
        f"of them in a bin that is not empty); over the three arrays "
        f"{out_bytes + arrays_bytes:,} bytes, over bin_ix and rec, the layout "
        f"K15 reads, {out_bytes + rec_bytes:,} bytes")
    rows.append(check_kernel(
        "bsearch_probe_shard", "bsearch_probe.cu", "utree_tpu/parallel/sharded.py:130",
        lambda: S.shard_probe(s0, packed, vbits, lens, **pkw),
        lambda: S.shard_probe_plain(s0, packed, vbits, lens, **pkw),
        f"{what}, slice 0 of 4 ({in_range:,} of {2 * b * w:,} words in range)",
        k15_bytes))

    # the long-read histogram over phase 8's long reads, a (4, 2) mesh
    m42 = make_mesh(4, 2, [dev] * 8)
    hstep, htabs = S.long_read_histogram(m42, index, L, do_rc=True), m42.replicate(bs)
    total, secs, bases = 0, 0.0, 0
    for seq in base["long_reads"]:
        chunks, clens = (torch.from_numpy(a) for a in S.split_long_read(seq, 8, 32))
        hist = drive(f"long-read histogram {len(seq):,} bp",
                     ("ascii_pack", "bsearch_probe", "label_histogram"),
                     lambda: hstep(htabs, chunks, clens))
        ids = lookup.search_step(bs, chunks.to(dev), clens.to(dev), **{
            k: v for k, v in kw.items() if k != "num_labels"}).cpu().numpy()
        if not np.array_equal(hist.cpu().numpy(), np.bincount(ids[ids < L], minlength=L)):
            fail(f"long-read histogram ({len(seq):,} bp) differs from the single device's")
        total += int(hist.sum())
        secs += timed_step(lambda: hstep(htabs, chunks, clens), 1)
        bases += len(seq)
    if total <= 0:
        fail("long-read histogram: no hit in any long read")
    stats["long_bases_per_s"] = bases / secs
    log(f"long-read histogram (4, 2): {len(base['long_reads'])} reads, {bases:,} bp, "
        f"{total:,} hits, equal to bincounts of the single-device ids; "
        f"{stats['long_bases_per_s']:,.0f} bases/s")
    seq = base["long_reads"][-1]
    chunks, clens = (torch.from_numpy(a).to(dev) for a in S.split_long_read(seq, 8, 32))
    ids0 = lookup.search_step(bs, chunks[:1], clens[:1], **{
        k: v for k, v in kw.items() if k != "num_labels"})
    rows.append(check_kernel(
        "label_histogram", "label_histogram.cu", "utree_tpu/parallel/sharded.py:215",
        lambda: S.label_histogram(ids0, L), lambda: S.label_histogram_plain(ids0, L),
        f"chunk 0 of 8 of the {len(seq):,} bp read, {ids0.numel():,} ids",
        nbytes(ids0) + 4 * L,
        # the path's ids are >= 0, where bincount computes K16's function
        library=lambda: torch.bincount(torch.where(ids0 < L, ids0, L).view(-1),
                                       minlength=L + 1)[:L]))

    t = time.perf_counter()
    drive("dryrun_multichip(8) on one card",
          ("ascii_pack", "bsearch_probe_shard", "label_histogram", "route_displaced",
           "canonical_owner_probe", "routed_canonical_finish", "owner_probe",
           "routed_finish"),
          lambda: dryrun.dryrun_multichip(8, shard_devices=[dev] * 8))
    log(f"dryrun_multichip(8), every shard on this card: every block ran and agreed "
        f"({time.perf_counter() - t:.1f} s)")
    return rows, stats


def canonical_arrays(t: dict, wide: bool):
    """A ladder already on the card ({"c1", "c2", "c3"}) back as the
    CanonicalHashArrays it was placed from, without placing it again; the
    slot counts from the row widths, the entries counted from the slots."""
    from utree_tpu_torch.hash_index import CanonicalHashArrays

    cps = 4 if wide else 3
    t1, t2, t3 = (t[k].cpu().numpy() for k in ("c1", "c2", "c3"))
    ne = sum(int((a.reshape(-1, cps)[:, 2:] != 0).any(1).sum()) for a in (t1, t2, t3))
    return CanonicalHashArrays(t1=t1, t2=t2, t3=t3, slots=t1.shape[1] // cps,
                               slots2=t2.shape[1] // cps, slots3=t3.shape[1] // cps,
                               num_entries=ne)


def phase_routed_canonical(dev, base: dict) -> tuple[list[dict], dict]:
    """Phase 19: phase 6's ladder sharded ROUTED_SHARDS ways by t1 bucket
    range, every shard on the one card: K11 at b1, K17, K18 against their
    plain versions; the routed canonical step over all the reads on (1, 4)
    equal to the single-device rows, its fallback at capacity 8, both steps
    and phase 15's displaced ones on (2, 4); then a ladder of phase 7's wide
    2M tier through the _wide entry points, held to the single device and
    to CPU shards."""
    import numpy as np
    import torch

    from utree_tpu_torch import lookup
    from utree_tpu_torch.hash_index import build_canonical_hash_index, canonical_to_device
    from utree_tpu_torch.parallel import routed as R
    from utree_tpu_torch.parallel.mesh import make_mesh

    index, reads, S = base["index"], base["reads"], ROUTED_SHARDS
    ladder = base["k32_tables"]["c1"]
    t = time.perf_counter()
    sh = R.ShardedCanonicalIndex.from_canonical(canonical_arrays(ladder, False), S)
    m14, m24 = make_mesh(1, S, [dev] * S), make_mesh(2, S, [dev] * 2 * S)
    tabs = sh.to_devices(m14)
    tabs24 = tabs * 2  # (2, 4) in mesh order d*S + s: both data rows share the copies
    log(f"routed canonical: phase 6's ladder to {S} shards on the card in "
        f"{time.perf_counter() - t:.1f} s; b1 {sh.b1}, t1 {tuple(sh.t1.shape)}, "
        f"t2 {tuple(sh.t2.shape)}, t3 {tuple(sh.t3.shape)}")
    rows = routed_checks(sh, tabs, m14, *batch_tensors(dev, reads),
                                   "routed canonical")

    kw = dict(do_rc=True, num_labels=index.num_labels, cap=HIST_CAP,
              bad_ix=index.config.bad_ix)
    bad = min(index.config.bad_ix, 0x7FFFFFFF)
    batches = [batch_tensors(dev, reads, i) for i in range(0, len(reads), BATCH)]
    single = [lookup.search_step_hist_packed(ladder, *bt, do_rc=True, bad_ix=bad,
                                             num_labels=index.num_labels, cap=HIST_CAP)
              for bt in batches]

    def run_all(step, tables, tag: str, expect, oflo: int = 0):
        """Every batch through `step`; the overflow column must be `oflo` and,
        where it is 0, the rows the single-device ladder's."""
        got = drive(tag, expect, lambda: [torch.cat(step(tables, *bt)) for bt in batches])
        for g, want in zip(got, single):
            if g.shape[1] == HIST_CAP + 2:
                if not (g[:, -1] == oflo).all():
                    fail(f"{tag}: overflow column {int(g[0, -1])}, expected {oflo}")
                g = g[:, :-1]
            if not oflo and not torch.equal(g, want):
                fail(f"{tag}: rows differ from the single-device ladder's")
        rps = len(reads) / timed_step(lambda: [step(tables, *bt) for bt in batches])
        log(f"{tag}: {len(reads)} reads in {len(batches)} batches, overflow column "
            f"{oflo}" + ("" if oflo else ", rows equal the single-device ladder's "
                         "(search_step_hist_packed)")
            + f"; {rps:,.0f} reads/s (device work only, best of 3, host clock)")
        return rps

    canon = ("route_displaced", "canonical_owner_probe", "routed_canonical_finish",
             "histogram_packed")
    disp = ("route_displaced", "owner_probe", "routed_finish", "histogram_packed")
    stats = {"reads_per_s": run_all(R.routed_canonical_search_step(m14, sh, **kw), tabs,
                                    f"routed canonical (1, {S})", canon)}
    run_all(R.routed_canonical_search_step(m14, sh, capacity=8, **kw), tabs,
            f"routed canonical (1, {S}) capacity 8", canon, oflo=S)
    stats["fallback_reads_per_s"] = run_all(R.routed_fallback_step(m14, sh, **kw), tabs,
                                            f"routed canonical fallback (1, {S})", canon)
    # the (data, table) mesh: both canonical steps and phase 15's displaced ones
    stats["reads_per_s_2x4"] = run_all(R.routed_canonical_search_step(m24, sh, **kw),
                                       tabs24, f"routed canonical (2, {S})", canon)
    run_all(R.routed_fallback_step(m24, sh, **kw), tabs24,
            f"routed canonical fallback (2, {S})", canon)
    dsh = base["routed_displaced"]
    dtabs = dsh.to_devices(m24)
    run_all(R.routed_displaced_search_step(m24, dsh, **kw), dtabs,
            f"routed displaced (2, {S})", disp)
    run_all(R.routed_displaced_fallback_step(m24, dsh, **kw), dtabs,
            f"routed displaced fallback (2, {S})", disp)
    del dtabs, tabs, tabs24

    # wide labels: a ladder of phase 7's 2M tier (IXTYPE=u32)
    windex, genome, _ = make_tier(WIDE_DISPLACED_KMERS, WIDE_LABELS, ixtype_bytes=4)
    canon = build_canonical_hash_index(windex)
    wladder = canonical_to_device(canon, dev)
    wsh = R.ShardedCanonicalIndex.from_canonical(canon, S)
    if not wsh.wide:
        fail("routed canonical wide: the 70,000-label ladder is not wide")
    wtabs = wsh.to_devices(m14)
    wbatch = batch_tensors(dev, make_reads(genome, np.random.default_rng(19), BATCH))
    rows += routed_checks(wsh, wtabs, m14, *wbatch, "routed canonical wide")
    wkw = dict(do_rc=True, num_labels=windex.num_labels, cap=HIST_CAP,
               bad_ix=windex.config.bad_ix)
    wstep = R.routed_canonical_search_step(m14, wsh, **wkw)
    got = drive("routed canonical wide step",
                ("route_displaced", "canonical_owner_probe_wide",
                 "routed_canonical_finish_wide", "histogram_packed"),
                lambda: torch.cat(wstep(wtabs, *wbatch)))
    want = lookup.search_step_hist_packed(wladder, *wbatch, do_rc=True, bad_ix=0x7FFFFFFF,
                                          num_labels=windex.num_labels, cap=HIST_CAP)
    if int(got[0, -1]) != 0 or not torch.equal(got[:, :-1], want):
        fail("routed canonical wide step: rows differ from the single-device ladder's")
    cpu = make_mesh(1, S, ["cpu"] * S)
    sub = [x[:WIDE_ROUTED_CHECK].cpu() for x in wbatch]
    cwant = torch.cat(R.routed_canonical_search_step(cpu, wsh, **wkw)(wsh.to_devices(cpu), *sub))
    if not torch.equal(got[:WIDE_ROUTED_CHECK].cpu(), cwant):
        fail("routed canonical wide step: the card's rows differ from the CPU shards' "
             f"(first {WIDE_ROUTED_CHECK} reads)")
    stats["wide_reads_per_s"] = BATCH / timed_step(lambda: wstep(wtabs, *wbatch))
    hits = int(((got[:, 0] & 0xFFFF) != 0).sum())
    log(f"routed canonical wide step: {windex.num_labels} labels, rows equal the "
        f"single-device ladder's and, for the first {WIDE_ROUTED_CHECK} reads, the CPU "
        f"shards'; {hits} of {BATCH} reads hit; {stats['wide_reads_per_s']:,.0f} reads/s "
        "(device work only, best of 3, host clock)")
    log("routed canonical: no pipeline or CLI path reaches these steps (as in "
        "utree_tpu), so they have no end-to-end rate")
    return rows, stats


def run(dev, kmers: int, nreads: int, work: pathlib.Path) -> dict:
    """Phases 3-19 on `dev`; returns what main() checks and prints."""
    from utree_tpu_torch.classify_device import (aufbau_tables_to_device,
                                                 build_aufbau_tables)
    from utree_tpu_torch.hash_index import displaced_to_device
    from utree_tpu_torch.pipeline import SearchPipeline

    t0 = time.perf_counter()
    index, genome, rng = make_tier(kmers, LABELS)
    disp = load_or_build_displaced(index, kmers, LABELS, ROOT / ".bench_cache")
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

    # phase 4: the displaced path, twice over the same pipeline
    pipe = SearchPipeline(index, device=dev, do_rc=True, batch_size=BATCH,
                          hist_cap=HIST_CAP, lookup_mode="displaced", _table=table)
    best = e2e(pipe, reads_fa, out_txt, nreads, "displaced e2e",
               ("scan_probe", "histogram", "aufbau_vote"))
    del pipe
    # phase 5: independent check against the exact host path
    base = dict(index=index, host=index.host_index(), genome=genome, reads=reads,
                reads_fa=reads_fa, out_txt=out_txt, table=table,
                k32_tables={"d1": table})  # phase 18's, filled by phases 6, 10, 13
    host_check(base["host"], reads, out_txt, work, "displaced")

    ladder_pipe, row, ladder = phase_ladder(dev, base, work)
    kern.append(row)
    wide_rows, wide = phase_wide(dev, kmers, base, work)
    kern += wide_rows
    long_row, long = phase_long(dev, ladder_pipe, base, work)
    kern.append(long_row)
    del ladder_pipe
    bs_row, bsearch = phase_bsearch(dev, base, work)
    kern.append(bs_row)
    k64_rows, k64 = phase_k64(dev, kmers, nreads, work)
    kern += k64_rows
    compact_row, compact = phase_compact(dev, base, work)
    kern.append(compact_row)
    xt_row, xtree = phase_xtree(dev, work)
    kern.append(xt_row)
    hash_row, hashed = phase_hash(dev, base, work)
    kern.append(hash_row)
    shallow = phase_shallow(base, work)
    secs = {}
    t = time.perf_counter()
    routed_rows, routed = phase_routed(dev, base, work)
    kern += routed_rows
    secs["routed"] = time.perf_counter() - t
    t = time.perf_counter()
    dp = phase_data_parallel(dev, base, work)
    secs["data parallel"] = time.perf_counter() - t
    multihost = phase_multihost(dev, base, kmers, work)
    secs["multihost"] = multihost["seconds"]
    t = time.perf_counter()
    sharded_rows, sharded = phase_sharded(dev, base)
    kern += sharded_rows
    secs["sharded"] = time.perf_counter() - t
    t = time.perf_counter()
    rc_rows, routed_canonical = phase_routed_canonical(dev, base)
    kern += rc_rows
    secs["routed canonical"] = time.perf_counter() - t
    log("phases 15-19 took " + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()))
    for k in kern:
        k["launches"] = PATH_LAUNCHES.get(k["name"], 0)
    return {"kernels": kern, "displaced_rps": best, "ladder": ladder,
            "wide": wide, "long": long, "bsearch": bsearch, "k64": k64,
            "compact": compact, "xtree": xtree, "hash": hashed,
            "shallow": shallow, "routed": routed, "dp": dp, "sharded": sharded,
            "routed_canonical": routed_canonical}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kmers", type=int, default=20_000_000,
                    help="tier size (bench.py's headline tier is 150000000)")
    ap.add_argument("--reads", type=int, default=262_144)
    ap.add_argument("--multihost-worker", nargs=6, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.multihost_worker:  # phase 17's processes: rank, port, kmers, reads, out, device
        sys.path.insert(0, str(ROOT))
        r, port, kmers, reads_fa, out, device = a.multihost_worker
        return multihost_worker(int(r), int(port), int(kmers), reads_fa, out, device)

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
    from utree_tpu_torch.kernels import KERNELS, build, library, ptxas_usage

    so, secs, ptxas = build()
    library()
    PTXAS.extend(ptxas_usage(ptxas))
    log(f"build: {so.name} in {secs:.1f} s (0.0 = already built)")
    for name, usage in PTXAS:
        # K2's streamed branch and K11's kernels by name, the rest by usage
        # (and phases 9, 10 and 18 print K5, K6, K7 and K15's by name)
        named = "histogram_rows" in name or "route_displaced_cu" in name
        log(f"  ptxas: {name if named else '...'}: {usage}")

    res = run(torch.device("cuda"), a.kmers, a.reads, ROOT / ".bench_cache")
    if sorted(k["name"] for k in res["kernels"]) != sorted(KERNELS):
        fail("the kernels line does not list every entry point")
    for k in res["kernels"]:
        if k["launches"] < 1:
            fail(f"kernel {k['name']} was not launched by its path")
    log(f"e2e: displaced {res['displaced_rps']:,.0f}, ladder "
        f"{res['ladder']['reads_per_s']:,.0f}, wide ladder "
        f"{res['wide']['ladder']['reads_per_s']:,.0f}, wide displaced (2M) "
        f"{res['wide']['displaced']['reads_per_s']:,.0f} reads/s (best of 2 "
        f"passes); long reads {res['long']['reads_per_s']:,.0f} reads/s, "
        f"{res['long']['bases_per_s']:,.0f} bases/s; bsearch "
        f"{res['bsearch']['reads_per_s']:,.0f}, k64 ladder "
        f"{res['k64']['canonical64']['reads_per_s']:,.0f}, k64 displaced "
        f"{res['k64']['displaced64']['reads_per_s']:,.0f} reads/s, k64 long "
        f"reads {res['k64']['long']['bases_per_s']:,.0f} bases/s; compact "
        f"support 8 {res['compact']['support8_reads_per_s']:,.0f}, compact C "
        f"vote {res['compact']['cvote_reads_per_s']:,.0f} reads/s; {a.kmers} "
        f"k-mers, RC, batch {BATCH}; xtree ALIGN ({res['xtree']['pods']:,} pods) "
        f"device front end {res['xtree']['device_queries_per_s']:,.0f}, host engine "
        f"{res['xtree']['host engine']['queries_per_s']:,.0f} queries/s; hash "
        f"{res['hash']['reads_per_s']:,.0f}, wide hash (2M) "
        f"{res['hash']['wide_reads_per_s']:,.0f}, rank-specific (host) "
        f"{res['shallow']['reads_per_s']:,.0f} reads/s; routed ({ROUTED_SHARDS} shards "
        f"on one card) {res['routed']['reads_per_s']:,.0f}, its forced fallback "
        f"{res['routed']['fallback_reads_per_s']:,.0f}, data parallel ({DP_SHARDS} "
        f"shards) {res['dp']['reads_per_s']:,.0f} reads/s; sharded (one card) "
        f"replicated (2, 1) {res['sharded']['replicated_reads_per_s']:,.0f}, "
        f"prefix-sharded (2, 4) {res['sharded']['sharded_2x4_reads_per_s']:,.0f}, "
        f"(1, 8) {res['sharded']['sharded_1x8_reads_per_s']:,.0f} reads/s, long-read "
        f"histogram (4, 2) {res['sharded']['long_bases_per_s']:,.0f} bases/s; routed "
        f"canonical (one card, device work) (1, {ROUTED_SHARDS}) "
        f"{res['routed_canonical']['reads_per_s']:,.0f}, its fallback "
        f"{res['routed_canonical']['fallback_reads_per_s']:,.0f}, wide "
        f"{res['routed_canonical']['wide_reads_per_s']:,.0f} reads/s; on {card}")
    print(json.dumps({"kernels": res["kernels"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
