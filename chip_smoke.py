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
   bench.py's synthetic tier (--kmers k-mers, 4096 labels, displaced table
   cached in .bench_cache/) and --reads reads of 150 bp written as bench.py
   writes them;
5. check: the first 2048 reads through utree_tpu.search_host (the exact host
   path) must give the same bytes as the port's lines for them;
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
   histogram_packed against pack_hist at the largest read's chunk shape;
   the whole output must equal utree_tpu.search_host's; reads/s and bases/s;
9. PACKSIZE=64 + IXTYPE=u32 (BASELINE config 4): bench's recipe at k=64
   (--kmers 64-mers, 70,000 labels); `auto` must resolve to the 64-mer
   ladder and lookup_mode="displaced" gives the 64-mer displaced table; for
   each, K6 ladder_probe64 or K5 scan_probe64 and K2 histogram_unpacked
   against their plain versions at B=65536 ASCII reads, the reads end to end
   twice and the host check; the two outputs must be byte-identical; 2048
   short and 4 long reads (20-200 kbp) through the ladder, whose whole
   output must equal utree_tpu.search_host's;
10. bsearch: the phase-4 tier under lookup_mode="bsearch"; K7 bsearch_probe
   against its plain version at phase 3's shapes; the reads end to end
   twice; the output must equal phase 4's byte for byte.

Every path run (phases 4, 6-10) starts with every launch count at 0 and
reads them just after; each kernel its path needs must have launched.
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
WIDE_LABELS = 70_000
WIDE_DISPLACED_KMERS = 2_000_000
HIST_CAP = 8
CHECK_READS = 2048
LONG_SHORT_READS = 8192
LONG_READS = 16
LONG_BP = (20_000, 1_000_000)  # shortest and longest long read
LONG64_BP = (20_000, 200_000)  # phase 9's four long reads

# launches summed over the path runs (each one counted from 0)
PATH_LAUNCHES: dict[str, int] = {}


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


def check_kernel(name, source, replaces, kernel, plain, what: str) -> dict:
    """One entry point against its plain version; both timed with CUDA
    events.  Returns its row of the kernels line."""
    got, want = kernel(), plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max_abs_err(got, want)
    ms, plain_ms = cuda_ms(kernel, 20), cuda_ms(plain, 3)
    log(f"kernel {name}: equal to plain at {what}; {ms:.4f} ms vs plain "
        f"{plain_ms:.4f} ms")
    return {"name": name, "route": "cuda", "source": f"utree_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms}


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


def batch_tensors(dev, reads):
    """The first BATCH reads as the pipeline packs them (width 192)."""
    import numpy as np
    import torch

    from utree_tpu_torch import lookup

    b = min(BATCH, len(reads))
    ascii_ = np.zeros((b, 192), np.uint8)  # the pipeline's width for 150 bp
    ascii_[:, :READ_LEN] = reads[:b]
    return [torch.from_numpy(a).to(dev) for a in lookup.pack_reads_host(
        ascii_, np.full(b, READ_LEN, np.int32))]


def e2e(pipe, reads_fa, out_txt, nreads: int, path: str, expect, passes: int = 2):
    """`passes` timed runs of search_file; returns the best reads/s."""
    from utree_tpu.utils.trace import PhaseTimer

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


def host_check(host_index, reads, out_txt, work: pathlib.Path, tag: str) -> None:
    """The port's lines for the first CHECK_READS reads (named r<i>) must
    equal utree_tpu.search_host's bytes for them."""
    from utree_tpu.search_host import search_file as host_search_file

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
    host_search_file(host_index, str(sub_fa), str(host_out), do_rc=True)
    if host_out.read_bytes() != b"".join(head):
        fail(f"{tag}: the port's lines for the first {CHECK_READS} reads differ "
             "from utree_tpu.search_host")
    log(f"{tag} check: first {CHECK_READS} reads ({len(head)} lines) "
        "byte-identical to utree_tpu.search_host")


def phase_kernels(dev, table, reads, index, max_iters):
    """Phase 3: K1, K2, K3 against their plain versions at B=65536."""
    from utree_tpu_torch import lookup
    from utree_tpu_torch.classify_device import aufbau_walk, pack_vote, vote_rows

    packed, vbits, lens = batch_tensors(dev, reads)
    b = packed.shape[0]
    L = index.num_labels
    kw = dict(do_rc=True, bad_ix=0xFFFF, true_len=(READ_LEN + 7) & ~7, num_labels=L)
    vt = {k[3:]: v for k, v in table.items() if k.startswith("vt_")}
    vkw = dict(taxacut=index.config.taxacut, max_iters=max_iters)
    ids = lookup.window_ids(table, packed, vbits, lens, **kw)
    hist = lookup.histogram(ids, L, HIST_CAP)
    rows = vote_rows(vt, *hist, **vkw)
    what = f"B={b}"
    out = [
        check_kernel("scan_probe", "scan_probe.cu", "utree_tpu/lookup.py:887",
                     lambda: lookup.window_ids(table, packed, vbits, lens, **kw),
                     lambda: lookup.window_ids_plain(table, packed, vbits, lens, **kw),
                     what),
        check_kernel("histogram", "histogram.cu", "utree_tpu/lookup.py:621",
                     lambda: lookup.histogram(ids, L, HIST_CAP),
                     lambda: lookup.compact_histogram(ids, L, HIST_CAP), what),
        check_kernel("aufbau_vote", "aufbau.cu", "utree_tpu/classify_device.py:113",
                     lambda: vote_rows(vt, *hist, **vkw),
                     lambda: pack_vote(*aufbau_walk(vt, *hist, **vkw), hist[2], hist[3]),
                     what),
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
    t = pipe._table
    geo = {k: tuple(t[k].shape) for k in ("c1", "c2", "c3")}
    log(f"ladder: auto -> canonical at {index.num_records:,} records; built in "
        f"{build_s:.1f} s; slots {geo['c1'][1] // 3}/{geo['c2'][1] // 3}/"
        f"{geo['c3'][1] // 3}; c1 {geo['c1']}, c2 {geo['c2']}, c3 {geo['c3']}")
    packed, vbits, lens = batch_tensors(dev, reads)
    kw = dict(do_rc=True, bad_ix=0xFFFF, true_len=(READ_LEN + 7) & ~7,
              num_labels=index.num_labels)
    row = check_kernel("ladder_probe", "ladder_probe.cu", "utree_tpu/lookup.py:349",
                       lambda: lookup.window_ids(t, packed, vbits, lens, **kw),
                       lambda: lookup.window_ids_plain(t, packed, vbits, lens, **kw),
                       f"B={packed.shape[0]}")
    out_txt = work / "smoke_ladder.txt"
    rps = e2e(pipe, base["reads_fa"], out_txt, len(reads), "ladder e2e",
              ("ladder_probe", "histogram", "aufbau_vote"))
    if out_txt.read_bytes() != base["out_txt"].read_bytes():
        fail("the ladder's output differs from the displaced table's")
    log("ladder: whole output byte-identical to the displaced run (phase 4)")
    host_check(base["host"], reads, out_txt, work, "ladder")
    return pipe, row, {"reads_per_s": rps, "build_s": build_s, "geometry": geo}


def u32_index(words, ixs, strings):
    """DeviceIndexArrays.from_build of an IXTYPE=u32 DB.  utree_tpu.index
    fills its sentinel record with np.full(n + 1, cfg.bad_ix, np.int32):
    NumPy 2.0 wraps 2^32-1 to -1, newer NumPy raises OverflowError.  So the
    index is built under the u16 config, the sentinel set to the -1 the u32
    build gives, and the config re-tagged (no lookup reads the sentinel's
    id, and nothing else in the index depends on IXTYPE)."""
    import dataclasses

    from utree_tpu.config import UTreeConfig
    from utree_tpu.index import DeviceIndexArrays

    index = DeviceIndexArrays.from_build(words, ixs, strings, UTreeConfig())
    index.ix[-1] = -1
    return dataclasses.replace(index, config=UTreeConfig(ixtype_bytes=4))


def index64(words, ixs, strings, ixtype_bytes: int = 4):
    """DeviceIndexArrays.from_build of a PACKSIZE=64 DB (IXTYPE=u32 unless
    asked) from sorted, de-duplicated W128 words.  The shared 64-mer table builders
    raise OverflowError when the lowest populated prefix bin holds a single
    record whose suffix is not below the next bin's first one (ROADMAP §C):
    the reference folds that record into the next bin, and the builders'
    slow path for the unsorted bin this makes shifts an np.int64 by 104
    bits.  So while the lowest bin holds one such record, that k-mer is
    dropped from the DB; reads that hit it then miss in every path alike."""
    import numpy as np

    from utree_tpu.config import UTreeConfig
    from utree_tpu.index import DeviceIndexArrays

    hi, lo = words["hi"], words["lo"]
    pre, suf = hi >> np.uint64(40), hi & np.uint64((1 << 40) - 1)
    drop = 0
    while (len(words) - drop > 1 and pre[drop] != pre[drop + 1]
           and (suf[drop], lo[drop]) >= (suf[drop + 1], lo[drop + 1])):
        log(f"tier64: dropped k-mer {drop} (alone in prefix bin {int(pre[drop])}, "
            "it would unsort the next bin), working around the shared "
            "builders' fault, ROADMAP §C")
        drop += 1
    return DeviceIndexArrays.from_build(
        words[drop:], ixs[drop:], strings,
        UTreeConfig(packsize=64, ixtype_bytes=ixtype_bytes))


def tier64(kmers: int, labels: int):
    """bench.make_tier_index's recipe at k=64 (BASELINE config 4): a genome
    of kmers+63 bases (rng seed 0), its dense 64-mer set sorted and
    de-duplicated, `labels` region labels with NUL bytes stripped, as an
    IXTYPE=u32 index (index64).  Returns (index, genome, rng)."""
    import numpy as np

    from utree_tpu.encode import sample_build_kmers

    rng = np.random.default_rng(0)
    genome = rng.choice(np.frombuffer(ACGT, np.uint8), size=kmers + 63).astype(np.uint8)
    words = sample_build_kmers(genome.tobytes(), 64, 0)
    pos_labels = (np.arange(len(words), dtype=np.int64) * labels) // len(words)
    order = np.lexsort((words["lo"], words["hi"]))
    sw = words[order]
    keep = np.ones(len(sw), bool)
    keep[1:] = (sw["hi"][1:] != sw["hi"][:-1]) | (sw["lo"][1:] != sw["lo"][:-1])
    ranks = b"kpcofgst"
    strings = []
    for i in range(labels):
        tok = bytes(97 + rng.integers(0, 26, size=4))  # as bench: int64 bytes
        strings.append(b";".join(ranks[d:d + 1] + b"__" + tok + str(i % 97).encode()
                                 for d in range(8)).replace(b"\x00", b""))
    return index64(sw[keep], pos_labels[order][keep], strings), genome, rng


def wide_tier(kmers: int):
    """bench's tier with WIDE_LABELS labels, rebuilt as an IXTYPE=u32 index
    (bench's config is u16, whose bad_ix would collide with a label id);
    NUL bytes stripped as in phase 4."""
    import bench

    _, sw, ixs, labels, genome, _cfg, rng = bench.make_tier_index(kmers, WIDE_LABELS)
    strings = [s.replace(b"\x00", b"") for s in labels]
    return u32_index(sw, ixs, strings), genome, rng


def phase_wide(dev, kmers: int, base: dict, work: pathlib.Path):
    """Phase 7: wide labels on the ladder (--kmers, auto) and on the
    displaced table (2M k-mers)."""
    from utree_tpu_torch import lookup
    from utree_tpu_torch.pipeline import SearchPipeline

    rows, stats = [], {}
    for kind, n_kmers in (("ladder", kmers), ("displaced", WIDE_DISPLACED_KMERS)):
        t0 = time.perf_counter()
        index, genome, rng = wide_tier(n_kmers)
        pipe = SearchPipeline(index, device=dev, do_rc=True, batch_size=BATCH,
                              hist_cap=HIST_CAP,
                              lookup_mode="auto" if kind == "ladder" else "displaced")
        build_s = time.perf_counter() - t0
        if pipe.table_kind != ("canonical" if kind == "ladder" else "displaced"):
            fail(f"wide {kind}: resolved to {pipe.table_kind}")
        if pipe.layout != "unpacked":
            fail(f"wide {kind}: layout {pipe.layout}, expected unpacked")
        t = pipe._table
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
        rows.append(check_kernel(
            name, source, replaces,
            lambda: lookup.window_ids(t, packed, vbits, lens, **kw),
            lambda: lookup.window_ids_plain(t, packed, vbits, lens, **kw), what))
        if kind == "ladder":
            ids = lookup.window_ids(t, packed, vbits, lens, **kw)
            rows.append(check_kernel(
                "histogram_unpacked", "histogram.cu", "utree_tpu/lookup.py:820",
                lambda: lookup.histogram_unpacked(ids, L, HIST_CAP),
                lambda: lookup.unpacked_hist(ids, L, HIST_CAP), what))
        out_txt = work / f"smoke_wide_{kind}.txt"
        rps = e2e(pipe, reads_fa, out_txt, len(reads), f"wide {kind} e2e",
                  (name, "histogram_unpacked"))
        host_check(index.host_index(), reads, out_txt, work, f"wide_{kind}")
        stats[kind] = {"reads_per_s": rps, "setup_s": build_s}
        del pipe, t
    return rows, stats


def phase_long(dev, pipe, base: dict, work: pathlib.Path):
    """Phase 8: long reads mixed with short ones on the phase-6 ladder."""
    import numpy as np
    import torch

    from utree_tpu.search_host import search_file as host_search_file
    from utree_tpu.utils.trace import PhaseTimer
    from utree_tpu_torch import lookup
    from utree_tpu_torch.parallel.sharded import split_long_read

    genome, index = base["genome"], base["index"]
    rng = np.random.default_rng(8)
    acgt = np.frombuffer(ACGT, np.uint8)
    sizes = np.geomspace(*LONG_BP, LONG_READS).astype(np.int64)
    longs = []
    for size in sizes:
        s = int(rng.integers(0, len(genome) - size))
        seq = genome[s:s + size].copy()
        mut = rng.random(size) < 0.01
        seq[mut] = rng.choice(acgt, int(mut.sum()))
        longs.append(seq.tobytes())
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

    # histogram_packed at the largest read's chunk shape (the streamed branch)
    k = index.config.packsize
    n_chunks = 1
    while n_chunks * pipe.long_chunk < len(longs[-1]) - k + 1:
        n_chunks *= 2
    chunks, clens = split_long_read(longs[-1], n_chunks, k)
    chunks = np.pad(chunks, ((0, 0), (0, (-chunks.shape[1]) % 8)))
    packed, vbits, lens = (torch.from_numpy(a).to(dev)
                           for a in lookup.pack_reads_host(chunks, clens))
    L = index.num_labels
    ids = lookup.window_ids(pipe._table, packed, vbits, lens, do_rc=True,
                            bad_ix=0xFFFF, num_labels=L)
    row = check_kernel("histogram_packed", "histogram.cu", "utree_tpu/lookup.py:811",
                       lambda: lookup.histogram_packed(ids, L, HIST_CAP),
                       lambda: lookup.pack_hist(ids, L, HIST_CAP),
                       f"{n_chunks} chunks x {ids.shape[1]} ids")
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
        fail("long reads: the port's output differs from utree_tpu.search_host")
    log(f"long reads check: whole output ({len(host_out.read_bytes().splitlines())} "
        f"lines) byte-identical to utree_tpu.search_host ({time.perf_counter() - t:.1f} s)")
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
        tab = pipe._table
        log(f"k64 {kind}: table built in {build_s:.1f} s, "
            + ", ".join(f"{k} {tuple(v.shape)}" for k, v in tab.items()))
        what = f"B={b} ASCII reads, L=192, {L} labels"
        rows.append(check_kernel(
            name, f"{name}.cu", "utree_tpu/lookup.py:" + ("460" if mode == "auto" else "521"),
            lambda: lookup.window_ids64(tab, rt, lt, **kw),
            lambda: lookup.window_ids64_plain(tab, rt, lt, **kw), what))
        ids = lookup.window_ids64(tab, rt, lt, **kw)
        check_kernel("histogram_unpacked", "histogram.cu", "utree_tpu/lookup.py:662",
                     lambda: lookup.histogram_unpacked(ids, L, HIST_CAP),
                     lambda: lookup.unpacked_hist(ids, L, HIST_CAP), what + f", {kind} ids")
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


def long64(pipe, genome, reads, host, work: pathlib.Path) -> dict:
    """Phase 9's long-read file: CHECK_READS short reads and 4 long reads of
    LONG64_BP (1% mutation) through the PACKSIZE=64 ladder; the whole output
    must equal utree_tpu.search_host's."""
    import numpy as np

    from utree_tpu.search_host import search_file as host_search_file

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
        fail("k64 long reads: the port's output differs from utree_tpu.search_host")
    log(f"k64 long reads: {CHECK_READS} short + 4 long reads ({bases:,} bp) in "
        f"{dt:.3f} s = {bases / dt:,.0f} bases/s; whole output "
        f"({len(out_txt.read_bytes().splitlines())} lines) byte-identical to "
        "utree_tpu.search_host")
    return {"bases_per_s": bases / dt, "seconds": dt}


def phase_bsearch(dev, base: dict, work: pathlib.Path):
    """Phase 10: the bsearch replay over the phase-4 tier's CTR records."""
    from utree_tpu_torch import lookup
    from utree_tpu_torch.pipeline import SearchPipeline

    index, reads = base["index"], base["reads"]
    t = time.perf_counter()
    pipe = SearchPipeline(index, device=dev, do_rc=True, batch_size=BATCH,
                          hist_cap=HIST_CAP, lookup_mode="bsearch")
    if pipe.table_kind != "bsearch" or pipe.layout != "vote":
        fail(f"bsearch: resolved to {pipe.table_kind}, layout {pipe.layout}")
    tab = pipe._table
    log(f"bsearch: records on the card in {time.perf_counter() - t:.1f} s, probe_iters "
        f"{index.probe_iters}, " + ", ".join(f"{k} {tuple(v.shape)}" for k, v in tab.items()
                                             if not k.startswith("vt_")))
    packed, vbits, lens = batch_tensors(dev, reads)
    kw = dict(do_rc=True, bad_ix=0xFFFF, true_len=(READ_LEN + 7) & ~7,
              num_labels=index.num_labels, probe_iters=index.probe_iters)
    row = check_kernel("bsearch_probe", "bsearch_probe.cu", "utree_tpu/lookup.py:149",
                       lambda: lookup.window_ids(tab, packed, vbits, lens, **kw),
                       lambda: lookup.window_ids_plain(tab, packed, vbits, lens, **kw),
                       f"B={packed.shape[0]}")
    out_txt = work / "smoke_bsearch.txt"
    rps = e2e(pipe, base["reads_fa"], out_txt, len(reads), "bsearch e2e",
              ("bsearch_probe", "histogram", "aufbau_vote"))
    if out_txt.read_bytes() != base["out_txt"].read_bytes():
        fail("the bsearch replay's output differs from the displaced table's")
    log("bsearch: whole output byte-identical to the displaced run (phase 4)")
    return row, {"reads_per_s": rps}


def run(dev, kmers: int, nreads: int, work: pathlib.Path) -> dict:
    """Phases 3-10 on `dev`; returns what main() checks and prints."""
    import bench
    from utree_tpu.classify_device import build_aufbau_tables
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

    # phase 4: the displaced path, twice over the same pipeline
    pipe = SearchPipeline(index, device=dev, do_rc=True, batch_size=BATCH,
                          hist_cap=HIST_CAP, lookup_mode="displaced", _table=table)
    best = e2e(pipe, reads_fa, out_txt, nreads, "displaced e2e",
               ("scan_probe", "histogram", "aufbau_vote"))
    del pipe
    # phase 5: independent check against the exact host path
    base = dict(index=index, host=index.host_index(), genome=genome, reads=reads,
                reads_fa=reads_fa, out_txt=out_txt)
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
    for k in kern:
        k["launches"] = PATH_LAUNCHES.get(k["name"], 0)
    return {"kernels": kern, "displaced_rps": best, "ladder": ladder,
            "wide": wide, "long": long, "bsearch": bsearch, "k64": k64}


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
    from utree_tpu_torch.kernels import KERNELS, build, library

    so, secs, ptxas = build()
    library()
    log(f"build: {so.name} in {secs:.1f} s (0.0 = already built)")
    for ln in ptxas.splitlines():
        if "registers" in ln or "spill" in ln:
            log(f"  ptxas: {ln.strip()}")

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
        f"reads {res['k64']['long']['bases_per_s']:,.0f} bases/s; {a.kmers} "
        f"k-mers, RC, batch {BATCH}, on {card}")
    print(json.dumps({"kernels": res["kernels"]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
