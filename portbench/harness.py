"""One run of one cell: set-up, the timed window, the traced window's
readings, and the check of what the window produced against the plain
reference.

Set-up makes the inputs from the seed (generate.py), builds the program's
index and `SearchPipeline`, writes the sample as FASTA under the temporary
directory and searches it once, untimed.  The window then runs
`SearchPipeline.search_file(sample, out)` back to back, overwriting one
output file, until `seconds` have passed and the sample then running has
finished.  The harness does nothing else inside the window.  After it: the
device's peak memory, the look for JAX among the loaded modules, the
program freed, then the reference over the same database and reads, held to
the bytes of the last sample's output.
"""

from __future__ import annotations

import gc
import os
import pathlib
import sys
import tempfile
import time

import numpy as np

from portbench import generate, spec, tracing
from portbench.metrics import Context, reader

# top-level module names that must not be loaded in the process that
# prints a result: JAX, and the JAX package the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "utree_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is forbidden, compared whole
    (`utree_tpu_torch` is not `utree_tpu`)."""
    return sorted({m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN})


def work_counts(reads: np.ndarray, traffic: dict, config: dict, records: int,
                samples: int) -> dict:
    """What `samples` searches of the sample ask of the program, from the
    reads alone: per batch (the file's reads in `batch_size` runs) the read
    positions that start a valid 32-mer; over all batches the valid windows
    of both strands (`ids`), the batch rows and the reads' bytes at 3 bits a
    base; and the sizes the rooflines take."""
    k = generate.K
    ok = np.isin(reads, np.frombuffer(b"ACGTacgt", np.uint8))
    bad = np.concatenate([np.zeros((len(reads), 1), np.int64),
                          np.cumsum(~ok, axis=1)], axis=1)
    positions = ((bad[:, k:] - bad[:, :-k]) == 0).sum(axis=1)
    b = traffic["batch_size"]
    batch_positions = [int(positions[a:a + b].sum()) for a in range(0, len(reads), b)]
    strands = 2 if traffic["rc"] else 1
    return dict(
        batch_positions=batch_positions * samples,
        ids=strands * int(positions.sum()) * samples,
        rows=len(reads) * samples,
        read_bytes=3 * reads.size / 8 * samples,
        ctr_bytes=7 * records + 4 * ((1 << generate.PRE_BITS) + 1),
        hist_cap=traffic["hist_cap"],
        id_bytes=config["ixtype_bytes"],
    )


def compare(out: bytes, want: list[bytes]) -> dict:
    """The numbers that decide `correct`, each with its limit: reads whose
    line differs from the reference's, is missing or is extra
    (`reads_differing`), and lines out of read order or repeated
    (`order_faults`)."""
    got = out.split(b"\n")
    tail = got.pop()  # the text after the last newline: empty in a whole file
    name = lambda line: line.split(b"\t", 1)[0]
    got_by = {name(x): x for x in got}
    want_by = {name(x): x for x in want}
    differing = sum(got_by.get(n) != x for n, x in want_by.items())
    differing += sum(n not in want_by for n in got_by)
    names = [name(x) for x in got]
    order = len(got) - len(got_by) + sum(a >= b for a, b in zip(names, names[1:]))
    return {"reads_differing": {"value": differing, "limit": 0},
            "order_faults": {"value": order + (1 if tail else 0), "limit": 0}}


def read_metrics(names: list[str], ctx: Context, units: dict, strict: bool, log) -> dict:
    """The result line's metrics.  A metric the cell declares that finds
    nothing to read fails the run where `strict` (on a card), and is left out
    with a log line otherwise (on the CPU, where no device trace exists)."""
    metrics = {}
    for m in names:
        v = reader(m)(ctx)
        if v is not None:
            metrics[m] = {"value": float(v), "unit": units[m]}
        elif strict:
            raise RuntimeError(f"metric {m} found nothing to read in this run; list the "
                               "cells it applies to under its `workloads` key")
        else:
            log(f"metric {m}: nothing to read in this run")
    return metrics


def process_age() -> float:
    """Seconds since this process started (Linux clock ticks)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def run(cell: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
        log=print, age=process_age) -> dict:
    """One run of `cell` (spec.load's dict); returns the result line's
    object.  `log` takes the lines for standard error."""
    import torch

    from utree_tpu_torch.config import UTreeConfig
    from utree_tpu_torch.index import DeviceIndexArrays
    from utree_tpu_torch.pipeline import SearchPipeline

    config, traffic = cell["config"], cell["traffic"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    inputs = generate.make_inputs(config, traffic, seed, dev)
    words, ixs, strings, reads = (inputs[k] for k in ("words", "ixs", "strings", "reads"))
    log(f"inputs: {len(words):,} records over {inputs['genome_bp']:,} bp, "
        f"{len(strings):,} labels, {len(reads):,} reads in {inputs['gen_s']:.3f} s")
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    index = DeviceIndexArrays.from_build(words, ixs, strings, UTreeConfig(
        complevel=config["complevel"], ixtype_bytes=config["ixtype_bytes"],
        taxacut=config["taxacut"]))
    db_load_s = time.perf_counter() - t
    recorder = tracing.Recorder() if trace else None
    t = time.perf_counter()
    pipe = SearchPipeline(index, device=dev, do_rc=traffic["rc"],
                          batch_size=traffic["batch_size"], hist_cap=traffic["hist_cap"],
                          lookup_mode=config["lookup_mode"],
                          support_ranges=traffic["support_ranges"], tracer=recorder)
    if cuda:
        torch.cuda.synchronize(dev)
    table_build_s = time.perf_counter() - t
    log(f"program: table {pipe.table_kind}, layout {pipe.layout}; index "
        f"{db_load_s:.3f} s, SearchPipeline {table_build_s:.3f} s")
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        sample = pathlib.Path(tmp, "sample.fa")
        out = pathlib.Path(tmp, "out.txt")
        t = time.perf_counter()
        sample.write_bytes(generate.fasta_bytes(reads))
        t_sample = time.perf_counter() - t
        warm = pipe.search_file(str(sample), str(out))  # the untimed pass
        log(f"sample: written in {t_sample:.3f} s, searched untimed in "
            f"{time.perf_counter() - t - t_sample:.3f} s")
        gc.collect()
        gc.freeze()
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU]
                           + ([ProfilerActivity.CUDA] if cuda else []))
            prof.__enter__()
        setup_s = age()
        counts, ends = [], []
        with tracing.span("window", trace):
            t0 = time.perf_counter()
            end = t0 + seconds
            while True:
                with tracing.span("program", trace):
                    counts.append(pipe.search_file(str(sample), str(out)))
                ends.append(time.perf_counter())
                if ends[-1] >= end:
                    break
            if cuda:
                torch.cuda.synchronize(dev)
            window_s = time.perf_counter() - t0
        timeline = None
        if prof is not None:
            prof.__exit__(None, None, None)
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            timeline = tracing.read_trace(path)
            os.unlink(path)
        gc.unfreeze()
        peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
        found = forbidden_modules()
        if found:
            raise RuntimeError("loaded in the measuring process: " + ", ".join(found))
        table_kind, layout = pipe.table_kind, pipe.layout
        del pipe, index
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        output = out.read_bytes()
    t = time.perf_counter()
    from portbench.reference.classify import Reference

    want = Reference(words, ixs, strings, config["taxacut"], dev).lines(
        reads, generate.read_name, traffic["rc"], traffic["support_ranges"])
    checks = compare(output, want)
    short = sum(n != len(reads) for n in [warm, *counts])
    checks["samples_short"] = {"value": short, "limit": 0}
    log(f"reference: {len(want):,} lines in {time.perf_counter() - t:.3f} s")

    ctx = Context(setup_s=setup_s, window_s=window_s, reads=sum(counts),
                  samples=len(counts), setup=dict(db_load_s=db_load_s, table_build_s=table_build_s),
                  work=work_counts(reads, traffic, config, len(words), len(counts)),
                  peaks=spec.peaks(torch.cuda.get_device_name(dev)) if cuda else {},
                  trace=timeline)
    metrics = read_metrics(cell["per_layer"] if trace else cell["end_to_end"], ctx,
                           cell["units"], cuda, log)
    log(f"window: {len(counts)} samples, {sum(counts):,} reads in {window_s:.3f} s; "
        f"table {table_kind}, layout {layout}")
    log("sample seconds: " + " ".join(f"{b - a:.4f}" for a, b in zip([t0, *ends], ends)))
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": sum(counts), "failed": checks["reads_differing"]["value"],
              "metrics": metrics, "device": device_info}
    if timeline is not None:
        self_s = timeline.self_s()
        log(f"harness time in the window: {self_s.get(tracing.HARNESS, 0.0):.6f} s of "
            f"{timeline.window_s:.6f} s")
        device_info.update(busy_s=timeline.busy_s, window_s=timeline.window_s)
        top = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": top(timeline.ops),
                               "idle_gaps": top(timeline.idle_s())}
    for name, c in checks.items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    result["checks"] = checks
    return result
