"""Multi-host search: counterpart of `utree_tpu/parallel/distributed.py`.

One process per host, joined in a `torch.distributed` process group over
gloo (`init_distributed`).  Each process searches the contiguous range of
records `host_read_range` gives it through its own `SearchPipeline` into
`<out>.part<rank>`; rank 0 concatenates the parts after the collective
that merges the tallies, so the merged bytes equal a one-host run's.  The
tally is host data, so gloo carries it on any device, and two processes
may share one card.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch


def _dist():
    """torch.distributed when a process group is up, else None."""
    d = torch.distributed
    return d if d.is_available() and d.is_initialized() else None


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Join the gloo process group at tcp://<coordinator> as rank
    `process_id` of `num_processes`.  A no-op with no coordinator and no
    process count, as `jax.distributed` setup is."""
    if coordinator is None and num_processes is None:
        return
    torch.distributed.init_process_group(
        "gloo", init_method="tcp://" + coordinator, world_size=num_processes,
        rank=process_id)


def host_read_range(total_reads: int, process_index: int | None = None,
                    process_count: int | None = None) -> tuple[int, int]:
    """Deterministic per-host slice of the read set: host h takes the
    contiguous range [h*ceil(N/H), ...), so the global read order (and the
    merged output's) does not depend on the host count.  The host and the
    count default to the process group's rank and world size (0 and 1
    without one)."""
    d = _dist()
    h = process_index if process_index is not None else (d.get_rank() if d else 0)
    nh = process_count if process_count is not None else (d.get_world_size() if d else 1)
    per = -(-total_reads // nh)
    lo = min(h * per, total_reads)
    return lo, min(lo + per, total_reads)


def merge_sample_tallies(local_tally: np.ndarray) -> np.ndarray:
    """Sum each host's tally over the process group (an `all_reduce` of an
    int64 CPU tensor: exact and order-independent); the tally itself
    without a process group.  utree_tpu's psum runs over a mesh of devices
    and weights one device a process so that a host's tally counts once
    (utree_tpu/parallel/distributed.py:51-60); here one process is one rank,
    so no weighting is needed."""
    t = torch.from_numpy(np.array(local_tally, np.int64))
    d = _dist()
    if d is not None:
        d.all_reduce(t)
    return t.numpy()


def count_fasta_records(path: str, chunk_bytes: int = 64 << 20) -> int:
    """Record count of a linearized FASTA, streamed (every host needs the
    total to compute its slice)."""
    n = 0
    first = True
    prev_nl = False  # did the previous chunk end with '\n'?
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_bytes)
            if not chunk:
                return n
            if first:
                first = False
                if chunk.startswith(b">"):
                    n += 1
            elif prev_nl and chunk.startswith(b">"):
                # '\n>' straddling the chunk boundary
                n += 1
            n += chunk.count(b"\n>")
            prev_nl = chunk.endswith(b"\n")


def search_file_multihost(pipe, reads_path: str, out_path: str, *,
                          resume: bool = False) -> int:
    """The multi-host driver (utree_tpu/parallel/distributed.py:95-142):
    this process searches its `host_read_range` of the file's records into
    `<out>.part<rank>`, the (reads, classified) tallies merge over the
    process group, and rank 0 concatenates the parts in rank order.  Needs
    a filesystem that every host shares and a plain FASTA (the ranges seek
    by record).  Returns the number of records this host searched."""
    total = count_fasta_records(reads_path)
    d = _dist()
    h = d.get_rank() if d else 0
    nh = d.get_world_size() if d else 1
    lo, hi = host_read_range(total)
    part = f"{out_path}.part{h}"
    n = pipe.search_file(reads_path, part, resume=resume, record_range=(lo, hi))

    # lines written (classified reads), for the merged tally
    lines = 0
    with open(part, "rb") as f:
        for _ in f:
            lines += 1

    merged = merge_sample_tallies(np.array([n, lines], np.int64))

    # the collective above is also the barrier: every host has written and
    # closed its part before any host reaches this point
    if h == 0:
        with open(out_path, "wb") as fo:
            for i in range(nh):
                pp = pathlib.Path(f"{out_path}.part{i}")
                fo.write(pp.read_bytes())
                pp.unlink()
        print(f"multihost: {int(merged[0])} reads searched, "
              f"{int(merged[1])} classified across {nh} hosts")
    return n
