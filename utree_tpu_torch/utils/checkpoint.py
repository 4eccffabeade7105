"""Search checkpoint / resume (the port's copy of
`utree_tpu/utils/checkpoint.py`).

The reference's only restartability is the DB files themselves (two-stage
build, README.md:30-35); an interrupted search restarts from zero.  Here the
search is deterministically batched, so recovery = resume at the first
unfinished batch:

- a sidecar manifest `<out>.ckpt` records, after each flushed batch, the
  number of reads consumed and the output byte offset;
- on resume, the driver truncates the output to the recorded offset, skips
  the consumed reads, and continues — output bytes are identical to an
  uninterrupted run (batch boundaries are a pure function of read index).

The DB build needs no checkpointing (it is deterministic and the .ubt/.ctr
files are the durable artifacts, same as the reference).
"""

from __future__ import annotations

import json
import os
import pathlib


class SearchCheckpoint:
    # recovery points cost an fsync each; committing at most once per
    # interval keeps the steady-state drain free of synchronous disk waits
    # (resume correctness is unaffected — an older recovery point just
    # replays a little more work)
    min_interval: float = 1.0

    def __init__(self, out_path: str):
        self.path = pathlib.Path(str(out_path) + ".ckpt")
        self.out_path = out_path
        self._last_commit = 0.0

    def load(self) -> tuple[int, int]:
        """(reads_done, output_bytes) from the last committed batch."""
        if not self.path.exists():
            return 0, 0
        with open(self.path) as f:
            d = json.load(f)
        return int(d["reads_done"]), int(d["out_bytes"])

    def commit(self, reads_done: int, out_bytes: int) -> None:
        import time

        now = time.monotonic()
        if now - self._last_commit < self.min_interval:
            return
        self._last_commit = now
        tmp = self.path.with_suffix(".ckpt.tmp")
        with open(tmp, "w") as f:
            json.dump({"reads_done": reads_done, "out_bytes": out_bytes}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def finish(self) -> None:
        if self.path.exists():
            self.path.unlink()
