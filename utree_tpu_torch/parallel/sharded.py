"""Host-side position sharding of a long read: the counterpart of
`utree_tpu.parallel.sharded.split_long_read`, which lives in a module that
imports jax.  Plain numpy; the port's long-read path
(`pipeline.SearchPipeline.classify_long_read`) cuts reads with it."""

from __future__ import annotations

import numpy as np


def split_long_read(seq: bytes, num_chunks: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Cut one read into overlapping chunks.

    Chunk d covers window starts [d*C, (d+1)*C) so it needs bases
    [d*C, (d+1)*C + k - 1).  Returns (chunks (D, C+k-1) uint8, lens (D,))."""
    n = len(seq)
    w = max(0, n - k + 1)
    c = -(-max(w, 1) // num_chunks)
    width = c + k - 1
    chunks = np.zeros((num_chunks, width), dtype=np.uint8)
    lens = np.zeros(num_chunks, dtype=np.int32)
    arr = np.frombuffer(seq, dtype=np.uint8)
    for d in range(num_chunks):
        a = d * c
        b = min(n, a + width)
        if a < n:
            chunks[d, : b - a] = arr[a:b]
            lens[d] = b - a
    return chunks, lens
