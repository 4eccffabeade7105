"""Hand state from the JAX package to the port, so both compute on the same
tables.  Takes plain host arrays, so this module imports no JAX itself."""

from __future__ import annotations

import numpy as np
import torch


def tables_from_jax(table: dict) -> dict[str, torch.Tensor]:
    """The JAX pipeline's `_table` pytree (d1/ds/d3 or c1/c2/c3, and the
    `vt_*` vote tables where it votes on the device) -> CPU tensors under the
    same keys.  Each value goes through
    `np.asarray`; u32 arrays (the vote bitmasks) travel as their int32 bits."""
    out = {}
    for k, v in table.items():
        a = np.asarray(v)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[k] = torch.from_numpy(np.array(a, copy=True))
    return out
