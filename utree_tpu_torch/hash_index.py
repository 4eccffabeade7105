"""Displaced table on a device: counterpart of
`utree_tpu.hash_index.DisplacedHashArrays.device_put`.  The table itself is
built by the shared numpy builder `utree_tpu.hash_index.build_displaced_index`."""

from __future__ import annotations

import numpy as np
import torch

from utree_tpu.hash_index import DisplacedHashArrays


def displaced_to_device(disp: DisplacedHashArrays, device) -> dict[str, torch.Tensor]:
    """{"d1", "ds", "d3"} int32 tensors on `device` (the JAX pytree's keys)."""
    return {k: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
            for k, a in (("d1", disp.t1), ("ds", disp.seeds), ("d3", disp.t3))}
