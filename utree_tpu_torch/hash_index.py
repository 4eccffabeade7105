"""Canonical-key tables on a device: counterparts of
`utree_tpu.hash_index.DisplacedHashArrays.device_put` and
`CanonicalHashArrays.device_put`.  The tables themselves are built by the
shared numpy placement code, `build_displaced_index` and
`build_canonical_hash_index`; narrow and wide (4-column slot) rows travel
alike."""

from __future__ import annotations

import numpy as np
import torch

from utree_tpu.hash_index import CanonicalHashArrays, DisplacedHashArrays


def _to_device(pairs, device) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
            for k, a in pairs}


def displaced_to_device(disp: DisplacedHashArrays, device) -> dict[str, torch.Tensor]:
    """{"d1", "ds", "d3"} int32 tensors on `device` (the JAX pytree's keys):
    d1 (nslots/2, 6 or 8), ds (nseed/4,), d3 (R3, 3*s3 or 4*s3)."""
    return _to_device((("d1", disp.t1), ("ds", disp.seeds), ("d3", disp.t3)), device)


def canonical_to_device(canon: CanonicalHashArrays, device) -> dict[str, torch.Tensor]:
    """{"c1", "c2", "c3"} int32 tensors on `device` (the JAX pytree's keys);
    an 8-row c2 or c3 is the placement's "absent" sentinel."""
    return _to_device((("c1", canon.t1), ("c2", canon.t2), ("c3", canon.t3)), device)
