"""Device tables: counterparts of the JAX package's `device_put` methods.

  displaced_to_device    DisplacedHashArrays.device_put    {d1, ds, d3}
  canonical_to_device    CanonicalHashArrays.device_put    {c1, c2, c3}
  displaced64_to_device  Displaced64Arrays.device_put      {d64_1, d64_s, d64_3}
  canonical64_to_device  CanonicalHash64Arrays.device_put  {c64_1, c64_2, c64_3}
  bsearch_to_device      DeviceIndexArrays.device_put      {bin_ix, suf_hi, suf_lo, ix}

The tables themselves are built by the shared numpy placement code
(`utree_tpu.hash_index`, `utree_tpu.hash_index64`) or are the CTR records of
the index; narrow and wide (4-column slot) rows travel alike."""

from __future__ import annotations

import numpy as np
import torch

from utree_tpu.hash_index import CanonicalHashArrays, DisplacedHashArrays
from utree_tpu.hash_index64 import CanonicalHash64Arrays, Displaced64Arrays
from utree_tpu.index import DeviceIndexArrays


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


def displaced64_to_device(disp: Displaced64Arrays, device) -> dict[str, torch.Tensor]:
    """{"d64_1", "d64_s", "d64_3"} int32 tensors on `device`: d64_1
    (nslots/2, 12), d64_s (nseed/4,) packed u8 seeds, d64_3 (R3, 6*s3)."""
    return _to_device((("d64_1", disp.t1), ("d64_s", disp.seeds),
                       ("d64_3", disp.t3)), device)


def canonical64_to_device(canon: CanonicalHash64Arrays, device) -> dict[str, torch.Tensor]:
    """{"c64_1", "c64_2", "c64_3"} int32 tensors on `device` (6-column
    slots); an 8-row c64_2 or c64_3 is the "absent" sentinel."""
    return _to_device((("c64_1", canon.t1), ("c64_2", canon.t2),
                       ("c64_3", canon.t3)), device)


def bsearch_to_device(index: DeviceIndexArrays, device) -> dict[str, torch.Tensor]:
    """The PACKSIZE=32 CTR records for the bsearch replay: bin_ix (2^24+1,),
    suf_hi, suf_lo, ix (N+1,) with the index's sentinel record, all int32;
    suf_lo (uint32) travels as its int32 bits and is compared unsigned."""
    if index.bin_ix.dtype != np.int32:
        raise ValueError(
            f"the bsearch replay takes int32 bin offsets; this index holds "
            f"{index.num_records:,} records (int64 offsets from 2^31)")
    return _to_device((("bin_ix", index.bin_ix), ("suf_hi", index.suf_hi),
                       ("suf_lo", index.suf_lo.view(np.int32)), ("ix", index.ix)),
                      device)
