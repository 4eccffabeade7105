"""Hand state from the JAX package to the port, so both compute on the same
database and tables (the utree index, the xtree DB, the device tables).  Takes plain host arrays read by attribute, so this
module imports nothing of the JAX package."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from utree_tpu_torch.config import UTreeConfig
from utree_tpu_torch.index import DeviceIndexArrays


def index_from_jax(arrays) -> DeviceIndexArrays:
    """The port's index holding copies of a JAX package `DeviceIndexArrays`'
    NumPy fields and config."""
    cfg = UTreeConfig(**{f.name: getattr(arrays.config, f.name)
                         for f in dataclasses.fields(UTreeConfig)})

    def copy(a):
        return None if a is None else np.array(a, copy=True)

    return DeviceIndexArrays(
        bin_ix=copy(arrays.bin_ix), suf_hi=copy(arrays.suf_hi),
        suf_lo=copy(arrays.suf_lo), ix=copy(arrays.ix),
        strings=list(arrays.strings), semicolons=copy(arrays.semicolons),
        probe_iters=int(arrays.probe_iters), config=cfg,
        s_hi64=copy(arrays.s_hi64), s_lo64=copy(arrays.s_lo64))


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


def xtree_db_from_jax(db):
    """The port's XtreeDB holding copies of a JAX package `XtreeDB`'s
    arrays, names and hierarchies (an `.xtr` written by either reads in
    either)."""
    from utree_tpu_torch.xtree.build import XtreeDB

    def copy(v):
        if isinstance(v, np.ndarray):
            return np.array(v, copy=True)
        if isinstance(v, (list, tuple)):
            return type(v)(copy(x) for x in v)
        return v

    return XtreeDB(**{f.name: copy(getattr(db, f.name))
                      for f in dataclasses.fields(XtreeDB)})
