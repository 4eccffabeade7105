"""The shard devices of a multi-device search: counterpart of
`utree_tpu/parallel/mesh.py`.

One process drives every shard, as `utree_tpu` drives every chip of its
mesh from one controller.  A `ShardMesh` is an ordered list of D*T devices
laid out as a (data, table) grid in row-major order, device d*T + t at
(d, t), as `make_mesh` reshapes JAX's device list.  `SearchPipeline(
devices=S)` builds the (1, S) layout (utree_tpu/pipeline.py:144-148); the
steps of `parallel/sharded.py` and `parallel/routed.py` take any (data,
table) grid.  The collectives are copies between those devices:
`all_to_all` over the `table` axis moves block o of the device at (d, s)
into block s of the device at (d, o); `psum` sums one tensor a device
over the `data` axis, the `table` axis or both, onto every device it sums
over, and `reduce` does the same sums onto the first device of each group
only.  On a card the copies are peer copies, or copies within the card
when shards share it; on the CPU they are memory copies.
"""

from __future__ import annotations

import contextlib

import torch

AXES = ("data", "table")


def _copy_to(table: dict[str, torch.Tensor], dev) -> dict[str, torch.Tensor]:
    out = {k: v.to(dev) for k, v in table.items() if v._base is None}
    for k, v in table.items():
        if v._base is None:
            continue
        base = next((b for b, u in table.items() if u is v._base and u.is_contiguous()),
                    None)
        if base is None or out[base] is table[base]:  # v itself if nothing moved
            out[k] = v.to(dev)
        else:
            out[k] = out[base].as_strided(v.shape, v.stride(),
                                          v.storage_offset() - table[base].storage_offset())
    return {k: out[k] for k in table}


class ShardMesh:
    def __init__(self, devices, shape: tuple[int, int] | None = None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.shape = (1, len(self.devices)) if shape is None else tuple(shape)
        if len(self.shape) != 2 or self.shape[0] * self.shape[1] != len(self.devices):
            raise ValueError(f"mesh {self.shape} != {len(self.devices)} devices")

    @property
    def size(self) -> int:
        return len(self.devices)

    def on(self, s: int):
        """Make shard s's card the current one (a kernel launches on the
        current card's stream); nothing on the CPU."""
        dev = self.devices[s]
        return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()

    def replicate(self, table: dict[str, torch.Tensor]) -> list[dict[str, torch.Tensor]]:
        """One copy of `table` a device (devices that are one device share
        one), for the steps that hold a table whole on every device.  An
        entry that views another (the bsearch records' columns suf_hi,
        suf_lo, ix view `rec`) views that entry's copy."""
        return [_copy_to(table, dev) for dev in self.devices]

    def all_to_all(self, blocks: list[torch.Tensor]) -> list[torch.Tensor]:
        """`jax.lax.all_to_all` over "table" with split and concat axis 0,
        tiled=False: within each data row g of `groups("table")` (of n
        devices), blocks[i] (n, C, ...) -> out[i] (n, C, ...) with
        out[g[o]][s] = blocks[g[s]][o], so block o of the device at (d, s)
        goes to block s of the device at (d, o).  Each block is one `copy_`
        into a tensor allocated on the receiver's device."""
        if len(blocks) != self.size:
            raise ValueError(f"all_to_all takes {self.size} tensors, got {len(blocks)}")
        out = [None] * self.size
        for group in self.groups("table"):
            n = len(group)
            if any(blocks[i].shape[0] != n for i in group):
                raise ValueError(f"all_to_all takes tensors of {n} blocks")
            for i in group:
                out[i] = torch.empty_like(blocks[i], device=self.devices[i])
            for s, src in enumerate(group):
                for o, dst in enumerate(group):
                    out[dst][s].copy_(blocks[src][o], non_blocking=True)
        return out

    def groups(self, axis=AXES) -> list[list[int]]:
        """The device indices that one sum over `axis` ("data", "table" or
        both) runs over, a group each, in mesh order."""
        names = {axis} if isinstance(axis, str) else set(axis)
        if not names or not names <= set(AXES):
            raise ValueError(f"axis {axis!r} is not one of {AXES} or both")
        d, t = self.shape
        if names == set(AXES):
            return [list(range(d * t))]
        if names == {"table"}:
            return [[i * t + j for j in range(t)] for i in range(d)]
        return [[i * t + j for i in range(d)] for j in range(t)]

    def reduce(self, parts: list[torch.Tensor], axis=AXES) -> list[torch.Tensor]:
        """The sums over `axis` of one tensor a device: one tensor a group,
        on the group's first device.  Integer sums, so the order of the
        adds does not matter."""
        if len(parts) != self.size:
            raise ValueError(f"{len(parts)} tensors on a mesh of {self.size}")
        sums = []
        for group in self.groups(axis):
            total = parts[group[0]].clone()
            for i in group[1:]:
                total += parts[i].to(total.device, non_blocking=True)
            sums.append(total)
        return sums

    def psum(self, parts: list[torch.Tensor], axis=AXES) -> list[torch.Tensor]:
        """`jax.lax.psum` over `axis`: on every device, the sum of its
        group's tensors."""
        out = [None] * self.size
        for group, total in zip(self.groups(axis), self.reduce(parts, axis)):
            for i in group:
                out[i] = total.to(self.devices[i], non_blocking=True)
        return out


def make_mesh(data: int | None = None, table: int = 1, devices=None) -> ShardMesh:
    """`make_mesh` (utree_tpu/parallel/mesh.py:21-28): the devices (every
    card by default) as a (data, table) grid; `data` defaults to what
    `table` leaves, and data * table must be the device count."""
    devs = list(devices) if devices is not None else [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    total = len(devs)
    if data is None:
        data = total // table
    if data * table != total:
        raise ValueError(f"mesh {data}x{table} != {total} devices")
    return ShardMesh(devs, (data, table))
