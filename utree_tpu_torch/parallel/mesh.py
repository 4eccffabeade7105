"""The shard devices of a multi-device search: counterpart of
`utree_tpu/parallel/mesh.py`.

One process drives every shard, as `utree_tpu` drives every chip of its
mesh from one controller.  A `ShardMesh` holds the (1, S) layout that
`SearchPipeline(devices=S)` builds (utree_tpu/pipeline.py:144-148): an
ordered list of S devices, each holding one shard.  The collectives are
copies between those devices: `all_to_all` moves block o of shard s's
tensor into block s of shard o's, and `psum` sums one tensor a shard onto
every shard (`reduce` onto shard 0 only).  On a card the copies are peer
copies, or copies within the card when shards share it; on the CPU they
are memory copies.  The (data > 1, table) meshes
that only `utree_tpu`'s tests build are not held here (ROADMAP A.9.5).
"""

from __future__ import annotations

import contextlib

import torch


class ShardMesh:
    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def on(self, s: int):
        """Make shard s's card the current one (a kernel launches on the
        current card's stream); nothing on the CPU."""
        dev = self.devices[s]
        return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()

    def all_to_all(self, blocks: list[torch.Tensor]) -> list[torch.Tensor]:
        """blocks[s] (S, C, ...) on shard s -> out[o] (S, C, ...) on shard o
        with out[o][s] = blocks[s][o] (`jax.lax.all_to_all` with split and
        concat axis 0, tiled=False), each block one `copy_` into a tensor
        allocated on o's device."""
        n = self.size
        if len(blocks) != n or any(b.shape[0] != n for b in blocks):
            raise ValueError(f"all_to_all takes {n} tensors of {n} blocks")
        out = [torch.empty_like(blocks[0], device=dev) for dev in self.devices]
        for s, src in enumerate(blocks):
            for o in range(n):
                out[o][s].copy_(src[o], non_blocking=True)
        return out

    def reduce(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The sum of one tensor a shard, on shard 0.  Integer sums, so the
        order of the adds does not matter."""
        total = parts[0].clone()
        for p in parts[1:]:
            total += p.to(total.device, non_blocking=True)
        return total

    def psum(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        """The sum of one tensor a shard (`jax.lax.psum`), on every shard."""
        total = self.reduce(parts)
        return [total.to(dev, non_blocking=True) for dev in self.devices]
