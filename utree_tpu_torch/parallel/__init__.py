"""Counterpart of `utree_tpu/parallel/`: the (data, table) grid of shard
devices and its collectives (`mesh`); the replicated, prefix-sharded and
sequence-parallel long-read steps (`sharded`, through K14 `ascii_pack`,
K15 `bsearch_probe_shard` and K16 `label_histogram`); the routed displaced
shards (`routed`, K11-K13); the multi-host search (`distributed`).  The
routed canonical-table steps of utree_tpu/parallel/routed.py:59-279 are
still to port (ROADMAP, queue B row 17c)."""

from utree_tpu_torch.parallel.mesh import ShardMesh, make_mesh
from utree_tpu_torch.parallel.sharded import (
    ShardedIndex,
    long_read_histogram,
    replicated_search_step,
    sharded_search_step,
    split_long_read,
)

__all__ = [
    "ShardMesh",
    "make_mesh",
    "ShardedIndex",
    "replicated_search_step",
    "sharded_search_step",
    "long_read_histogram",
    "split_long_read",
]
