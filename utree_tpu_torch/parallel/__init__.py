"""Counterpart of `utree_tpu/parallel/`: the (data, table) grid of shard
devices and its collectives (`mesh`); the replicated, prefix-sharded and
sequence-parallel long-read steps (`sharded`, through K14 `ascii_pack`,
K15 `bsearch_probe_shard` and K16 `label_histogram`); the routed shards of
the displaced table (K11-K13) and of the canonical hash table (K11, K17,
K18), with their broadcast fallbacks (`routed`); the multi-host search
(`distributed`)."""

from utree_tpu_torch.parallel.mesh import ShardMesh, make_mesh
from utree_tpu_torch.parallel.routed import (
    ShardedCanonicalIndex,
    ShardedDisplacedIndex,
    routed_canonical_search_step,
    routed_displaced_fallback_step,
    routed_displaced_search_step,
    routed_fallback_step,
)
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
    "ShardedCanonicalIndex",
    "routed_canonical_search_step",
    "routed_fallback_step",
    "ShardedDisplacedIndex",
    "routed_displaced_search_step",
    "routed_displaced_fallback_step",
]
