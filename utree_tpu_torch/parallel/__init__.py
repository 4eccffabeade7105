"""Counterpart of `utree_tpu/parallel/`: the shard devices of a
multi-device search (`mesh`), the routed displaced shards (`routed`), the
multi-host driver (`distributed`) and the host-side long-read chunking
(`sharded.split_long_read`).  The prefix-sharded bsearch steps and the
routed canonical table are ROADMAP A.9.5."""
