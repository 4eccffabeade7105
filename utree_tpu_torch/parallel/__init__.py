"""Counterpart of `utree_tpu/parallel/`.  Only the host-side long-read
chunking (`sharded.split_long_read`) is ported so far; the multi-GPU paths
are ROADMAP A.9."""
