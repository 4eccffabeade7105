"""utree_tpu_torch: the PyTorch/CUDA port of utree_tpu for NVIDIA Hopper.

The JAX package `utree_tpu` is the reference.  This package imports torch
and never jax; it shares utree_tpu's backend-neutral host modules (config,
index, the numpy table builders, the C++ scanner and vote formatter,
checkpoints, PhaseTimer) and ports the device code:

  lookup           search step: K1 scan_probe, K4 ladder_probe (narrow and
                   wide), K2 histogram in three layouts (+ plain versions)
  classify_device  aufbau vote: K3 aufbau_vote (+ plain version)
  hash_index       displaced table and canonical ladder -> device tensors
  pipeline         SearchPipeline (GG search on either table, narrow or wide
                   labels, device or host vote, long reads)
  parallel         split_long_read (host chunking of long reads)
  cli              `python -m utree_tpu_torch.cli search ...`
  kernels          nvcc build, ctypes binding, launch counts
"""

__version__ = "0.1.0"
