"""utree_tpu_torch: the PyTorch/CUDA port of utree_tpu for NVIDIA Hopper.

The JAX package `utree_tpu` is the reference.  This package imports torch
and never jax; it shares utree_tpu's backend-neutral host modules (config,
index, the numpy table builders, the C++ scanner and vote formatter,
checkpoints, PhaseTimer) and ports the device code:

  lookup           search step: K1 scan_probe, K4 ladder_probe (narrow and
                   wide), K7 bsearch_probe, K5 scan_probe64, K6
                   ladder_probe64, K2 histogram in three layouts (+ plain
                   versions)
  classify_device  aufbau vote: K3 aufbau_vote (+ plain version)
  hash_index       displaced tables, canonical ladders (32- and 64-mer) and
                   the CTR records -> device tensors
  pipeline         SearchPipeline (GG search at PACKSIZE=32 on either table
                   or the bsearch replay, at PACKSIZE=64 on either 64-mer
                   table; narrow or wide labels, device or host vote, long
                   reads)
  parallel         split_long_read (host chunking of long reads)
  cli              `python -m utree_tpu_torch.cli search ...`
  kernels          nvcc build, ctypes binding, launch counts
"""

__version__ = "0.1.0"
