"""utree_tpu_torch: the PyTorch/CUDA port of utree_tpu for NVIDIA Hopper.

The JAX package `utree_tpu` is the reference.  This package imports torch
and never jax, and nothing of `utree_tpu`: it keeps its own copies of the
host code it needs.

  device path
  lookup           search step: K1 scan_probe, K4 ladder_probe (narrow and
                   wide), K7 bsearch_probe, K5 scan_probe64, K6
                   ladder_probe64, K2 histogram in three layouts, K8
                   hist_compact (+ plain versions)
  classify_device  aufbau vote: K3 aufbau_vote (+ plain version), and the
                   walk's label tables (build_aufbau_tables)
  hash_index       the displaced table (numpy placement) and the
                   canonical ladder (torch, placed on the pipeline's
                   device), and every table -> device tensors
  hash_index64     the 64-mer ladder and displaced table (numpy placement)
  pipeline         SearchPipeline: GG search at PACKSIZE=32 on either table
                   or the bsearch replay, at PACKSIZE=64 on either 64-mer
                   table; narrow or wide labels, device or host vote,
                   support_ranges 1 or 8, long reads; a file (search_file)
                   or a list of reads (dispatch, finalize, classify_batch)
  kernels          nvcc build, ctypes binding, launch counts

  host code (copies of utree_tpu's modules of the same names)
  config, taxonomy, encode, formats, index, io
                   the database: config, label table and fold, .ubt/.ctr
                   writers and readers, the index arrays, FASTA and map
  build, build_stream
                   the database build (in memory, or streamed through
                   spill files) and the streamed compress
  classify         the GG aufbau vote in Python (support_ranges 1 and 8)
  search_host      the exact host search, the port's oracle
  native           the C++ FASTA scanner and vote formatter (csrc/host)
  utils            SearchCheckpoint (resume), PhaseTimer, Tracer
                   (torch.profiler)
  parallel         split_long_read (host chunking of long reads)
  convert          index_from_jax / tables_from_jax (tests hand both
                   packages the same state)
  cli              `python -m utree_tpu_torch.cli build|compress|search ...`
"""

__version__ = "0.1.0"
