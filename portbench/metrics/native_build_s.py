"""Seconds the run spent compiling: spans `build:nvcc` (the CUDA kernels)
and `build:g++` (the host C++ libraries), which open only where no build of
the sources was found, from the program's process record
(`utree_tpu_torch.utils.trace.process()`).  A program that keeps no such
record, or built nothing, reads 0."""


def read(ctx):
    from utree_tpu_torch.utils import trace

    process = getattr(trace, "process", None)
    phases = process().phases if process else {}
    return phases.get("build:nvcc", 0.0) + phases.get("build:g++", 0.0)
