"""Seconds of span `index:bins`, the bin offsets of the index
(`formats.compute_bin_ix` in `DeviceIndexArrays.from_build`), from the
program's process record (`utree_tpu_torch.utils.trace.process()`).  A
program that keeps no such record, or did not open the span, reads 0."""


def read(ctx):
    from utree_tpu_torch.utils import trace

    process = getattr(trace, "process", None)
    return process().phases.get("index:bins", 0.0) if process else 0.0
