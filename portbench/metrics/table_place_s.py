"""Seconds of span `table:place`, the host placement of the device table
inside `SearchPipeline(...)` (the ladder's hits, groups and geometry tiers;
the bsearch records), from the program's process record
(`utree_tpu_torch.utils.trace.process()`).  A program that keeps no such
record, or did not open the span, reads 0."""


def read(ctx):
    from utree_tpu_torch.utils import trace

    process = getattr(trace, "process", None)
    return process().phases.get("table:place", 0.0) if process else 0.0
