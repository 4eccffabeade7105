"""Percent of the reads voted that the program replayed exactly on the host
(device-vote flags, histograms over `hist_cap`, long-read chunks over it):
counters `search.replayed` over `search.reads` of the program's process
record (`utree_tpu_torch.utils.trace.process()`), over the whole run.  A
program that keeps no such record, or voted no read, reads 0."""


def read(ctx):
    from utree_tpu_torch.utils import trace

    process = getattr(trace, "process", None)
    counts = process().counts if process else {}
    reads = counts.get("search.reads", 0.0)
    return 100.0 * counts.get("search.replayed", 0.0) / reads if reads else 0.0
