"""Seconds of span `table:copy`, the device table's and the vote tables'
copy to the card inside `SearchPipeline(...)`, up to a synchronise, from the
program's process record (`utree_tpu_torch.utils.trace.process()`).  A
program that keeps no such record, or did not open the span, reads 0."""


def read(ctx):
    from utree_tpu_torch.utils import trace

    process = getattr(trace, "process", None)
    return process().phases.get("table:copy", 0.0) if process else 0.0
