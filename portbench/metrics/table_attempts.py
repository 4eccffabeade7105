"""Geometries the table placement tried, the one kept included (counter
`table.attempts`: one for bsearch, one a ladder tier), from the program's
process record (`utree_tpu_torch.utils.trace.process()`).  A program that
keeps no such record reads 0."""


def read(ctx):
    from utree_tpu_torch.utils import trace

    process = getattr(trace, "process", None)
    return process().counts.get("table.attempts", 0.0) if process else 0.0
