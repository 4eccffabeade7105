"""Percent of the traced window in phase `batch`: `search_file`'s walk over
each piece's records (`seq_lengths`, the skip and range checks, the
per-record loop that ends each batch) and the flush around the C++ `pack`,
which is its own phase.  A program without the phase reads 0."""


def read(ctx):
    return ctx.share("batch")
