"""Percent of the traced window in phase `pack`: the C++ 2-bit pack of a
batch in `search_file`'s flush."""


def read(ctx):
    return ctx.share("pack")
