"""Reads classified in the window over the window's whole wall time, up to
the end of the last sample (host clock).  Never a median of samples."""


def read(ctx):
    return ctx.reads / ctx.window_s
