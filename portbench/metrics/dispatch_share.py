"""Percent of the traced window in phase `dispatch`: the host-to-device copy
and the enqueue of a batch's kernels (`dispatch_packed`, `lookup`)."""


def read(ctx):
    return ctx.share("dispatch")
