"""Percent of the traced window in which no kernel, copy or memset ran on
the card (torch.profiler's device activity)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
