"""Percent of the traced window in phase `write`: the output's write and
flush and the checkpoint sidecar (`utils/checkpoint`)."""


def read(ctx):
    return ctx.share("write")
