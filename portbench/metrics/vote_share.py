"""Percent of the traced window in the drain: phase `drain+vote` with the
phases inside it (`drain:d2h-wait`, `drain:unpack`, `drain:vote`): the wait
for a batch's rows, the host replay of flagged reads and the vote and
format (the C vote, or `_vote_py` at support 8)."""


def read(ctx):
    return ctx.share("drain+vote", "drain:d2h-wait", "drain:unpack", "drain:vote")
