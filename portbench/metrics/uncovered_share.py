"""Percent of the traced window that the program spent inside
`search_file` but outside every phase.  The harness's own time between
samples is not in it (the run prints it on an earlier line)."""

NO_PHASE = "program:no-phase"


def read(ctx):
    return ctx.share(NO_PHASE)
