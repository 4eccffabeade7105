"""Process start to the first timed sample (host clock): the inputs, the
DB, the table, the sample file and one whole untimed pass of the sample."""


def read(ctx):
    return ctx.setup_s
