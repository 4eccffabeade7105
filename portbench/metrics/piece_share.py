"""Percent of the traced window in phase `piece`: `_iter_fasta_pieces`'
join of the last piece's tail to the next chunk read, its search for the
last record boundary and the two slices.  A program without the phase
reads 0."""


def read(ctx):
    return ctx.share("piece")
