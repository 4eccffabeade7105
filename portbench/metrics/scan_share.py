"""Percent of the traced window in phase `scan`: the file read and the C++
FASTA scan (`native.FastaScanner`, csrc/host/fasta.cpp)."""


def read(ctx):
    return ctx.share("scan")
