"""Linearized-FASTA reading (the port's copy of `utree_tpu/io/fasta.py`).

The reference requires "linearized" FASTA — exactly one header line followed
by exactly one sequence line per record (README.md:48-55; the build reads
strict line pairs, itree.c:585-596; the search errors on '>' in sequence
position, itree.c:886).  We enforce the same shape.
"""

from __future__ import annotations

import gzip
from typing import Iterator


def _open(path: str, mode: str = "rb"):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def iter_fasta_records(path: str) -> Iterator[tuple[bytes, bytes]]:
    """Yield (full_header_without_'>', sequence) byte-string pairs.

    The header is the complete line after '>' with the trailing newline
    removed (build keys on the FULL header, itree.c:586-589; spaces are only
    cut at search time, itree.c:881-882).  Sequence lines have '\\n' and
    '\\r' lopped off exactly like itree.c:598-600.
    """
    with _open(path) as fp:
        while True:
            header = fp.readline()
            if not header:
                return
            if header[:1] != b">":
                raise ValueError(f"{path}: expected '>' header, got {header[:30]!r}")
            seq = fp.readline()
            if not seq:
                raise ValueError(f"{path}: record missing sequence line")
            if seq[:1] == b">":
                raise ValueError(f"{path}: sequence line begins with '>'")
            header = header[1:].rstrip(b"\n").rstrip(b"\r")
            if seq.endswith(b"\n"):
                seq = seq[:-1]
            if seq.endswith(b"\r"):
                seq = seq[:-1]
            yield header, seq


def read_linearized_fasta(path: str) -> list[tuple[bytes, bytes]]:
    return list(iter_fasta_records(path))
