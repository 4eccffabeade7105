"""XTree query reader (get_queries, xtree.c:180-204); the port's copy of
`utree_tpu/xtree/io.py`.

FASTA and FASTQ, optionally gzipped, '-' for stdin.  The query name is the
FULL header line minus its first character ('>' or '@') and trailing newline —
xtree does NOT cut at the first space (unlike utree search, itree.c:881).
FASTQ skips the '+' and quality lines.
"""

from __future__ import annotations

import gzip
import sys
from typing import Iterator


def _open(path: str):
    if path == "-":
        return sys.stdin.buffer
    if str(path).endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def iter_queries(path: str) -> Iterator[tuple[bytes, bytes]]:
    fp = _open(path)
    try:
        while True:
            head = fp.readline()
            if not head:
                return
            head = head.rstrip(b"\n")
            seq = fp.readline()
            if not seq:
                return
            seq = seq.rstrip(b"\n")
            if head[:1] == b"@":  # FASTQ: skip '+' and quality lines
                if not fp.readline() or not fp.readline():
                    return
            yield head[1:], seq
    finally:
        if fp is not sys.stdin.buffer:
            fp.close()
