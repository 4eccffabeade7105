"""Label-string helpers of the search (the port's copy of the part of
`utree_tpu/taxonomy.py` that the index needs)."""

from __future__ import annotations


def count_semicolons(label: bytes, delim: int = 0x3B) -> int:
    """Semicolon depth as computed at DB load (EXTRA_ADD_DELIM, itree.c:1188-1199).

    Counts delimiters whose preceding char is not '_'; stops at the first
    delimiter preceded by '_'; if the count reaches 6 after a full walk and
    the final character is not '_', adds one more.
    """
    semis = 0
    n = len(label)
    broke = False
    for i in range(n):
        if label[i] == delim:
            prev = label[i - 1] if i > 0 else 0
            if prev != 0x5F:  # '_'
                semis += 1
            else:
                broke = True
                break
    if not broke and semis == 6 and n > 0 and label[-1] != 0x5F:
        semis += 1
    return semis
