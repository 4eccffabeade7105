"""Taxonomy label table and the rank-flexible conflict fold (the port's copy
of `utree_tpu/taxonomy.py`).

The reference keeps taxonomy strings in a BST mapping string -> dense id in
first-insertion order (ADDSAMP/addSampleU/addSampleUd, itree.c:179-239).  A
Python dict preserves insertion order, which is exactly that semantic.

The fold (xeTreeU_RF, itree.c:268-307) is the heart of the rank-flexible
("GG") build: when one k-mer is seen with two different labels, the node's
label erodes to the text before the LAST semicolon shared by both strings
(including their terminators: the source of the one-extra-rank "erosion
quirk" when one label is a proper prefix of the other); if fewer than
`critical_cutoff` semicolons are shared, the k-mer is poisoned (BAD) forever.
"""

from __future__ import annotations

BAD = -1  # sentinel for a poisoned node (BAD_IX, itree.c:105)


class LabelTable:
    """Dense string->id table with first-insertion-order ids."""

    def __init__(self):
        self._ids: dict[bytes, int] = {}
        self.strings: list[bytes] = []

    def __len__(self) -> int:
        return len(self.strings)

    def get_or_add(self, s: bytes) -> int:
        ix = self._ids.get(s)
        if ix is None:
            ix = len(self.strings)
            self._ids[s] = ix
            self.strings.append(s)
        return ix

    def get(self, s: bytes) -> int | None:
        return self._ids.get(s)


def fold_labels(old: bytes, new: bytes, critical_cutoff: int) -> bytes | None:
    """One conflict fold step on label STRINGS (xeTreeU_RF, itree.c:285-304).

    Returns the truncated replacement string, or None if the node goes BAD.
    Walks the two C strings (terminator included) while equal, counting ';'
    inside the equal region and remembering the offset of the last one.  A
    boundary where one string ends ('\\0') against the other's ';' is NOT
    counted: that asymmetry produces the reference's erosion quirk.
    """
    num_p = 0
    ix_p = 0
    oldt = old + b"\x00"
    newt = new + b"\x00"
    i = 0
    # C loop: while (*old == *new) { if (*old==';') ++numP, ixP=off; ++old,++new; }
    # Strings in the table are unique, so the walk always terminates at a
    # mismatch before both terminators.
    while oldt[i] == newt[i]:
        if oldt[i] == 0x3B:  # ';'
            num_p += 1
            ix_p = i
        i += 1
    if num_p < critical_cutoff:
        return None
    return old[:ix_p]


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
