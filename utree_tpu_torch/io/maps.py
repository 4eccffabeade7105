"""Taxonomy map reading (the port's copy of `utree_tpu/io/maps.py`).

The reference build reads the whole map, splits key (column ixCol=0) and
label (column lblCol=1) per line, where the label ends at the first '\\t' or
'\\r' after its column (itree.c:506-554).  Blank keys or labels are errors.
"""

from __future__ import annotations


def read_tax_map(path: str) -> dict[bytes, bytes]:
    """Map from sequence name -> taxonomy label (both byte strings)."""
    with open(path, "rb") as fp:
        data = fp.read()
    out: dict[bytes, bytes] = {}
    for lineno, line in enumerate(data.split(b"\n")):
        if not line:
            continue
        cols = line.split(b"\t")
        if len(cols) < 2:
            raise ValueError(f"{path}:{lineno + 1}: expected 2 tab-separated columns")
        key = cols[0]
        # label ends at the first '\t' or '\r' (itree.c:547-551)
        label = cols[1].split(b"\r")[0]
        if not key:
            raise ValueError(f"{path}:{lineno + 1}: blank indices are NOT ALLOWED")
        if not label:
            raise ValueError(f"{path}:{lineno + 1}: blank labels are NOT ALLOWED")
        # The reference resolves duplicate keys through a binary search over a
        # sorted copy (crBST, itree.c:475-489): any duplicate resolves to one
        # of its rows.  First-one-wins matches its behavior for unique keys;
        # duplicated keys with conflicting labels are rejected loudly instead.
        if key in out and out[key] != label:
            raise ValueError(f"{path}:{lineno + 1}: duplicate key {key!r} with conflicting labels")
        out[key] = label
    if not out:
        raise ValueError(f"{path}: input map empty")
    return out
