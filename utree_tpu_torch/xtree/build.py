"""XTree database build (xtree.c BUILD mode, lines 258-719) — vectorized.
The port's copy of `utree_tpu/xtree/build.py`.

The reference scans raw FASTA bytes: every line starting with a letter is a
sequence line and becomes its own reference entry (rix), named by the nearest
preceding '>' header (xtree.c:291-292, 437).  Per line it slides a K-mer
(PL=13-base prefix -> bin, SL-base suffix) with a rolling encode; a window is
kept iff all K bases are ACGT and the `comp` RAW BYTES immediately before it
are all 'A'/'a' (xtree.c:312,373 — note the gate reads raw file bytes, so the
first `comp` positions of a line are gated by the preceding newline/header
and always fail).  Kept pods (suffix, rix) are bucketed by prefix and sorted
by (suffix, rix).

This implementation extracts the same pod multiset with NumPy vector ops and
writes the byte-exact .xtr format (xtree.c:410-473, sections 1-18).
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from utree_tpu_torch.encode import encode_bases

INVALID = 255


@dataclasses.dataclass
class XtreeDB:
    pl: int
    sl: int
    rix_bytes: int
    kmer_bytes: int
    num_refs: int
    bin_offsets: np.ndarray  # uint64 [2^(2PL)+1]
    sfx: np.ndarray  # uint32 [numK]
    rix: np.ndarray  # uint32 [numK]
    ref_names: list[bytes]
    h_strings: tuple[list[bytes], list[bytes]]  # unique H1/H2 taxonomy strings
    h_pairs: tuple[np.ndarray, np.ndarray]  # per-ref H1/H2 ids (uint32)

    @property
    def k(self) -> int:
        return self.pl + self.sl

    @property
    def num_kmers(self) -> int:
        return len(self.sfx)


def _scan_lines(data: bytes):
    """Sequence lines exactly as xtree.c:291-292 finds them: byte > 64 ('A'..)
    preceded by '\\n'.  Returns [(line_start, line_end, header_bytes)]."""
    arr = np.frombuffer(data, dtype=np.uint8)
    is_nl = arr == 0x0A
    starts = np.flatnonzero((arr > 64) & np.concatenate(([False], is_nl[:-1])))
    nl_pos = np.flatnonzero(is_nl)
    gt_pos = np.flatnonzero(arr == 0x3E)  # '>'
    out = []
    for s in starts:
        e_i = np.searchsorted(nl_pos, s)
        e = int(nl_pos[e_i]) if e_i < len(nl_pos) else len(arr)
        # name: scan back to the nearest '>' (xtree.c:437): bytes (y+1 .. s-2)
        g_i = np.searchsorted(gt_pos, s) - 1
        y = int(gt_pos[g_i])
        name = data[y + 1 : s - 1]
        out.append((int(s), e, name))
    return out


def _sample_pods(data: bytes, start: int, end: int, k: int, pl: int, comp: int):
    """(prefix, suffix) arrays for one sequence line, matching the reference's
    window set: all-ACGT window + `comp` preceding RAW bytes all 'A'."""
    raw = np.frombuffer(data, dtype=np.uint8)
    codes = encode_bases(raw[start:end])
    n = end - start
    if n < k:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    valid = codes <= 3
    inv_cum = np.concatenate(([0], np.cumsum(~valid).astype(np.int64)))
    xs = np.arange(0, n - k + 1)
    ok = (inv_cum[xs + k] - inv_cum[xs]) == 0
    if comp:
        # gate reads raw FILE bytes before the window (xtree.c:312):
        # CONV[31 & byte] == 0 means 'A'/'a' (also '!'/'1'/'Q'/'q' alias via
        # the 5-bit mask — match the reference exactly)
        conv = np.full(32, 4, dtype=np.uint8)
        conv[1] = 0; conv[3] = 1; conv[7] = 2; conv[20] = 3; conv[21] = 3
        for d in range(1, comp + 1):
            gpos = start + xs - d
            ok &= gpos >= 0
            gb = raw[np.maximum(gpos, 0)]
            ok &= conv[gb & 31] == 0
    xs = xs[ok]
    if len(xs) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    c64 = codes.astype(np.int64)
    pre = np.zeros(len(xs), np.int64)
    for j in range(pl):
        pre = (pre << 2) | c64[xs + j]
    suf = np.zeros(len(xs), np.int64)
    for j in range(pl, k):
        suf = (suf << 2) | c64[xs + j]
    return pre, suf


def build_xtree_db(
    fasta_path: str,
    map_path: str | None = None,
    k: int = 29,
    comp: int = 0,
    pl: int = 13,
) -> XtreeDB:
    sl = k - pl
    if k < pl or sl <= 0 or sl > 16:
        raise ValueError(f"Bad K! [{k}]")
    with open(fasta_path, "rb") as fp:
        data = fp.read()
    if not data.startswith(b">"):
        raise ValueError("Input FASTA looks fishy.")
    lines = _scan_lines(data)
    ns = len(lines)

    pres, sufs, rixs = [], [], []
    for i, (s, e, _name) in enumerate(lines):
        p, q = _sample_pods(data, s, e, k, pl, comp)
        pres.append(p)
        sufs.append(q)
        rixs.append(np.full(len(p), i, np.int64))
    pre = np.concatenate(pres) if pres else np.zeros(0, np.int64)
    suf = np.concatenate(sufs) if sufs else np.zeros(0, np.int64)
    rix = np.concatenate(rixs) if rixs else np.zeros(0, np.int64)

    # bucket by prefix, sort by (prefix, sfx, rix) — one lexsort
    order = np.lexsort((rix, suf, pre))
    pre, suf, rix = pre[order], suf[order], rix[order]
    nbins = 1 << (2 * pl)
    counts = np.bincount(pre, minlength=nbins)
    bin_offsets = np.zeros(nbins + 1, np.uint64)
    bin_offsets[1:] = np.cumsum(counts).astype(np.uint64)

    ref_names = [name for (_s, _e, name) in lines]

    h_strings: tuple[list[bytes], list[bytes]] = ([], [])
    h_pairs = (np.zeros(ns, np.uint32), np.zeros(ns, np.uint32))
    if map_path:
        h_strings, h_pairs = _ingest_map(map_path, ref_names)

    return XtreeDB(
        pl=pl, sl=sl, rix_bytes=4, kmer_bytes=4, num_refs=ns,
        bin_offsets=bin_offsets,
        sfx=suf.astype(np.uint32), rix=rix.astype(np.uint32),
        ref_names=ref_names, h_strings=h_strings, h_pairs=h_pairs,
    )


def write_build_log(db: XtreeDB, path: str) -> None:
    """Per-ref TotalKmers/UniqKmers stats (xtree.c:476-529): a k-mer is
    ambiguous if any pod sharing its (bin, suffix) run has a different rix;
    in-ref duplicate copies all count toward totals."""
    nr = db.num_refs
    tot = np.zeros(nr, np.int64)
    uniq = np.zeros(nr, np.int64)
    bins = db.bin_offsets.astype(np.int64)
    sfx, rix = db.sfx, db.rix
    for b in np.flatnonzero(np.diff(bins)):
        lo, hi = int(bins[b]), int(bins[b + 1])
        j = lo
        while j < hi:
            e = j
            while e < hi and sfx[e] == sfx[j]:
                e += 1
            ambig = len(set(rix[j:e].tolist())) > 1
            jj = j
            while jj < e:
                rr = int(rix[jj])
                nd = 1
                while jj + nd < e and rix[jj + nd] == rr:
                    nd += 1
                if not ambig:
                    uniq[rr] += nd
                tot[rr] += nd
                jj += nd
            j = e
    with open(path, "wb") as fo:
        fo.write(b"Reference\tTotalKmers\tUniqKmers\n")
        for i in range(nr):
            fo.write(db.ref_names[i] + b"\t%d\t%d\n" % (tot[i], uniq[i]))


def _ingest_map(map_path: str, ref_names: list[bytes]):
    """Map ingest (xtree.c:538-718): 2-3 tab columns; unique sorted taxa pools;
    per-ref (h1, h2) ids.  The header is matched against map keys tab-tolerantly
    (binsearch_str_d): the key must equal the header up to the header's first
    tab (headers in practice have no tabs)."""
    with open(map_path, "rb") as fp:
        raw = fp.read()
    ref_col, h1_col, h2_col = [], [], []
    # the reference's ncol drops to 1 permanently on ANY 2-column line
    # (xtree.c:582), disabling H2 even if other lines have 3 columns
    all_three_cols = True
    for line in raw.split(b"\n"):
        if not line:
            continue
        cols = line.split(b"\t")
        if len(cols) < 2:
            raise ValueError("Bad map! Need >1 columns!")
        ref_col.append(cols[0])
        h1_col.append(cols[1])
        if len(cols) > 2:
            h2_col.append(cols[2])
        else:
            h2_col.append(None)
            all_three_cols = False
    uniq_h1 = sorted(set(h1_col))
    uniq_h2 = sorted({h for h in h2_col if h is not None}) if all_three_cols else []
    ref_to_row = {}
    for r, h1, h2 in zip(ref_col, h1_col, h2_col):
        ref_to_row.setdefault(r, (h1, h2))
    h1_id = {s: i for i, s in enumerate(uniq_h1)}
    h2_id = {s: i for i, s in enumerate(uniq_h2)}

    ns = len(ref_names)
    hp0 = np.zeros(ns, np.uint32)
    hp1 = np.zeros(ns, np.uint32)
    # headers match keys up to tab
    key_lookup = {}
    for r in ref_to_row:
        key_lookup[r] = ref_to_row[r]
    for i, name in enumerate(ref_names):
        head_key = name.split(b"\t")[0]
        row = key_lookup.get(name) or key_lookup.get(head_key)
        if row is None:
            raise ValueError(f"Map missing {name!r}")
        h1, h2 = row
        hp0[i] = h1_id[h1]
        hp1[i] = h2_id[h2] if h2 is not None and uniq_h2 else 0
    return (uniq_h1, uniq_h2), (hp0, hp1)


def write_xtr(db: XtreeDB, path: str, version: int = 1) -> None:
    """Byte-exact .xtr writer (file structure comment, xtree.c:410-431)."""
    n = db.num_kmers
    with open(path, "wb") as of:
        of.write(bytes([(version << 4) | db.rix_bytes, db.pl, db.sl, db.kmer_bytes]))
        of.write(struct.pack("<I", db.num_refs))
        of.write(struct.pack("<Q", n))
        of.write(db.bin_offsets.astype("<u8").tobytes())
        rec = np.zeros(n, dtype=[("sfx", "<u4"), ("rix", "<u4")])
        rec["sfx"] = db.sfx
        rec["rix"] = db.rix
        of.write(rec.tobytes())
        pool = b"\x00".join(db.ref_names) + b"\x00" if db.ref_names else b""
        of.write(struct.pack("<Q", len(pool)))
        of.write(pool)
        h1, h2 = db.h_strings
        if not h1:
            of.write(struct.pack("<I", 0))
            return
        p1 = b"\x00".join(h1) + b"\x00"
        of.write(struct.pack("<I", len(h1)))
        of.write(struct.pack("<Q", len(p1)))
        of.write(p1)
        of.write(struct.pack("<I", len(h2)))
        if h2:
            p2 = b"\x00".join(h2) + b"\x00"
            of.write(struct.pack("<Q", len(p2)))
            of.write(p2)
        else:
            of.write(struct.pack("<Q", 0))
        of.write(db.h_pairs[0].astype("<u4").tobytes())
        if h2:
            of.write(db.h_pairs[1].astype("<u4").tobytes())


def read_xtr(path: str) -> XtreeDB:
    """Loader (xtree.c:726-809)."""
    with open(path, "rb") as fp:
        data = fp.read()
    rix_sz = data[0] & 15
    pl, sl, kt_sz = data[1], data[2], data[3]
    num_refs = struct.unpack_from("<I", data, 4)[0]
    num_k = struct.unpack_from("<Q", data, 8)[0]
    place = 16
    nbins = 1 << (2 * pl)
    bin_offsets = np.frombuffer(data, dtype="<u8", count=nbins + 1, offset=place)
    place += (nbins + 1) * 8
    rec = np.frombuffer(data, dtype=[("sfx", "<u4"), ("rix", "<u4")], count=num_k, offset=place)
    place += num_k * 8
    string_sz = struct.unpack_from("<Q", data, place)[0]
    place += 8
    pool = data[place : place + string_sz]
    place += string_sz
    ref_names = pool.split(b"\x00")[:num_refs]
    n_h1 = struct.unpack_from("<I", data, place)[0]
    place += 4
    h1: list[bytes] = []
    h2: list[bytes] = []
    hp0 = np.zeros(num_refs, np.uint32)
    hp1 = np.zeros(num_refs, np.uint32)
    if n_h1:
        sz1 = struct.unpack_from("<Q", data, place)[0]
        place += 8
        h1 = data[place : place + sz1].split(b"\x00")[:n_h1]
        place += sz1
        n_h2 = struct.unpack_from("<I", data, place)[0]
        place += 4
        sz2 = struct.unpack_from("<Q", data, place)[0]
        place += 8
        if n_h2:
            h2 = data[place : place + sz2].split(b"\x00")[:n_h2]
            place += sz2
        hp0 = np.frombuffer(data, dtype="<u4", count=num_refs, offset=place).copy()
        place += num_refs * 4
        if n_h2:
            hp1 = np.frombuffer(data, dtype="<u4", count=num_refs, offset=place).copy()
            place += num_refs * 4
    return XtreeDB(
        pl=pl, sl=sl, rix_bytes=rix_sz, kmer_bytes=kt_sz, num_refs=num_refs,
        bin_offsets=bin_offsets.astype(np.uint64),
        sfx=rec["sfx"].copy(), rix=rec["rix"].copy(),
        ref_names=ref_names, h_strings=(h1, h2), h_pairs=(hp0, hp1),
    )
