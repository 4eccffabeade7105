"""Per-read classification on the host: the "optimal aufbau"
interpolated-taxonomy vote (the port's copy of the GG vote in
`utree_tpu/classify.py`).

Host-exact replay of the reference searchGG vote (itree.c:1028-1098): the
walk is string logic with quirky boundary rules (blank-rank '_' promotion,
prefix promotion, cutoff re-bumps), so this module mirrors the C statement
for statement.  It votes the reads that the device does not (support_ranges
8, over-cap replays on that path, long reads) and is the oracle of the
device walk (`classify_device.aufbau_walk`).  `ShallowVoter` is the
rank-specific (non-GG) search's majority vote (itree.c:969-1006).
"""

from __future__ import annotations

import numpy as np

U32 = 0xFFFFFFFF


def _u32(x: int) -> int:
    return x & U32


def aufbau_vote(
    name: bytes,
    hit_ixs: list[int] | np.ndarray,
    strings: list[bytes],
    taxacut: int = 4,
    support_ranges: int = 1,
) -> bytes | None:
    """One read's output line (without trailing newline), or None if no hits.

    `hit_ixs` is the multiset of hit label ids in any order (the reference's
    result depends only on the multiset: Tax_Cnt is re-sorted by label string
    before the walk, itree.c:1041).  `name` is the query name already cut at
    the first space (itree.c:881-882).
    """
    if len(hit_ixs) == 0:
        return None
    counts = np.bincount(np.asarray(hit_ixs, dtype=np.int64))
    nz = np.flatnonzero(counts)
    return aufbau_vote_counts(name, nz, counts[nz], strings, taxacut, support_ranges)


def aufbau_vote_counts(
    name: bytes,
    uniq_ixs: np.ndarray,
    counts: np.ndarray,
    strings: list[bytes],
    taxacut: int = 4,
    support_ranges: int = 1,
) -> bytes | None:
    """aufbau_vote from a precomputed per-read histogram (device pipeline path).

    support_ranges=1 matches the reference BINARY (one SUPPORT;RANGE pair,
    itree.c:1096).  support_ranges=8 is the variant the reference READMEs
    document (README.md:21-22) but whose code survives only commented out
    (`sl[INT16_MAX+1], ol[8]`, itree.c:1045,1097): per-level pairs for ranks
    0..7, zero for levels the walk never reached."""
    if len(uniq_ixs) == 0:
        return None
    found_uniq = int(np.sum(counts))
    if found_uniq == 1:
        return name + b"\t" + strings[int(uniq_ixs[0])] + b"\t1\t1\t*"
    if len(uniq_ixs) == 1:
        return name + b"\t" + strings[int(uniq_ixs[0])] + b"\t" + str(found_uniq).encode() + b"\t1\t*"
    # Tax_Cnt sorted by label string (byStr/qsort, itree.c:1041)
    tax_cnt = sorted(((strings[int(i)], int(c)) for i, c in zip(uniq_ixs, counts)), key=lambda t: t[0])
    uix = len(tax_cnt)
    toprint, sl, ol, levels = _aufbau_walk(tax_cnt, found_uniq, taxacut)
    line = (
        name + b"\t" + toprint + b"\t" + str(found_uniq).encode() + b"\t"
        + str(uix).encode() + b"\t" + str(sl).encode() + b";" + str(ol).encode()
    )
    if support_ranges == 8:
        for s, o in levels[1:8]:
            line += b"\t" + str(s).encode() + b";" + str(o).encode()
    return line


def _cstr(s: bytes, i: int) -> int:
    """C-string byte access with terminator semantics: s[len] == 0."""
    return s[i] if i < len(s) else 0


def _aufbau_walk(tax_cnt: list[tuple[bytes, int]], found_uniq: int, taxacut: int):
    """The level-descent loop, itree.c:1044-1096.  All counters are uint32 in
    the reference; dv uses the wrapped values -1 -> 0xFFFFFFFF, -2 -> 0xFFFFFFFE.
    Returns (toPrint, sl, ol, levels) where levels[i] = the (sl, ol) pair
    recorded at rank depth i (the commented-out per-level arrays,
    itree.c:1045,1083,1097; index clamped to 7)."""
    dv_m1 = U32  # (uint32_t)-1
    dv_m2 = U32 - 1  # (uint32_t)-2
    uix = len(tax_cnt)
    cutoff = found_uniq - found_uniq // taxacut
    cutoff += 1 if (found_uniq >> 1) >= cutoff else 0
    lv = 0
    st, ed = 0, uix
    dv = dv_m1
    orun = found_uniq
    sl = ol = 0
    levels = [(0, 0)] * 8
    while True:
        run = tax_cnt[st][1]
        td = dv
        for z in range(st + 1, ed):
            s1, _ = tax_cnt[z - 1]
            s2, _ = tax_cnt[z]
            # s1[dv + (dv==-1)] with uint32 wraparound: index 0 when dv==-1
            probe = 0 if dv == dv_m1 else dv
            if _cstr(s1, probe) == 0:
                # non-aufbau: prior entry exhausted at this depth — drop it
                run = tax_cnt[z][1]
                st = z
                orun = _u32(orun - tax_cnt[z - 1][1])
                cutoff = orun - orun // taxacut
                cutoff += 1 if (orun >> 1) >= cutoff else 0
                continue
            td = _u32(dv + 1)
            while _cstr(s1, td) and _cstr(s1, td) == _cstr(s2, td):
                if _cstr(s1, td) == 0x3B:  # ';'
                    break
                td += 1
            if _cstr(s1, td) == _cstr(s2, td):
                run += tax_cnt[z][1]
            elif (_cstr(s1, td) == 0 and _cstr(s2, td) == 0x3B) or (
                (_cstr(s1, td) == 0x3B or _cstr(s1, td) == 0)
                and td >= 1
                and _cstr(s1, td - 1) == 0x5F  # '_'
            ):
                # aufbau promotion: s1 is a rank-prefix or blank-rank entry
                run = tax_cnt[z][1]
                st = z
                orun = _u32(orun - tax_cnt[z - 1][1])
                cutoff = orun - orun // taxacut
                cutoff += 1 if (orun >> 1) >= cutoff else 0
            elif run >= cutoff:
                ed = z
                break
            else:
                run = tax_cnt[z][1]
                st = z
        sl, ol = run, orun
        levels[min(lv, 7)] = (run, orun)
        if run < cutoff:
            break
        if st + 1 >= ed:
            if tax_cnt[ed - 1][1] >= cutoff:
                dv = dv_m2
            break
        if _cstr(tax_cnt[ed - 1][0], td) == 0 or _cstr(tax_cnt[ed - 1][0], td) == 0x3B:
            lv += 1
            sl, ol = run, orun
            levels[min(lv, 7)] = (run, orun)
        orun = run
        dv = td
        cutoff = run - run // taxacut
        cutoff += 1 if (run >> 1) >= cutoff else 0

    if dv == dv_m1:
        toprint = b""
    elif dv == dv_m2:
        toprint = tax_cnt[ed - 1][0]
    else:
        toprint = tax_cnt[ed - 1][0][:dv]
    return toprint, sl, ol, levels


class ShallowVoter:
    """Rank-specific (non-GG) vote, itree.c:969-1006 — stateful, because the
    reference has a read-one-past bug we must reproduce: `if (!kingsMen++)`
    (itree.c:982) post-increments before the tally loops run with the
    incremented count, so the vote always includes ONE phantom entry —
    AllTheKingsHorses[kingsMen], which holds the previous read's hit at that
    slot (or 0 from the calloc-like fresh mmap pages of the 64MB malloc,
    itree.c:970).  Single-threaded this is fully deterministic; we keep the
    same persistent buffer."""

    def __init__(self, strings: list[bytes], tolerance: int = 2, slack: int = 2):
        self.strings = strings
        self.tolerance = tolerance
        self.slack = slack
        self.buffer: list[int] = []  # persistent AllTheKingsHorses; absent slots read 0

    def _slot(self, i: int) -> int:
        return self.buffer[i] if i < len(self.buffer) else 0

    def vote(self, name: bytes, hit_ixs: list[int]) -> bytes | None:
        """`hit_ixs`: SPARSITY-subsampled hits in scan order (itree.c:948-951)."""
        if not hit_ixs:
            return None
        # write this read's hits over the persistent buffer
        for i, ix in enumerate(hit_ixs):
            if i < len(self.buffer):
                self.buffer[i] = int(ix)
            else:
                self.buffer.append(int(ix))
        kings_men = len(hit_ixs) + 1  # the post-increment bug
        entries = [self._slot(i) for i in range(kings_men)]
        hashes: dict[int, int] = {}
        for ix in entries:
            hashes[ix] = hashes.get(ix, 0) + 1
        most = second = 0
        most_ix = None
        for ix in entries:
            c = hashes.get(ix, 0)
            if c > most:
                second = most
                most_ix = ix
                most = c
            elif c > second:
                second = c
            hashes[ix] = 0  # Hashes zeroed as read (itree.c:996)
        if most < self.tolerance or most < self.slack * second:
            return None
        conf = 1.0 - second / most
        return (
            name + b"\t" + self.strings[most_ix] + b"\t" + (b"%f" % conf)
            + b"\t" + str(most).encode()
        )


def subsample_hits(starts: np.ndarray, ixs: np.ndarray, max_ix: int, packsize: int, sparsity: int):
    """Apply the shallow scan's skip-after-hit rule (XT_SHALLOWVOTE,
    itree.c:948-951): after a hit at window start s, the next
    packsize/sparsity - 1 windows are not even looked up.

    `starts`/`ixs`: positions and lookup results of all VALID windows in scan
    order.  Returns the recorded hit ids in order."""
    step = packsize // sparsity
    out = []
    next_allowed = 0
    for s, ix in zip(starts, ixs):
        if s < next_allowed:
            continue
        if ix < max_ix:
            out.append(int(ix))
            next_allowed = int(s) + step
    return out
