"""The GG vote of the reference search, one read at a time: a straight
Python replay of itree.c:1028-1098 (aufbau walk, blank-rank and prefix
promotion, cutoff re-bumps).  `support_ranges=8` adds the per-rank
SUPPORT;RANGE pairs that the reference READMEs document (README.md:21-22).

Provenance: `aufbau_vote_counts` and `_aufbau_walk` are frozen, unchanged,
from the JAX package's `utree_tpu/classify.py` at commit 0dc72e8, the
replay that its oracle tests held to the compiled itree.c.  The port's
`utree_tpu_torch/classify.py` carries the same text and calls it for its
flagged reads and its support-8 vote, so a fault shared by the walk's text
would pass here too: the hand-worked cases of
`tests/test_portbench_reference.py` (SURVEY.md section 2.5's rules) stand
beside it.  The copy lives here so that the benchmark's reference imports
nothing of either package."""

from __future__ import annotations

import numpy as np

U32 = 0xFFFFFFFF


def _u32(x: int) -> int:
    return x & U32


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
