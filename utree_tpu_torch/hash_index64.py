"""Canonical dual-value hash index for PACKSIZE=64 (BASELINE config 4): the
port's copy of `utree_tpu/hash_index64.py` (the numpy builders; the device
tables move with `hash_index.canonical64_to_device` and
`hash_index.displaced64_to_device`).

Same design as hash_index.CanonicalHashArrays but for 128-bit words with
4-byte label ids (itree.c:41-43 PACKSIZE=64 -> WTYPE=__uint128_t;
IXTYPE=uint32_t): keys are four int32 lanes, entries are
(k0, k1, k2, k3, va, vb) = 24B where va/vb = label+1 of the forward /
reverse-complement orientation (0 = miss).  One t1 row = 2 entries = 48B
(two gather sectors); t2 is the cache-resident wide-row spill table.

Values derive from the reference probe's own results over the as-stored bin
table (quirks included) — the 64-mer twin of hash_index._reference_hits,
with 104-bit suffixes compared as (hi, lo) uint64 lane pairs exactly like
xtSuffixBS compares full words (itree.c:699-718).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from utree_tpu_torch.hash_index import (_CANON_T1_CAP, _CANON_T2_BUDGET, _DISP_LOAD,
                                        _DISP_SPILL_BUDGET, _M1, _M2, _M3,
                                        _group_pos, _ranges_to_indices, _rc64,
                                        displaced_nseed, place_displaced_core)
from utree_tpu_torch.index import DeviceIndexArrays
from utree_tpu_torch.utils import trace

CANON64_SLOTS = 2
CANON64_LOAD = 0.3
CANON64_SLOTS2 = 8


def mix4(k0, k1, k2, k3, seed, u32):
    """32-bit mix of four uint32 lanes; written lane-generic so the numpy
    builder and the jnp probe (lookup.lookup_kmers_canonical64) share one
    definition and stay bit-identical."""
    h = (k0 ^ u32(seed)) * u32(int(_M1))
    h = h ^ (h >> u32(16))
    h = h + k1 * u32(int(_M3))
    h = h * u32(int(_M2))
    h = h ^ (h >> u32(13))
    h = h ^ k2 * u32(int(_M1))
    h = h * u32(int(_M3))
    h = h ^ (h >> u32(16))
    h = h + k3 * u32(int(_M2))
    h = h ^ (h >> u32(15))
    return h


def _mix4_np(k0, k1, k2, k3, seed):
    with np.errstate(over="ignore"):
        return mix4(k0.astype(np.uint32), k1.astype(np.uint32),
                    k2.astype(np.uint32), k3.astype(np.uint32), seed, np.uint32)


def _reference_hits64(index: DeviceIndexArrays):
    """All (word_hi, word_lo, ix) the 64-mer reference probe can return."""
    bin_ix = index.bin_ix.astype(np.int64)
    s_hi = index.s_hi64
    s_lo = index.s_lo64
    ixv = index.ix.astype(np.int64)
    n = len(s_hi)
    starts = bin_ix[:-1]
    ends = bin_ix[1:]
    pop = np.flatnonzero(ends > starts)
    # lexicographic (hi, lo) break scan, as in hash_index._reference_hits
    breaks_cum = np.zeros(n + 1, np.int64)
    if n > 1:
        le = (s_hi[1:] < s_hi[:-1]) | ((s_hi[1:] == s_hi[:-1]) & (s_lo[1:] <= s_lo[:-1]))
        np.cumsum(le, out=breaks_cum[2:])
        breaks_cum[1] = 0
    a_pop = starts[pop]
    b_pop = ends[pop]
    inner = breaks_cum[b_pop] - breaks_cum[np.minimum(a_pop + 1, b_pop)]
    normal = inner == 0
    npop = pop[normal]
    lens = (b_pop - a_pop)[normal]
    idx = _ranges_to_indices(a_pop[normal], lens)
    pre = np.repeat(npop, lens).astype(np.uint64)
    out_hi = [(pre << np.uint64(40)) | s_hi[idx]]
    out_lo = [s_lo[idx]]
    out_ix = [ixv[idx]]
    for p in pop[~normal]:
        a, b = int(starts[p]), int(ends[p])
        sufs = [(int(s_hi[j]) << 64) | int(s_lo[j]) for j in range(a, b)]
        for q in sorted(set(sufs)):
            pp, size = 0, len(sufs) - 1
            while size:
                w = size >> 1
                if sufs[pp + w + 1] <= q:
                    pp += w + 1
                    size -= w + 1
                else:
                    size = w
            if sufs[pp] == q:
                w128 = (p << 104) | q
                out_hi.append(np.array([w128 >> 64], np.uint64))
                out_lo.append(np.array([w128 & ((1 << 64) - 1)], np.uint64))
                out_ix.append(np.array([ixv[a + pp]], np.int64))
    return (np.concatenate(out_hi), np.concatenate(out_lo), np.concatenate(out_ix))


@dataclasses.dataclass
class CanonicalHash64Arrays:
    t1: np.ndarray  # int32 (B1, slots*6)
    t2: np.ndarray  # int32 (B2, slots2*6)
    t3: np.ndarray  # int32 (B3, slots3*6); 8-row sentinel = absent
    slots: int
    slots2: int
    slots3: int
    num_entries: int


def _rc128(hi: np.ndarray, lo: np.ndarray):
    """128-bit reverse complement on uint64 lane pairs: each half is
    complement-reversed (hash_index._rc64) and the halves swap."""
    return _rc64(lo), _rc64(hi)


def _canonical_groups64(index: DeviceIndexArrays):
    """Canonical (128-bit lex-min of word/RC) dual-value entries as four
    uint32 key lanes + (va, vb); the 64-mer twin of
    hash_index._canonical_groups."""
    if index.config.packsize != 64 or index.s_hi64 is None:
        raise ValueError("canonical64 requires a PACKSIZE=64 index")
    w_hi, w_lo, ix = _reference_hits64(index)
    if len(ix) and int(ix.max()) + 1 >= 1 << 31:
        raise ValueError("label ids must fit int32")
    r_hi, r_lo = _rc128(w_hi, w_lo)
    fwd_le = (w_hi < r_hi) | ((w_hi == r_hi) & (w_lo <= r_lo))
    c_hi = np.where(fwd_le, w_hi, r_hi)
    c_lo = np.where(fwd_le, w_lo, r_lo)
    is_fwd = fwd_le
    order = np.lexsort((c_lo, c_hi))
    chs, cls = c_hi[order], c_lo[order]
    isf = is_fwd[order]
    ixs = ix[order]
    new = np.ones(len(chs), bool)
    if len(chs) > 1:
        new[1:] = (chs[1:] != chs[:-1]) | (cls[1:] != cls[:-1])
    gid = np.cumsum(new) - 1
    ng = int(gid[-1]) + 1 if len(chs) else 0
    va = np.zeros(ng, np.int64)
    vb = np.zeros(ng, np.int64)
    va[gid[isf]] = ixs[isf] + 1
    vb[gid[~isf]] = ixs[~isf] + 1
    ck_hi = chs[new]
    ck_lo = cls[new]
    p_hi, p_lo = _rc128(ck_hi, ck_lo)
    pal = (ck_hi == p_hi) & (ck_lo == p_lo)
    vb[pal] = va[pal]

    k0 = (ck_hi >> np.uint64(32)).astype(np.uint32)
    k1 = (ck_hi & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    k2 = (ck_lo >> np.uint64(32)).astype(np.uint32)
    k3 = (ck_lo & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    lanes = [k0.view(np.int32), k1.view(np.int32), k2.view(np.int32), k3.view(np.int32),
             va.astype(np.int32), vb.astype(np.int32)]
    return lanes, k0, k1, k2, k3, ng


def build_canonical_hash_index64(
    index: DeviceIndexArrays,
    slots: int | None = None,
    load: float | None = None,
    slots2: int | None = None,
) -> CanonicalHash64Arrays:
    """64-mer canonical table with the same geometry LADDER as the 32-mer
    one (hash_index.build_canonical_hash_index): tiny-cached-t2 tier, then
    a 3-level narrow-row chain, then the wide-t2 fallback."""
    lanes, k0, k1, k2, k3, ng = _canonical_groups64(index)

    if slots is not None:
        tiers = [(slots, load or CANON64_LOAD, slots2 or CANON64_SLOTS2,
                  1 << 26, 0)]
    else:
        tiers = [
            (CANON64_SLOTS, CANON64_LOAD, CANON64_SLOTS2, _CANON_T2_BUDGET // 24, 0),
            (CANON64_SLOTS, 0.56, 2, 1 << 26, 8),
            (CANON64_SLOTS, 0.56, 8, 1 << 26, 0),
        ]
    err = None
    rec = trace.process()
    for s_, load_, s2_, budget_, s3_ in tiers:
        rec.count("table.attempts", 1)
        try:
            with rec.phase("table:tier"):
                return _place64(lanes, k0, k1, k2, k3, ng, s_, load_, s2_, budget_, s3_)
        except (ValueError, RuntimeError) as e:
            err = e
    raise ValueError(f"canonical64 table does not fit any geometry tier: {err}")


def _fill64(table, sb, pos, src, lanes):
    for j, lane in enumerate(lanes):
        table[sb, pos * 6 + j] = lane[src]


def _place64(lanes, k0, k1, k2, k3, ng, slots, load, slots2,
             t2_budget_entries, slots3=0) -> CanonicalHash64Arrays:
    h1 = _mix4_np(k0, k1, k2, k3, 0)
    hb = _mix4_np(k0, k1, k2, k3, 0x6A09E667)
    with np.errstate(over="ignore"):
        g = h1 ^ ((hb << np.uint32(15)) | (hb >> np.uint32(17)))
    b1 = max(8, 1 << int(np.ceil(np.log2(max(1, ng / (slots * load))))))
    while b1 * slots * 24 > _CANON_T1_CAP:
        b1 //= 2
    while True:
        order1, sb, pos = _group_pos(g, b1)
        fits = pos < slots
        if int((~fits).sum()) <= t2_budget_entries:
            break
        if b1 * slots * 24 * 2 > _CANON_T1_CAP:
            raise ValueError("canonical64 table would exceed the HBM budget")
        b1 *= 2
    t1 = np.zeros((b1, slots * 6), np.int32)
    _fill64(t1, sb[fits], pos[fits], order1[fits], lanes)
    spill = order1[~fits]

    t3 = np.zeros((8, max(slots3, 1) * 6), np.int32)
    if len(spill) == 0:
        t2 = np.zeros((8, slots2 * 6), np.int32)
        return CanonicalHash64Arrays(t1, t2, t3, slots, slots2, max(slots3, 1), ng)
    h2 = _mix4_np(k0[spill], k1[spill], k2[spill], k3[spill], 0x5BD1E995)

    if slots3:
        # 3-level chain: narrow t2 rows; its Poisson tail goes to cached t3
        b2 = max(16, 1 << int(np.ceil(np.log2(max(1, len(spill) / (slots2 * 0.3))))))
        while True:
            order2, sb2, pos2 = _group_pos(h2, b2)
            over = pos2 >= slots2
            n3 = int(over.sum())
            if n3 <= 120_000:
                break
            if b2 * slots2 * 24 * 2 > 1 << 30:
                raise RuntimeError("canonical64 t2 overflow exceeds the t3 budget")
            b2 *= 2
        t2 = np.zeros((b2, slots2 * 6), np.int32)
        _fill64(t2, sb2[~over], pos2[~over], spill[order2[~over]], lanes)
        rest = spill[order2[over]]
        if len(rest):
            h3 = _mix4_np(k0[rest], k1[rest], k2[rest], k3[rest], 0x27D4EB2F)
            b3 = max(16, 1 << int(np.ceil(np.log2(max(1, len(rest) / max(1, slots3 // 2))))))
            while True:
                order3, sb3, pos3 = _group_pos(h3, b3)
                if len(pos3) == 0 or int(pos3.max()) < slots3:
                    break
                b3 *= 2
                if b3 * slots3 * 24 > 8 << 20:
                    raise RuntimeError("canonical64 t3 overflow")
            t3 = np.zeros((b3, slots3 * 6), np.int32)
            _fill64(t3, sb3, pos3, rest[order3], lanes)
        return CanonicalHash64Arrays(t1, t2, t3, slots, slots2, slots3, ng)

    b2 = max(16, 1 << int(np.ceil(np.log2(max(1, len(spill) / max(1, slots2 // 2))))))
    while True:
        order2, sb2, pos2 = _group_pos(h2, b2)
        if len(pos2) == 0 or int(pos2.max()) < slots2:
            break
        b2 *= 2
        if b2 * slots2 * 24 > 2 << 30:
            raise RuntimeError("canonical64 spill table overflow")
    t2 = np.zeros((b2, slots2 * 6), np.int32)
    _fill64(t2, sb2, pos2, spill[order2], lanes)
    return CanonicalHash64Arrays(t1, t2, t3, slots, slots2, max(slots3, 1), ng)


# ---- seeded-displacement tier (one 48B row gather per probe) -------------
# The 64-mer twin of hash_index.DisplacedHashArrays: entries are 6 int32
# (k0..k3, va, vb) so a 2-slot t1 row is 48B = two gather sectors; the
# cached u8 seed table and the slot-mix schedule are shared with the 32-mer
# placement via place_displaced_core (u2/u3 overridden with mix4 lanes).

_DISP64_SALT_U2 = 0x94D049BB
_DISP64_SALT_U3 = 0x7FEB352D


@dataclasses.dataclass
class Displaced64Arrays:
    t1: np.ndarray  # int32 (nslots/2, 12)
    seeds: np.ndarray  # int32 (nseed//4,) packed u8, little-endian
    t3: np.ndarray  # int32 (B3, slots3*6); 8-row all-zero = absent
    slots3: int
    num_entries: int


def displaced_buckets64_np(k0, k1, k2, k3, nseed: int) -> np.ndarray:
    """Seed-bucket per key: the same folded two-mix hash the canonical64 t1
    uses (probe twin: lookup.lookup_kmers_displaced64)."""
    h1 = _mix4_np(k0, k1, k2, k3, 0)
    hb = _mix4_np(k0, k1, k2, k3, 0x6A09E667)
    with np.errstate(over="ignore"):
        g = h1 ^ ((hb << np.uint32(15)) | (hb >> np.uint32(17)))
    return (g & np.uint32(nseed - 1)).astype(np.int64)


def build_displaced_index64(
    index: DeviceIndexArrays,
    load: float | None = None,
    spill_budget: int | None = None,
) -> Displaced64Arrays:
    lanes, k0, k1, k2, k3, ng = _canonical_groups64(index)
    if ng == 0:
        raise ValueError("empty index")
    nseed = displaced_nseed(ng)
    if nseed > (1 << 26):
        raise ValueError("seed table would exceed the measured-free 64MB")
    bucket = displaced_buckets64_np(k0, k1, k2, k3, nseed)
    u2 = _mix4_np(k0, k1, k2, k3, _DISP64_SALT_U2)
    u3 = _mix4_np(k0, k1, k2, k3, _DISP64_SALT_U3)
    vals = np.stack(lanes[2:], axis=1)  # (k2, k3, va, vb) -> cps = 6
    t1, seeds32, spilled = place_displaced_core(
        lanes[0], lanes[1], vals, None, None, None, ng,
        load=_DISP_LOAD if load is None else load,
        spill_budget=_DISP_SPILL_BUDGET if spill_budget is None else spill_budget,
        bucket=bucket, nseed=nseed, u2=u2, u3=u3)

    # narrow tail rows (2 slots = 48B): probed unconditionally, so row width
    # dominates its cost even cache-resident (see hash_index.build_spill_t3)
    slots3 = 2
    t3 = np.zeros((8, slots3 * 6), np.int32)
    if len(spilled):
        h3 = _mix4_np(k0[spilled], k1[spilled], k2[spilled], k3[spilled],
                      0x27D4EB2F)
        b3 = max(16, 1 << int(np.ceil(np.log2(max(1, len(spilled) / (slots3 // 2))))))
        while True:
            order3, sb3, pos3 = _group_pos(h3, b3)
            if len(pos3) == 0 or int(pos3.max()) < slots3:
                break
            b3 *= 2
            if b3 * slots3 * 6 * 4 > 32 << 20:
                raise ValueError("displaced64 spill tail overflow")
        t3 = np.zeros((b3, slots3 * 6), np.int32)
        _fill64(t3, sb3, pos3, spilled[order3], lanes)
    return Displaced64Arrays(t1=t1, seeds=seeds32, t3=t3, slots3=slots3,
                             num_entries=ng)
