"""Exact hash tables of the reference lookup: the port's copy of the numpy
placement in `utree_tpu/hash_index.py`, and the device tables built from it.

The reference lookup is not pure membership: the compressor's quirky bin
table can make existing k-mers unfindable or let a bin's probe range
swallow a neighbour's records (formats.compute_bin_ix).  So every table is
built from the reference probe's own results (`_reference_hits`): for every
bin range and every distinct suffix in it, the entry's value is what
xtSuffixBS would return.  Two tables place those entries, keyed on the
canonical word (min of word and its reverse complement) with both
orientations' values in one slot:

  build_canonical_hash_index  the canonical ladder c1 -> c2 -> c3
  build_displaced_index       the seeded-displacement table d1 (one 2-slot
                              row per probe, a u8 seed per bucket) and its
                              cached spill tail d3

The legacy two-table hash (`build_hash_index`) keys the forward word
itself: one 8-slot t1 row per bucket, its overflow in a differently mixed
t2, one label id a slot.

All move to a device as int32 tensors under the JAX pytree's keys:

  displaced_to_device    {d1, ds, d3}
  canonical_to_device    {c1, c2, c3}
  hash_to_device         {t1, t2}
  displaced64_to_device  {d64_1, d64_s, d64_3}   (hash_index64)
  canonical64_to_device  {c64_1, c64_2, c64_3}   (hash_index64)
  bsearch_to_device      {bin_ix, rec, and rec's columns suf_hi, suf_lo, ix}
                         (the CTR records)

Narrow and wide (4-column slot) rows travel alike.  The geometry constants
were tuned on a TPU (ROADMAP A.11); any geometry is exact, since a probe
reads the stored shape.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from utree_tpu_torch.index import DeviceIndexArrays

# 32-bit mix constants (Murmur3/splitmix-style finalizer pieces)
_M1 = np.uint32(0x9E3779B1)
_M2 = np.uint32(0x85EBCA6B)
_M3 = np.uint32(0xC2B2AE35)

# canonical-table geometry, shared by builder (here) and device probe
# (lookup.lookup_kmers_canonical).  TPU gather cost is quantized by 32-byte
# sectors (measured, v5e: rows <= 8 int32 cols gather at 17.7ns, 9-16 cols at
# 25.3ns, independent of table size) — so t1 rows are 2 slots = 24B, and the
# builder doubles t1 until the Poisson tail past 2 slots fits the tiny-spill
# budget below.
CANON_SLOTS = 2
CANON_LOAD = 0.3  # per-slot; bucket lambda = slots * load
# t2 rows are WIDE (16 slots): the table is cache-resident so row width is
# nearly free, and a 16-slot bucket at lambda <= ~7 has a vanishing overflow
# tail — one single probe, no growth spiral
CANON_SLOTS2 = 16
# Spill must stay TINY: t2's own fit-growth loop multiplies its size by the
# Poisson tail, and a t2 past the on-chip cache adds a full-price second HBM
# gather to every lookup.  1MB of spill entries keeps t2 well under ~4MB
# after growth.  t1 is capped at 8GB (v5e HBM is 16GB); builds that cannot
# satisfy both raise, and the pipeline falls back to the bsearch path.
_CANON_T2_BUDGET = (1 << 20) + (1 << 18)  # 1.25MB of entries -> t2 <= ~1.5MB
_CANON_T1_CAP = 6 << 30  # v5e HBM is 16GB; measured step workspace + t2 need ~8GB headroom at batch 65536


def _mix_np(pre: np.ndarray, hi: np.ndarray, lo: np.ndarray) -> np.ndarray:
    """Deterministic 32-bit mix of the (pre24, hi8, lo32) word lanes; the jnp
    twin in lookup.py must compute the identical value.

    The final multiply+shift matters: with `hi` entering through a single
    add-multiply, collision deltas were SALT-INDEPENDENT — key pairs that
    collided under one salted variant collided under all of them, so the
    same pairs deadlocked the displaced placement (slot equal under every
    seed), spilled together, and then re-collided in the spill tail's
    buckets (observed: 5-entry t3 clusters at lambda 0.06).  The extra
    multiply gives every lane two full avalanche rounds."""
    with np.errstate(over="ignore"):
        h = pre.astype(np.uint32) * _M1
        h ^= lo.astype(np.uint32) ^ (lo.astype(np.uint32) >> np.uint32(16))
        h *= _M2
        h ^= h >> np.uint32(13)
        h += hi.astype(np.uint32) * _M3
        h ^= h >> np.uint32(16)
        h *= _M1
        h ^= h >> np.uint32(15)
    return h


@dataclasses.dataclass
class HashIndexArrays:
    """Two flat bucket tables; each bucket is S slots of (key_lo, key_hi, ix).
    key_lo = suffix bits 31..0; key_hi = prefix24<<8 | suffix bits 39..32.
    Empty slots have ix == -1."""

    t1: np.ndarray  # int32 (B1, S*3)
    t2: np.ndarray  # int32 (B2, S*3)
    slots: int
    num_entries: int


def _reference_hits(index: DeviceIndexArrays):
    """All (pre, hi, lo, ix) the reference lookup can return, derived from the
    as-stored bin table (quirks included)."""
    cfg = index.config
    bin_ix = index.bin_ix.astype(np.int64)
    n = index.num_records
    # narrow lanes throughout: at the ~1.2G-entry flagship scale the old
    # int64 copies (suf_hi/suf_lo/suffix at 8B each) alone cost ~29GB of
    # transient host RAM; the scan below needs only the stored i32/u32
    # views and a lexicographic compare
    suf_hi = index.suf_hi[:n]  # int32 view (values 0..255)
    suf_lo = index.suf_lo[:n].view(np.uint32)
    # true record extents per populated prefix
    nbins = (1 << cfg.ctr_prefix_bits)
    # prefix of each record = searchsorted over TRUE sorted order: records are
    # stored sorted by word, so true extents come from the suffix-run... we
    # don't have stored prefixes; recover true extents from bin_ix where
    # monotone steps match record counts.  Simpler: a bin p is NORMAL iff
    # probing each distinct suffix in [bin_ix[p], bin_ix[p+1]) over a SORTED
    # range yields itself — which holds iff the range is sorted by suffix
    # with unique values.  Check per populated range vectorized.
    starts = bin_ix[:-1]
    ends = bin_ix[1:]
    pop = np.flatnonzero(ends > starts)
    # global break scan: breaks[i] == 1 means suffix[i] <= suffix[i-1]; a bin
    # range [a, b) is NORMAL iff it contains no break strictly inside — i.e.
    # its suffixes are strictly increasing, so every distinct suffix probes to
    # itself.  Only anomalous bins (compressor quirks; a handful at most) need
    # the literal per-suffix probe replay below.
    breaks_cum = np.zeros(n + 1, np.int64)
    if n > 1:
        # suffix[i] <= suffix[i-1] via lexicographic (hi, lo) compare — no
        # 64-bit suffix materialization
        le = (suf_hi[1:] < suf_hi[:-1]) | (
            (suf_hi[1:] == suf_hi[:-1]) & (suf_lo[1:] <= suf_lo[:-1]))
        np.cumsum(le, out=breaks_cum[2:])
        breaks_cum[1] = 0
        del le
    a_pop = starts[pop]
    b_pop = ends[pop]
    inner_breaks = breaks_cum[b_pop] - breaks_cum[np.minimum(a_pop + 1, b_pop)]
    del breaks_cum
    normal = inner_breaks == 0
    npop = pop[normal]
    lens = (b_pop - a_pop)[normal]
    idx = _ranges_to_indices(a_pop[normal], lens)
    pre = np.repeat(npop.astype(np.int32), lens)
    hi = suf_hi[idx].astype(np.int32)
    lo = suf_lo[idx]
    ix = index.ix[idx]
    del idx
    anom = pop[~normal]
    if len(anom):
        out_pre, out_hi, out_lo, out_ix = [], [], [], []
        for p in anom:
            a, b = int(starts[p]), int(ends[p])
            s = ((suf_hi[a:b].astype(np.uint64) << np.uint64(32))
                 | suf_lo[a:b].astype(np.uint64))
            # anomalous (merged/contaminated) range: literal probe per
            # distinct suffix — only reachable via compressor quirks, so tiny
            for q in np.unique(s):
                ixv = _probe_range(s, index.ix[a:b], int(q))
                if ixv is not None:
                    out_pre.append(p); out_hi.append(int(q) >> 32)
                    out_lo.append(int(q) & 0xFFFFFFFF); out_ix.append(ixv)
        pre = np.concatenate([pre, np.asarray(out_pre, np.int32)])
        hi = np.concatenate([hi, np.asarray(out_hi, np.int32)])
        lo = np.concatenate([lo, np.asarray(out_lo, np.uint32)])
        ix = np.concatenate([ix, np.asarray(out_ix, np.int32)])
    return pre, hi, lo, ix


def _ranges_to_indices(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Concatenate [s, s+len) ranges into one index vector, vectorized."""
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    idx = np.ones(total, np.int64)
    heads = np.zeros(len(lens), np.int64)
    np.cumsum(lens, out=heads)
    pos = np.concatenate(([0], heads[:-1]))
    idx[pos] = starts
    idx[pos[1:]] -= starts[:-1] + lens[:-1] - 1
    return np.cumsum(idx)


def _probe_range(suffixes: np.ndarray, ixs: np.ndarray, q: int):
    """Literal xtSuffixBS over one range; None if the probe can't find q."""
    p, size = 0, len(suffixes) - 1
    while size:
        w = size >> 1
        if int(suffixes[p + w + 1]) <= q:
            p += w + 1
            size -= w + 1
        else:
            size = w
    return int(ixs[p]) if int(suffixes[p]) == q else None


def _rc64(w: np.ndarray) -> np.ndarray:
    """uint64 reverse complement of 32-mers: complement 2-bit codes (A<->T,
    C<->G under the 2-bit encoding is bitwise NOT) then reverse base order
    (arithmetic form of the RC table, itree.c:93-95,891-897)."""
    x = ~w
    m2 = np.uint64(0x3333333333333333)
    m4 = np.uint64(0x0F0F0F0F0F0F0F0F)
    m8 = np.uint64(0x00FF00FF00FF00FF)
    m16 = np.uint64(0x0000FFFF0000FFFF)
    x = ((x & m2) << np.uint64(2)) | ((x >> np.uint64(2)) & m2)
    x = ((x & m4) << np.uint64(4)) | ((x >> np.uint64(4)) & m4)
    x = ((x & m8) << np.uint64(8)) | ((x >> np.uint64(8)) & m8)
    x = ((x & m16) << np.uint64(16)) | ((x >> np.uint64(16)) & m16)
    return (x << np.uint64(32)) | (x >> np.uint64(32))


@dataclasses.dataclass
class CanonicalHashArrays:
    """Canonical-kmer dual-value hash table: ONE row gather per query position
    answers both strands.

    Per scanned position the reference collects hits for the forward word f
    and (with RC) for rc(f) (itree.c:891-897,928-932).  As a multiset,
    {ix(f), ix(rc(f))} == {ix(c), ix(rc(c))} where c = min(f, rc(f)) — so an
    entry keyed on the canonical word storing BOTH orientation values yields
    the exact reference hit multiset with half the lookups.  Orientation
    (f <= rc(f)) recovers the forward-only hit for non-RC search.

    Entry = (key_lo, key_hi, vals) int32 where vals = (ix_fwd+1) | (ix_rc+1)<<16
    (0 half = that orientation is a miss; an all-zero vals marks an empty
    slot, which is unambiguous because a value-less entry is never inserted).
    Values are derived from the reference probe's own results, quirks
    included (see _reference_hits).  t1 rows are `slots` entries; overflow
    lives in t2 (differently mixed), sized to stay small enough for the
    on-chip gather fast path."""

    t1: np.ndarray  # int32 (B1, slots*3)
    t2: np.ndarray  # int32 (B2, slots2*3)
    t3: np.ndarray  # int32 (B3, slots3*3); 8-row sentinel = absent
    slots: int
    slots2: int
    slots3: int
    num_entries: int


def build_canonical_hash_index(
    index: DeviceIndexArrays,
    slots: int | None = None,
    load: float | None = None,
    slots2: int | None = None,
) -> CanonicalHashArrays:
    """Build the canonical table, walking a geometry LADDER so that big DBs
    degrade gracefully instead of losing the hash path entirely:

      tier A: 2 slots (24B = 1-sector rows, ~17.7ns gather), tiny cached t2
              — covers up to ~80M entries within the t1 cap;
      tier B: THREE-level chain with narrow rows everywhere — t1 4 slots
              (48B = 2 sectors, measured 22.1ns), t2 2 slots (24B = 1
              sector, 14.9ns) absorbing the spill, t3 tiny+cached (16
              slots) absorbing t2's own Poisson tail.  All three gather
              indices derive from the key alone (no dependent gathers, so
              they pipeline); ~41ns/probe at the real-L2 150M-entry scale.
              (Measured dead ends, kept out: 5-slot 64B rows lose nothing
              on the gather but force 192B t2 rows (~55ns); per-bucket
              spill FLAGS make the t2 index depend on the t1 row and
              serialize the chain — 943ms vs 497ms per batch.)
      tier C: 4 slots + wide-rowed HBM t2 (every probe pays a 96B second
              gather; the safety net when t2/t3 budgets cannot hold).

    Passing slots/load/slots2 pins a single geometry (tests)."""
    key_lo, key_hi, vals, cpre, chi, clo, ng = _canonical_groups(index)
    if slots is not None:
        tiers = [(slots, load or CANON_LOAD, slots2 or CANON_SLOTS2, 1 << 27, 0)]
    else:
        tiers = [
            (CANON_SLOTS, CANON_LOAD, CANON_SLOTS2, _CANON_T2_BUDGET // 12, 0),
            (4, 0.56, 2, 1 << 27, 16),
            (4, 0.56, 8, 1 << 27, 0),
        ]
    err: Exception | None = None
    for s_, load_, s2_, budget_, s3_ in tiers:
        try:
            return _place_canonical(key_lo, key_hi, vals, cpre, chi, clo, ng,
                                    s_, load_, s2_, budget_, slots3=s3_)
        except (ValueError, RuntimeError) as e:
            err = e
    raise ValueError(f"canonical table does not fit any geometry tier: {err}")


def _canonical_groups(index: DeviceIndexArrays):
    """Reference-hit set folded to canonical dual-value groups: the entry
    arrays every geometry places.  Returns (key_lo, key_hi, vals2d, cpre,
    chi, clo, num_groups) where vals2d is (ng, 1) int32 packed u16 pairs for
    label ids < 65535, or (ng, 2) int32 (va, vb) WIDE entries otherwise
    (IXTYPE=u32 DBs keep the fast path; slots grow from 12B to 16B)."""
    cfg = index.config
    if cfg.packsize != 32:
        raise ValueError("canonical hash path implements k=32")
    pre, hi, lo, ix = _reference_hits(index)
    # wideness keys off num_labels — the SAME quantity the jitted step uses
    # to pick the probe layout (a table built narrow but probed wide would
    # silently mis-read)
    wide = index.num_labels >= 0xFFFF
    if wide and len(ix) and int(ix.max()) >= 0x7FFFFFFE:
        raise ValueError("canonical hash path requires label ids < 2^31-1")
    w = (
        (pre.astype(np.uint64) << np.uint64(40))
        | (hi.astype(np.uint64) << np.uint64(32))
        | lo.astype(np.uint64)
    )
    del pre, hi, lo
    r = _rc64(w)
    c = np.minimum(w, r)
    del r
    is_fwd = w == c
    del w
    # transients retire as soon as possible: at the 1.2G flagship scale each
    # full-width array here is ~10GB of host RAM
    order = np.argsort(c, kind="stable")
    cs = c[order]
    del c
    isf = is_fwd[order]
    del is_fwd
    ixs = ix[order].astype(np.uint32)
    del ix, order
    new = np.ones(len(cs), bool)
    if len(cs) > 1:
        new[1:] = cs[1:] != cs[:-1]
    gid = np.cumsum(new) - 1
    ng = int(gid[-1]) + 1 if len(cs) else 0
    va = np.zeros(ng, np.uint32)
    vb = np.zeros(ng, np.uint32)
    va[gid[isf]] = ixs[isf] + np.uint32(1)
    vb[gid[~isf]] = ixs[~isf] + np.uint32(1)
    del gid, isf, ixs
    ck = cs[new]
    del cs, new
    pal = ck == _rc64(ck)  # palindromic 32-mer: one word, hit on both scans
    vb[pal] = va[pal]
    del pal
    if wide:
        vals = np.stack([va.view(np.int32), vb.view(np.int32)], axis=1)
    else:
        vals = (va | (vb << np.uint32(16))).view(np.int32)[:, None]
    del va, vb
    key_lo = (ck & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    key_hi = (ck >> np.uint64(32)).astype(np.uint32).view(np.int32)
    # (cpre, chi, clo) feed only the uint32 mixes (_mix_np and twins), which
    # truncate to the low 32 bits of whatever integer dtype arrives — narrow
    # lanes are bit-identical inputs at a third of the memory
    cpre = (ck >> np.uint64(40)).astype(np.int32)
    chi = ((ck >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int32)
    clo = key_lo
    return key_lo, key_hi, vals, cpre, chi, clo, ng


def _group_pos(h: np.ndarray, b: int):
    """Sorted-group placement positions for bucketed hashing: returns
    (order, sb, pos) where sb = sorted bucket ids and pos = each entry's
    rank within its bucket."""
    bucket = (h & np.uint32(b - 1)).astype(np.int64)
    order = np.argsort(bucket, kind="stable")
    sb = bucket[order]
    new = np.ones(len(sb), bool)
    if len(sb) > 1:
        new[1:] = sb[1:] != sb[:-1]
    grp = np.maximum.accumulate(np.where(new, np.arange(len(sb)), 0))
    pos = np.arange(len(sb)) - grp
    return order, sb, pos


def _fill(table: np.ndarray, sb, pos, src, key_lo, key_hi, vals2d):
    cps = 2 + vals2d.shape[1]  # cols per slot
    table[sb, pos * cps] = key_lo[src]
    table[sb, pos * cps + 1] = key_hi[src]
    for v in range(vals2d.shape[1]):
        table[sb, pos * cps + 2 + v] = vals2d[src, v]


# 3-level tier limits: t2 stays narrow-rowed and HBM-resident, t3 absorbs
# t2's Poisson tail and must stay on-chip-cache-sized
_T3_ENTRY_BUDGET = 120_000
_T2_BYTE_CAP = 1 << 30
_T3_BYTE_CAP = 8 << 20


def _place_canonical(key_lo, key_hi, vals, cpre, chi, clo, ng,
                     slots, load, slots2, t2_budget_entries,
                     slots3: int = 0) -> CanonicalHashArrays:
    cps = 2 + vals.shape[1]  # cols per slot (3 narrow, 4 wide)
    row_bytes = slots * cps * 4
    b1 = max(8, 1 << int(np.ceil(np.log2(max(1, ng / (slots * load))))))
    while b1 * row_bytes > _CANON_T1_CAP:
        b1 //= 2
    # bucket hash folds TWO independent 32-bit mixes: a single 32-bit hash
    # has ~n^2/2^33 birthday-colliding pairs (46K at 20M keys) that no table
    # growth can separate; the fold makes residual pair collisions scale with
    # 1/b1 instead
    h1 = _mix_np(cpre, chi, clo)
    hb = _mix_np(cpre, chi, clo ^ np.int64(0x6A09E667))
    g = h1 ^ ((hb << np.uint32(15)) | (hb >> np.uint32(17)))
    # grow t1 until the spill fits this tier's t2 budget
    while True:
        sb_order, sb, pos_in = _group_pos(g, b1)
        fits = pos_in < slots
        n_spill = int((~fits).sum())
        if n_spill <= t2_budget_entries:
            break
        if b1 * row_bytes * 2 > _CANON_T1_CAP:
            raise ValueError("canonical table would exceed the HBM budget")
        b1 *= 2
    t1 = np.zeros((b1, slots * cps), np.int32)
    _fill(t1, sb[fits], pos_in[fits], sb_order[fits], key_lo, key_hi, vals)
    spill = sb_order[~fits]

    t3 = np.zeros((8, max(slots3, 1) * cps), np.int32)
    if len(spill) == 0:
        t2 = np.zeros((8, slots2 * cps), np.int32)  # shape<=8 rows: probe skipped
        return CanonicalHashArrays(t1=t1, t2=t2, t3=t3, slots=slots,
                                   slots2=slots2, slots3=max(slots3, 1),
                                   num_entries=ng)
    h2 = _mix_np(cpre[spill], chi[spill], clo[spill] ^ np.int64(0x5BD1E995))

    if slots3:
        # 3-level chain: t2 rows NARROW (1 sector at slots2=2 -> ~15ns
        # gather); its own Poisson tail overflows into the tiny cached t3
        # instead of forcing wide t2 rows (192B rows measured ~2.5x slower)
        b2 = max(16, 1 << int(np.ceil(np.log2(max(1, len(spill) / (slots2 * 0.3))))))
        while True:
            order2, sb2, pos2 = _group_pos(h2, b2)
            over = pos2 >= slots2
            n3 = int(over.sum())
            if n3 <= _T3_ENTRY_BUDGET:
                break
            if b2 * slots2 * cps * 4 * 2 > _T2_BYTE_CAP:
                raise RuntimeError("canonical t2 overflow exceeds the t3 budget")
            b2 *= 2
        t2 = np.zeros((b2, slots2 * cps), np.int32)
        _fill(t2, sb2[~over], pos2[~over], spill[order2[~over]], key_lo, key_hi, vals)
        rest = spill[order2[over]]
        if len(rest):
            h3 = _mix_np(cpre[rest], chi[rest], clo[rest] ^ np.int64(0x27D4EB2F))
            b3 = max(16, 1 << int(np.ceil(np.log2(max(1, len(rest) / max(1, slots3 // 2))))))
            while True:
                order3, sb3, pos3 = _group_pos(h3, b3)
                if len(pos3) == 0 or int(pos3.max()) < slots3:
                    break
                b3 *= 2
                if b3 * slots3 * cps * 4 > _T3_BYTE_CAP:
                    raise RuntimeError("canonical t3 overflow")
            t3 = np.zeros((b3, slots3 * cps), np.int32)
            _fill(t3, sb3, pos3, rest[order3], key_lo, key_hi, vals)
        return CanonicalHashArrays(t1=t1, t2=t2, t3=t3, slots=slots,
                                   slots2=slots2, slots3=slots3, num_entries=ng)

    b2 = max(16, 1 << int(np.ceil(np.log2(max(1, len(spill) / max(1, slots2 // 2))))))
    while True:
        order2, sb2, pos2 = _group_pos(h2, b2)
        if len(pos2) == 0 or int(pos2.max()) < slots2:
            break
        b2 *= 2
        # t2 may legitimately be LARGE in the HBM-spill tier; only a hard
        # byte cap (2GB) stops the growth spiral
        if b2 * slots2 * cps * 4 > 2 << 30:
            raise RuntimeError("canonical spill table overflow")
    t2 = np.zeros((b2, slots2 * cps), np.int32)
    _fill(t2, sb2, pos2, spill[order2], key_lo, key_hi, vals)
    return CanonicalHashArrays(t1=t1, t2=t2, t3=t3, slots=slots,
                               slots2=slots2, slots3=max(slots3, 1),
                               num_entries=ng)


def build_hash_index(index: DeviceIndexArrays, slots: int = 8, load: float = 0.4) -> HashIndexArrays:
    pre, hi, lo, ix = _reference_hits(index)
    n = len(ix)
    if np.any(ix >= 2**31):
        raise ValueError("hash path requires label ids < 2^31")
    b1 = max(8, 1 << int(np.ceil(np.log2(max(1, n / (slots * load))))))
    h = _mix_np(pre, hi, lo)
    bucket = (h & np.uint32(b1 - 1)).astype(np.int64)
    key_lo = lo.astype(np.uint32).view(np.int32)
    key_hi = ((pre.astype(np.int64) << 8) | hi).astype(np.uint32).view(np.int32)

    t1 = np.full((b1, slots * 3), -1, np.int32)
    order = np.argsort(bucket, kind="stable")
    sb = bucket[order]
    new = np.ones(len(sb), bool)
    if len(sb) > 1:
        new[1:] = sb[1:] != sb[:-1]
    grp_start = np.maximum.accumulate(np.where(new, np.arange(len(sb)), 0))
    pos_in = np.arange(len(sb)) - grp_start
    fits = pos_in < slots
    rows = sb[fits]
    cols = pos_in[fits]
    src = order[fits]
    t1[rows, cols * 3] = key_lo[src]
    t1[rows, cols * 3 + 1] = key_hi[src]
    t1[rows, cols * 3 + 2] = ix[src].astype(np.int32)
    spill = order[~fits]

    h2 = _mix_np(pre[spill], hi[spill], lo[spill] ^ np.int64(0x5BD1E995))
    b2 = max(8, 1 << int(np.ceil(np.log2(max(1, len(spill) / max(1, slots // 2))))))
    # grow until every spill bucket fits in `slots` (Poisson tails make the
    # first size overflow routinely at tens of millions of entries)
    while True:
        bucket2 = (h2 & np.uint32(b2 - 1)).astype(np.int64)
        order2 = np.argsort(bucket2, kind="stable")
        sb2 = bucket2[order2]
        new2 = np.ones(len(sb2), bool)
        if len(sb2) > 1:
            new2[1:] = sb2[1:] != sb2[:-1]
        grp2 = np.maximum.accumulate(np.where(new2, np.arange(len(sb2)), 0))
        pos2 = np.arange(len(sb2)) - grp2
        if len(pos2) == 0 or int(pos2.max()) < slots:
            break
        b2 *= 2
        if b2 > max(8, 2 * b1):
            raise RuntimeError("hash spill table overflow; lower load factor")
    t2 = np.full((b2, slots * 3), -1, np.int32)
    rows2 = sb2
    cols2 = pos2
    src2 = spill[order2]
    t2[rows2, cols2 * 3] = key_lo[src2]
    t2[rows2, cols2 * 3 + 1] = key_hi[src2]
    t2[rows2, cols2 * 3 + 2] = ix[src2].astype(np.int32)
    return HashIndexArrays(t1=t1, t2=t2, slots=slots, num_entries=n)


# --------------------------------------------------------------------------
# Seeded-displacement canonical index ("tier S") — round 3.
#
# Measured (tools/bench_seed2.py, v5e, 150M entries): a probe = one scalar
# seed gather (<= 64MB table: adds ~0ns even though the t1 index DEPENDS on
# it) + ONE 2-slot 24B/32B row gather = 26.6 ns/probe, vs 46.7 for the
# 3-level chain (two summing row gathers).  Placement freedom comes from a
# per-bucket u8 seed chosen at build so nearly every entry lands in t1; the
# residue lives in the tiny cached tail (same shape as the ladder's t3).
# --------------------------------------------------------------------------

_DISP_SEED_SALT = np.int64(0x94D049BB)
_DISP_SEED_SALT2 = np.int64(0x7FEB352D)
_DISP_C1 = np.uint32(0x85EBCA6B)
_DISP_C2 = np.uint32(0xC2B2AE35)
_DISP_MAX_SEEDS = 256
_DISP_LOAD = 0.62
_DISP_SPILL_BUDGET = 400_000  # must stay cached (t3 grows ~16B/entry)


@dataclasses.dataclass
class DisplacedHashArrays:
    """t1 (nslots/2, 2*cps) int32 2-slot rows; seeds = nseed u8 values packed
    little-endian into int32 words; t3 = cached spill (8-row sentinel =
    absent).  nslots = 2 * t1.shape[0]; nseed = 4 * len(seeds) (pow2)."""

    t1: np.ndarray
    seeds: np.ndarray  # int32 (nseed//4,)
    t3: np.ndarray
    slots3: int
    num_entries: int
    wide: bool


def _disp_slot_np(u2: np.ndarray, ub: np.ndarray, seed, nslots: int) -> np.ndarray:
    """Slot index for (key-mix pair (u2, ub), seed) — numpy twin of the device
    mix.  TWO independent 32-bit key lanes must feed the seed mix: with one
    lane, keys whose 32-bit mixes collide (expected ~n^2/2^33 pairs — ~2.6M at
    150M entries) share a slot under EVERY seed, and the lock-step band
    placement deadlocks both buckets into the spill (observed: 560K spilled at
    150M vs the model's ~0).  With both lanes a collision needs 64 matching
    bits and is seed-transient."""
    with np.errstate(over="ignore"):
        s = np.uint32(seed) if np.isscalar(seed) else seed.astype(np.uint32)
        h = ((u2.astype(np.uint32) ^ (s * _DISP_C1)) * _DISP_C2
             ^ (ub.astype(np.uint32) ^ (s * _DISP_C2)) * _DISP_C1)
    return (h % np.uint32(nslots)).astype(np.int64)


def build_displaced_index(
    index: DeviceIndexArrays,
    load: float = _DISP_LOAD,
    spill_budget: int = _DISP_SPILL_BUDGET,
) -> DisplacedHashArrays:
    key_lo, key_hi, vals, cpre, chi, clo, ng = _canonical_groups(index)
    return place_displaced(key_lo, key_hi, vals, cpre, chi, clo, ng,
                           load=load, spill_budget=spill_budget)


def displaced_buckets_np(cpre, chi, clo, nseed: int) -> np.ndarray:
    """Seed-bucket of each key: the SAME folded two-mix hash as the canonical
    t1 (probe twin: lookup.displaced_probe_raw)."""
    h1 = _mix_np(cpre, chi, clo)
    hb = _mix_np(cpre, chi, clo ^ np.int64(0x6A09E667))
    g = h1 ^ ((hb << np.uint32(15)) | (hb >> np.uint32(17)))
    return (g & np.uint32(nseed - 1)).astype(np.int64)


def displaced_nseed(ng: int) -> int:
    """Seed-table size for ng entries: pow2 with lambda in (2, 4], but never
    above 32MB while lambda stays placeable.

    64MB seed tables sit above the measured v5e cache cliff: +1.45ns/probe
    (tools/bench_seed2-style sweep, round 4: 64MB = 27.3ns, 32MB..4MB flat at
    25.8-25.9ns, bare row gather 18.95ns).  Densifying to lambda <= 4.8 keeps
    the table at <= 32MB through 161M entries, and applying the same density
    before giving up raises the single-chip ceiling from 268M to ~322M."""
    nseed = max(4, 1 << int(np.ceil(np.log2(max(1, ng / 4)))))
    while nseed > (1 << 25) and ng / (nseed >> 1) <= 4.8:
        nseed >>= 1
    return nseed


def place_displaced_core(
    key_lo, key_hi, vals, cpre, chi, clo, ng, *,
    load: float = _DISP_LOAD,
    spill_budget: int = _DISP_SPILL_BUDGET,
    bucket: np.ndarray | None = None,
    nseed: int | None = None,
    t1_cap: int = _CANON_T1_CAP,
    nslots_force: int | None = None,
    u2: np.ndarray | None = None,
    u3: np.ndarray | None = None,
):
    """Seed-choosing placement shared by the utree canonical entries and the
    xtree (prefix, suffix) entries — anything with (lo32, hi32) key lanes.

    bucket/nseed may be precomputed (the routed sharder passes shard-LOCAL
    buckets with the shard's seed-table slice size); nslots_force pins the
    slot count so per-shard t1 arrays can stack on a mesh axis.  u2/u3 may
    be precomputed slot-mix lanes (the 64-mer builder passes mix4-based
    lanes over its four key words; the probe twin must match).  Returns
    (t1, seeds32, spilled_idx) — the caller builds the spill tail (local
    per table, or a merged global one for the routed mode)."""
    if ng == 0:
        raise ValueError("empty index")
    cps = 2 + vals.shape[1]

    if nseed is None:
        nseed = displaced_nseed(ng)
        if nseed > (1 << 26):
            raise ValueError("seed table would exceed the measured-free 64MB")
    if bucket is None:
        bucket = displaced_buckets_np(cpre, chi, clo, nseed)

    nslots = nslots_force or max(int(ng / load) & ~1, 64)  # even: row = slot>>1
    if nslots // 2 * (2 * cps) * 4 > t1_cap:
        raise ValueError("displaced t1 would exceed the HBM budget")
    if u2 is None:
        u2 = _mix_np(cpre, chi, clo ^ _DISP_SEED_SALT)
    if u3 is None:
        u3 = _mix_np(cpre, chi ^ np.int64(0xA5), clo ^ _DISP_SEED_SALT2)

    occupied = np.zeros(nslots, bool)
    slot_of = np.full(ng, -1, np.int64)
    seed_of = np.zeros(nseed, np.uint8)

    # CHD schedule (compress-hash-displace): place buckets in DESCENDING
    # size order — the hard (large) buckets choose seeds while the table is
    # near-empty, the plentiful 1-2 key buckets fill the gaps at high
    # occupancy where they still place easily.  A flat round-robin over all
    # buckets was measured to never converge (5% of keys still unplaced
    # after all 256 seed rounds at 20M entries).  Within a size band, round
    # r offers seed r to every still-unplaced bucket; a bucket places
    # atomically when all its keys land on free, round-unique slots.
    sizes = np.bincount(bucket, minlength=nseed)
    key_size = sizes[bucket]
    bad = np.zeros(nseed, bool)  # reused across rounds, touched-reset
    band_stragglers: list[np.ndarray] = []
    for s_band in np.unique(key_size)[::-1]:
        active = np.flatnonzero(key_size == s_band)
        for r in range(_DISP_MAX_SEEDS):
            if len(active) == 0:
                break
            slot = _disp_slot_np(u2[active], u3[active], r, nslots)
            ok_key = ~occupied[slot]
            su = np.argsort(slot, kind="stable")
            ss = slot[su]
            d = ss[1:] == ss[:-1]
            dup = np.zeros(len(ss), bool)
            dup[1:] = d
            dup[:-1] |= d
            ok_key[su[dup]] = False
            ab = bucket[active]
            bad[ab[~ok_key]] = True
            place = ~bad[ab]
            bad[ab] = False
            if place.any():
                ps = slot[place]
                occupied[ps] = True
                slot_of[active[place]] = ps
                seed_of[ab[place]] = r
                active = active[~place]
        if len(active):
            band_stragglers.append(active)
    active = (np.concatenate(band_stragglers)
              if band_stragglers else np.zeros(0, np.int64))

    # best-seed partial placement for remaining buckets, vectorized across
    # ALL straggler buckets at once (the per-bucket Python loop measured
    # minutes at 20M entries / hours at 150M).  Each pass scores every seed
    # for every remaining bucket (free slots, globally collision-free under
    # that seed), tentatively claims the best, resolves cross-bucket slot
    # conflicts by deferring the later claimant, and places the winners;
    # deferred buckets re-score against the updated occupancy next pass.
    # Any consistent (seed, slot) assignment is exact — the probe reads the
    # stored seed — so vectorization only affects spill size, which the
    # budget below still bounds.
    spill: list[np.ndarray] = []
    for _pass in range(8):
        if len(active) == 0:
            break
        order = np.argsort(bucket[active], kind="stable")
        act = active[order]
        ab = bucket[act]
        ub, binv = np.unique(ab, return_inverse=True)
        bcnt = np.bincount(binv)
        nb = len(ub)
        best_n = np.full(nb, -1, np.int64)
        best_s = np.zeros(nb, np.int64)
        u2a = u2[act]
        u3a = u3[act]
        for s in range(_DISP_MAX_SEEDS):
            sl = _disp_slot_np(u2a, u3a, s, nslots)
            ok = ~occupied[sl]
            su = np.argsort(sl, kind="stable")
            ss = sl[su]
            d = ss[1:] == ss[:-1]
            dup = np.zeros(len(ss), bool)
            dup[1:] = d
            dup[:-1] |= d
            ok[su[dup]] = False
            nok = np.bincount(binv[ok], minlength=nb)
            upd = nok > best_n
            best_n[upd] = nok[upd]
            best_s[upd] = s
            if (best_n >= bcnt).all():
                break
        # tentative placement under each bucket's best seed
        sl = _disp_slot_np(u2a, u3a, best_s[binv], nslots)
        ok = ~occupied[sl]
        su = np.argsort(sl, kind="stable")
        ss = sl[su]
        d = ss[1:] == ss[:-1]
        dup = np.zeros(len(ss), bool)
        dup[1:] = d
        dup[:-1] |= d
        clash = np.zeros(len(sl), bool)
        clash[su[dup]] = True
        # cross-bucket clash: every slot group keeps only its minimum-id
        # claimant bucket, the rest defer wholly to the next pass (the
        # globally minimum clashing bucket is owner everywhere it appears,
        # so every pass makes progress)
        defer_bucket = np.zeros(nb, bool)
        kc = np.flatnonzero(clash)
        if len(kc):
            slc = sl[kc]
            bc = binv[kc]
            o = np.lexsort((bc, slc))  # by slot, then bucket id
            slcs = slc[o]
            bcs = bc[o]
            gstart = np.ones(len(o), bool)
            gstart[1:] = slcs[1:] != slcs[:-1]
            start_pos = np.maximum.accumulate(
                np.where(gstart, np.arange(len(o)), 0))
            owner = bcs[start_pos]  # min bucket id in each slot group
            defer_bucket[bcs[bcs != owner]] = True
        keep = ~defer_bucket[binv]
        place = keep & ok & ~clash
        # within-bucket duplicates surviving on a kept bucket: place one key
        # per slot, spill the rest
        kept_clash = np.flatnonzero(keep & clash & ok)
        if len(kept_clash):
            slc = sl[kept_clash]
            o2 = np.argsort(slc, kind="stable")
            f2 = np.ones(len(o2), bool)
            f2[1:] = slc[o2[1:]] != slc[o2[:-1]]
            place[kept_clash[o2[f2]]] = True
        occupied[sl[place]] = True
        slot_of[act[place]] = sl[place]
        seed_of[ub[~defer_bucket]] = best_s[~defer_bucket]
        lost = keep & ~place
        if lost.any():
            spill.append(act[lost])
        active = act[defer_bucket[binv]]
    if len(active):  # budget check below decides if this is fatal
        spill.append(active)

    spilled = np.concatenate(spill) if spill else np.zeros(0, np.int64)
    if len(spilled) > spill_budget:
        raise ValueError(
            f"displaced spill {len(spilled)} exceeds the cached budget")

    placed = slot_of >= 0
    t1 = np.zeros((nslots // 2, 2 * cps), np.int32)
    psl = slot_of[placed]
    rows = psl >> 1
    cols = (psl & 1).astype(np.int64)
    src = np.flatnonzero(placed)
    t1[rows, cols * cps] = key_lo[src]
    t1[rows, cols * cps + 1] = key_hi[src]
    for v in range(vals.shape[1]):
        t1[rows, cols * cps + 2 + v] = vals[src, v]

    # packed-u8 seed words, little-endian nibble order matching the probe
    pad = (-len(seed_of)) % 4
    sw = np.concatenate([seed_of, np.zeros(pad, np.uint8)])
    seeds32 = sw.view("<u4").view(np.int32)
    return t1, seeds32, spilled


def build_spill_t3(spilled, key_lo, key_hi, vals, cpre, chi, clo,
                   slots3: int = 4) -> np.ndarray:
    """Cached spill-tail table for the entries the placement could not seat
    (8-row all-zero = absent; probe twin: lookup.displaced_probe_raw).

    Rows start NARROW (4 slots = 48B): the tail is probed unconditionally
    for every key, and row width dominates its cost even cache-resident —
    measured at the 150M tier: 16-slot 192B rows +8.7ns/probe, 48B rows
    +4.1ns (step_decomp4, round 3).  A narrow tail only fits a tiny spill
    (maxpos < 4 across ~100K buckets needs lambda <= ~0.1), so larger
    spills escalate a GEOMETRY ladder — wider rows under a growing byte
    cap — rather than fail: a fatter cached tail still beats losing the
    whole displaced path to the bsearch replay by ~10x."""
    cps = 2 + vals.shape[1]
    if not len(spilled):
        return np.zeros((8, slots3 * cps), np.int32)
    h3 = _mix_np(cpre[spilled], chi[spilled], clo[spilled] ^ np.int64(0x27D4EB2F))
    # the ladder's last tiers give up cache residency rather than fail: a
    # multi-million-entry spill (seen at 150M-entries-per-shard routed
    # placements, bench1200m_r5.log) lands in an HBM-resident tail — slower
    # per probe than a cached one, still ~10x better than losing the whole
    # displaced path to the bsearch replay.  Any consistent geometry is
    # exact (the probe reads the stored shape).
    for s3, cap in ((slots3, _T3_BYTE_CAP), (slots3 * 2, _T3_BYTE_CAP),
                    (slots3 * 4, 2 * _T3_BYTE_CAP), (slots3 * 8, 4 * _T3_BYTE_CAP),
                    (slots3 * 8, 64 * _T3_BYTE_CAP),
                    (slots3 * 16, 1 << 34)):
        b3 = max(16, 1 << int(np.ceil(np.log2(max(1, len(spilled) / (s3 * 0.3))))))
        while b3 * s3 * cps * 4 > cap and b3 > 16:
            b3 //= 2
        while True:
            order3, sb3, pos3 = _group_pos(h3, b3)
            if len(pos3) == 0 or int(pos3.max()) < s3:
                t3 = np.zeros((b3, s3 * cps), np.int32)
                _fill(t3, sb3, pos3, spilled[order3], key_lo, key_hi, vals)
                return t3
            b3 *= 2
            if b3 * s3 * cps * 4 > cap:
                break
    raise ValueError(
        f"displaced spill tail overflow: {len(spilled)} spilled entries "
        "could not be bucketed even HBM-resident — lower the placement "
        "lambda (more seeds), raise the load headroom, or use more shards "
        "(smaller per-shard tables spill less)")


def place_displaced(
    key_lo, key_hi, vals, cpre, chi, clo, ng, *,
    load: float = _DISP_LOAD,
    spill_budget: int = _DISP_SPILL_BUDGET,
    bucket: np.ndarray | None = None,
    nseed: int | None = None,
    t1_cap: int = _CANON_T1_CAP,
) -> DisplacedHashArrays:
    """Single-table displaced index: core placement + local spill tail."""
    t1, seeds32, spilled = place_displaced_core(
        key_lo, key_hi, vals, cpre, chi, clo, ng, load=load,
        spill_budget=spill_budget, bucket=bucket, nseed=nseed, t1_cap=t1_cap)
    t3 = build_spill_t3(spilled, key_lo, key_hi, vals, cpre, chi, clo)
    cps = 2 + vals.shape[1]
    return DisplacedHashArrays(t1=t1, seeds=seeds32, t3=t3,
                               slots3=t3.shape[1] // cps,
                               num_entries=ng, wide=vals.shape[1] == 2)


def respill_displaced_t3(t3_old: np.ndarray, wide: bool) -> np.ndarray:
    """Re-bucket a spill tail into the current row geometry (cache
    migration: tables cached with the old 16-slot 192B rows reload into
    48B rows without replaying the 30-minute placement).  Entry lanes
    reconstruct (cpre, chi, clo) exactly as _canonical_groups laid them
    out (key_hi = pre24<<8 | hi8, key_lo = suffix lo32)."""
    cps = 4 if wide else 3
    e = t3_old.reshape(-1, cps)
    live = (e[:, 2] != 0) if not wide else ((e[:, 2] | e[:, 3]) != 0)
    e = e[live]
    if not len(e):
        return np.zeros((8, 4 * cps), np.int32)
    key_lo = e[:, 0]
    key_hi = e[:, 1]
    vals = e[:, 2:]
    kh = key_hi.view(np.uint32).astype(np.int64)
    cpre = kh >> 8
    chi = kh & 0xFF
    clo = key_lo.view(np.uint32).astype(np.int64)
    idx = np.arange(len(e), dtype=np.int64)
    return build_spill_t3(idx, key_lo, key_hi, vals, cpre, chi, clo)


# ---- device tables --------------------------------------------------------

def _to_device(pairs, device) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
            for k, a in pairs}


def displaced_to_device(disp: DisplacedHashArrays, device) -> dict[str, torch.Tensor]:
    """{"d1", "ds", "d3"} int32 tensors on `device` (the JAX pytree's keys):
    d1 (nslots/2, 6 or 8), ds (nseed/4,), d3 (R3, 3*s3 or 4*s3)."""
    return _to_device((("d1", disp.t1), ("ds", disp.seeds), ("d3", disp.t3)), device)


def canonical_to_device(canon: CanonicalHashArrays, device) -> dict[str, torch.Tensor]:
    """{"c1", "c2", "c3"} int32 tensors on `device` (the JAX pytree's keys);
    an 8-row c2 or c3 is the placement's "absent" sentinel."""
    return _to_device((("c1", canon.t1), ("c2", canon.t2), ("c3", canon.t3)), device)


def hash_to_device(h: HashIndexArrays, device) -> dict[str, torch.Tensor]:
    """{"t1", "t2"} int32 tensors on `device` (the JAX pytree's keys): rows
    of `slots` (key_lo, key_hi, ix) triples, power-of-two row counts."""
    return _to_device((("t1", h.t1), ("t2", h.t2)), device)


def displaced64_to_device(disp: Displaced64Arrays, device) -> dict[str, torch.Tensor]:
    """{"d64_1", "d64_s", "d64_3"} int32 tensors on `device`: d64_1
    (nslots/2, 12), d64_s (nseed/4,) packed u8 seeds, d64_3 (R3, 6*s3)."""
    return _to_device((("d64_1", disp.t1), ("d64_s", disp.seeds),
                       ("d64_3", disp.t3)), device)


def canonical64_to_device(canon: CanonicalHash64Arrays, device) -> dict[str, torch.Tensor]:
    """{"c64_1", "c64_2", "c64_3"} int32 tensors on `device` (6-column
    slots); an 8-row c64_2 or c64_3 is the "absent" sentinel."""
    return _to_device((("c64_1", canon.t1), ("c64_2", canon.t2),
                       ("c64_3", canon.t3)), device)


def bsearch_records(index: DeviceIndexArrays) -> np.ndarray:
    """The CTR records as K7 reads them: (N+1, 4) int32 rows {suf_hi,
    suf_lo, ix, 0}, the sentinel last, 16 B each, so that a record costs one
    32 B sector where three arrays cost three."""
    rec = np.zeros((index.suf_hi.shape[0], 4), np.int32)
    rec[:, 0], rec[:, 1], rec[:, 2] = index.suf_hi, index.suf_lo.view(np.int32), index.ix
    return rec


def bsearch_to_device(index: DeviceIndexArrays, device) -> dict[str, torch.Tensor]:
    """The PACKSIZE=32 CTR records for the bsearch replay: bin_ix (2^24+1,)
    and rec (N+1, 4) (bsearch_records), whose columns suf_hi, suf_lo and ix
    (N+1,) are views, all int32; suf_lo (uint32) travels as its int32 bits
    and is compared unsigned.  K7 reads rec, the plain version the views:
    16 (N+1) bytes of records, 320 MB at 20M."""
    if index.bin_ix.dtype != np.int32:
        raise ValueError(
            f"the bsearch replay takes int32 bin offsets; this index holds "
            f"{index.num_records:,} records (int64 offsets from 2^31)")
    t = _to_device((("bin_ix", index.bin_ix), ("rec", bsearch_records(index))), device)
    rec = t["rec"]
    return {"bin_ix": t["bin_ix"], "suf_hi": rec[:, 0], "suf_lo": rec[:, 1],
            "ix": rec[:, 2], "rec": rec}
