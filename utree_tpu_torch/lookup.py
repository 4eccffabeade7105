"""Search step of the port: reads -> label ids -> histograms -> votes.

Counterpart of `utree_tpu/lookup.py`.  At PACKSIZE=32 the reads arrive
2-bit packed and probe one of four tables: the seeded-displacement table
(d1/ds/d3) or the canonical ladder (c1/c2/c3), each with narrow (u16-packed,
3-column slots) or wide (IXTYPE=u32, 4-column slots) entries (wide when
num_labels >= 0xFFFF, as in JAX), the legacy two-table hash (t1/t2, one
int32 id a slot, forward and RC words probed apart), or the sorted CTR
records themselves (bin_ix/suf_hi/suf_lo/ix), searched by the literal
xtSuffixBS replay.  At
PACKSIZE=64 the reads arrive as ASCII and probe the 64-mer ladder
(c64_1/2/3) or the 64-mer displaced table (d64_1/d64_s/d64_3), whose slots
are 6 columns wide at any label width.  `search_step` takes ASCII reads at
either k (the sharded steps of `parallel/sharded.py` use it at k=32).
Each device function has a plain
PyTorch version that mirrors the JAX code step for step on int64 lanes
masked to 32 bits (see `_u32`), and a wrapper:

  window_ids          -> K1 `csrc/scan_probe.cu`    (d1: scan_probe[_wide])
                         K4 `csrc/ladder_probe.cu`  (c1: ladder_probe[_wide])
                         K7 `csrc/bsearch_probe.cu` (bin_ix + rec: bsearch_probe)
                         K10 `csrc/hash_probe.cu`   (t1: hash_probe)
                         (plain: window_ids_plain)
  ascii_pack          -> K14 `csrc/ascii_pack.cu`    (plain: ascii_pack_plain)
  search_step         -> K14, then window_ids (k=32, trimmed to JAX's width)
                         or window_ids64 (k=64)       (plain: the JAX twins)
  window_ids64        -> K5 `csrc/scan_probe64.cu`   (d64_1: scan_probe64)
                         K6 `csrc/ladder_probe64.cu` (c64_1: ladder_probe64)
                         (plain: window_ids64_plain)
  histogram           -> K2 `csrc/histogram.cu`    (plain: compact_histogram)
  histogram_packed    -> K2, (B, cap+1) rows       (plain: pack_hist)
  histogram_unpacked  -> K2, (B, 2*cap+2) rows     (plain: unpacked_hist)
  hist_compact        -> K8 `csrc/hist_compact.cu` (plain: compact_rows)

A wrapper takes the plain version only for tensors on the CPU.  For a CUDA
tensor it launches the kernel or raises; nothing falls back.
"""

from __future__ import annotations

import numpy as np
import torch

from utree_tpu_torch import kernels
from utree_tpu_torch._u32 import M, i32, jax_index, mul32, u32
from utree_tpu_torch.classify_device import vote_rows

DINVALID = 4
WIDE_LABELS = 0xFFFF  # num_labels from which entries are wide (IXTYPE=u32)
_M1, _M2, _M3 = 0x9E3779B1, 0x85EBCA6B, 0xC2B2AE35


# ---- windows and keys ------------------------------------------------------

def base_codes_packed(packed: torch.Tensor, vbits: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """(B, L/4) u8 packed bases (4/byte, MSB-first) + (B, L/8) u8 validity
    bits -> (B, L) int64 codes, DINVALID where invalid or past the length."""
    b, l4 = packed.shape
    l = l4 * 4
    pos = torch.arange(l, device=packed.device)
    rep = packed.to(torch.int64).repeat_interleave(4, dim=1)
    codes = (rep >> (2 * (3 - (pos & 3)))) & 3
    vrep = vbits.to(torch.int64).repeat_interleave(8, dim=1)[:, :l]
    ok = ((vrep >> (7 - (pos & 7))) & 1) == 1
    ok &= pos < lengths.to(torch.int64)[:, None]
    return torch.where(ok, codes, DINVALID)


def extract_windows(codes: torch.Tensor, k: int = 32):
    """Slide 32-mers over (B, T) codes -> (qpre, qhi, qlo, valid), each
    (B, T-31); lanes are int64 holding prefix24 / hi8 / lo32."""
    if k != 32:
        raise NotImplementedError("extract_windows implements the 32-mer geometry")
    b, t = codes.shape
    w = t - k + 1
    if w <= 0:
        raise ValueError("reads shorter than k after padding")
    z = torch.zeros((b, w), dtype=torch.int64, device=codes.device)
    qpre, qhi, qlo = z.clone(), z.clone(), z.clone()
    valid = torch.ones((b, w), dtype=torch.bool, device=codes.device)
    for j in range(k):
        c = codes[:, j:j + w]
        valid &= c <= 3
        cc = torch.where(c <= 3, c, 0)
        if j < 12:
            qpre |= cc << (2 * (11 - j))
        elif j < 16:
            qhi |= cc << (2 * (15 - j))
        else:
            qlo |= cc << (2 * (31 - j))
    return qpre, qhi, qlo, valid


def rev2_32(x: torch.Tensor) -> torch.Tensor:
    """Reverse the 2-bit groups of a u32 lane (base order reversal)."""
    x = x & M
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) | (x >> 16)) & M


def rc_word_lanes(qpre, qhi, qlo):
    """Reverse complement of 32-mer words on their (pre24, hi8, lo32) lanes."""
    rc_pre = rev2_32(~qlo & 0x00FFFFFF) >> 8
    rc_hi = rev2_32(~qlo & 0xFF000000) & 0xFF
    fwd_top = (qpre << 8) | qhi
    rc_lo = rev2_32(~fwd_top & M)
    return rc_pre, rc_hi, rc_lo


def mix(pre, hi, lo):
    """Twin of `_mix_jnp` / `hash_index._mix_np` on u32 lanes."""
    h = mul32(pre & M, _M1)
    h = h ^ (lo ^ (lo >> 16))
    h = mul32(h, _M2)
    h = h ^ (h >> 13)
    h = (h + mul32(hi & M, _M3)) & M
    h = h ^ (h >> 16)
    h = mul32(h, _M1)
    return h ^ (h >> 15)


def canonical_keys(qpre, qhi, qlo):
    """Forward lanes -> (key_lo, key_hi, fwd_le): u32 lanes of
    c = min(word, rc(word)) and whether the forward word is the minimum."""
    fwd_hi32 = (qpre << 8) | qhi
    rpre, rhi, rlo = rc_word_lanes(qpre, qhi, qlo)
    rc_hi32 = (rpre << 8) | rhi
    fwd_le = (fwd_hi32 < rc_hi32) | ((fwd_hi32 == rc_hi32) & (qlo <= rlo))
    return (torch.where(fwd_le, qlo, rlo), torch.where(fwd_le, fwd_hi32, rc_hi32),
            fwd_le)


# ---- table probes ----------------------------------------------------------

def _split(key_lo, key_hi):
    return key_hi >> 8, key_hi & 0xFF, key_lo


def _fold(key_lo, key_hi):
    """The folded two-mix hash of the first-level tables (c1 bucket, d1 seed)."""
    c_pre, c_hi8, c_lo = _split(key_lo, key_hi)
    h1 = mix(c_pre, c_hi8, c_lo)
    hb = mix(c_pre, c_hi8, c_lo ^ 0x6A09E667)
    return h1 ^ (((hb << 15) | (hb >> 17)) & M)


def displaced_bucket(key_lo, key_hi, valid, nseed: int):
    return torch.where(valid, _fold(key_lo, key_hi) & (nseed - 1), 0)


def displaced_seed(seeds: torch.Tensor, bkt: torch.Tensor):
    word = u32(seeds[jax_index(bkt >> 2, seeds.shape[0])])
    return (word >> ((bkt & 3) << 3)) & 0xFF


def displaced_slot(key_lo, key_hi, seed, valid, nslots: int):
    c_pre, c_hi8, c_lo = _split(key_lo, key_hi)
    u2 = mix(c_pre, c_hi8, c_lo ^ 0x94D049BB)
    ub = mix(c_pre, c_hi8 ^ 0xA5, c_lo ^ 0x7FEB352D)
    h = (mul32(u2 ^ mul32(seed, 0x85EBCA6B), 0xC2B2AE35)
         ^ mul32(ub ^ mul32(seed, 0xC2B2AE35), 0x85EBCA6B))
    return torch.where(valid, h % nslots, 0)


def canonical_buckets(key_lo, key_hi, valid, b1: int, b2: int):
    """c1 and c2 bucket ids; invalid windows probe bucket 0."""
    c_pre, c_hi8, c_lo = _split(key_lo, key_hi)
    bkt1 = torch.where(valid, _fold(key_lo, key_hi) & (b1 - 1), 0)
    h2 = mix(c_pre, c_hi8, c_lo ^ 0x5BD1E995)
    return bkt1, torch.where(valid, h2 & (b2 - 1), 0)


def canonical_bucket3(key_lo, key_hi, valid, b3: int):
    c_pre, c_hi8, c_lo = _split(key_lo, key_hi)
    h3 = mix(c_pre, c_hi8, c_lo ^ 0x27D4EB2F)
    return torch.where(valid, h3 & (b3 - 1), 0)


def probe_rows(rows: torch.Tensor, key_lo, key_hi, nslots: int) -> torch.Tensor:
    """Slot compare over gathered rows (..., nslots*3) int32: the matching
    entry's packed dual value (int32), 0 = no entry.  A later slot wins."""
    klo, khi = i32(key_lo), i32(key_hi)
    val = torch.zeros(klo.shape, dtype=torch.int32, device=rows.device)
    for s in range(nslots):
        v = rows[..., s * 3 + 2]
        m = (rows[..., s * 3] == klo) & (rows[..., s * 3 + 1] == khi) & (v != 0)
        val = torch.where(m, v, val)
    return val


def probe_rows_wide(rows: torch.Tensor, key_lo, key_hi, nslots: int):
    """Wide (4-column slot) probe_rows: the matching entry's (va, vb) int32
    raw values (label id + 1; 0 = that orientation misses, or no entry)."""
    klo, khi = i32(key_lo), i32(key_hi)
    va = torch.zeros(klo.shape, dtype=torch.int32, device=rows.device)
    vb = torch.zeros_like(va)
    for s in range(nslots):
        a, b = rows[..., s * 4 + 2], rows[..., s * 4 + 3]
        m = (rows[..., s * 4] == klo) & (rows[..., s * 4 + 1] == khi) & ((a | b) != 0)
        va = torch.where(m, a, va)
        vb = torch.where(m, b, vb)
    return va, vb


def _first_hit_wide(va, vb, nxt):
    """Keep (va, vb) where it holds an entry, else take the next level's."""
    miss = (va | vb) == 0
    return torch.where(miss, nxt[0], va), torch.where(miss, nxt[1], vb)


def displaced_probe_raw(tables: dict, key_lo, key_hi, valid, *, wide: bool):
    """Seed read -> one 2-slot d1 row -> d3 tail: the raw packed value
    (narrow) or the (va, vb) pair (wide); 0 = miss."""
    t1, seeds, t3 = tables["d1"], tables["ds"], tables.get("d3")
    cps = 4 if wide else 3
    if t1.shape[1] != 2 * cps:
        raise ValueError("displaced t1 must have 2-slot rows")
    nslots = 2 * t1.shape[0]
    nseed = 4 * seeds.shape[0]
    bkt = displaced_bucket(key_lo, key_hi, valid, nseed)
    seed = displaced_seed(seeds, bkt)
    slot = displaced_slot(key_lo, key_hi, seed, valid, nslots)
    rows = t1[slot >> 1]
    tail = t3 is not None and t3.shape[0] > 8
    if wide:
        va, vb = probe_rows_wide(rows, key_lo, key_hi, 2)
        if tail:
            bkt3 = canonical_bucket3(key_lo, key_hi, valid, t3.shape[0])
            va, vb = _first_hit_wide(va, vb, probe_rows_wide(
                t3[bkt3], key_lo, key_hi, t3.shape[1] // cps))
        return va, vb
    val = probe_rows(rows, key_lo, key_hi, 2)
    if tail:
        bkt3 = canonical_bucket3(key_lo, key_hi, valid, t3.shape[0])
        val = torch.where(val != 0, val,
                          probe_rows(t3[bkt3], key_lo, key_hi, t3.shape[1] // 3))
    return val


def decode_canonical_vals(val, valid, fwd_le, bad_ix: int, do_rc: bool):
    """Packed dual value -> label ids (int32); a miss or invalid -> bad_ix."""
    vu = u32(val)
    va = (vu & 0xFFFF) - 1
    vb = (vu >> 16) - 1
    if do_rc:
        return (torch.where(valid & (va >= 0), va, bad_ix).to(torch.int32),
                torch.where(valid & (vb >= 0), vb, bad_ix).to(torch.int32))
    fwd = torch.where(fwd_le, va, vb)
    return torch.where(valid & (fwd >= 0), fwd, bad_ix).to(torch.int32)


def decode_canonical_wide(va, vb, valid, fwd_le, bad_ix: int, do_rc: bool):
    """(va, vb) raw wide values -> label ids (int32, up to 2^31-2); int32
    arithmetic, as JAX's."""
    ia, ib = va - 1, vb - 1
    if do_rc:
        return (torch.where(valid & (ia >= 0), ia, bad_ix).to(torch.int32),
                torch.where(valid & (ib >= 0), ib, bad_ix).to(torch.int32))
    fwd = torch.where(fwd_le, ia, ib)
    return torch.where(valid & (fwd >= 0), fwd, bad_ix).to(torch.int32)


def lookup_kmers_displaced(tables: dict, qpre, qhi, qlo, valid, *,
                           bad_ix: int, do_rc: bool, wide: bool = False):
    key_lo, key_hi, fwd_le = canonical_keys(qpre, qhi, qlo)
    r = displaced_probe_raw(tables, key_lo, key_hi, valid, wide=wide)
    if wide:
        return decode_canonical_wide(r[0], r[1], valid, fwd_le, bad_ix, do_rc)
    return decode_canonical_vals(r, valid, fwd_le, bad_ix, do_rc)


def lookup_kmers_canonical(tables: dict, qpre, qhi, qlo, valid, *,
                           slots: int, slots2: int, bad_ix: int, do_rc: bool,
                           wide: bool = False):
    """The canonical ladder: c1 row, then the c2 spill row and the c3 tail
    where the earlier levels hold no entry.  A level of 8 rows is the
    placement's "absent" sentinel and is not probed."""
    t1, t2, t3 = tables["c1"], tables["c2"], tables.get("c3")
    b1, b2 = t1.shape[0], t2.shape[0]
    cps = 4 if wide else 3
    if t1.shape[1] != slots * cps or t2.shape[1] != slots2 * cps:
        raise ValueError("slot count does not match table geometry")
    key_lo, key_hi, fwd_le = canonical_keys(qpre, qhi, qlo)
    bkt1, bkt2 = canonical_buckets(key_lo, key_hi, valid, b1, b2)
    tail = t3 is not None and t3.shape[0] > 8
    if wide:
        va, vb = probe_rows_wide(t1[bkt1], key_lo, key_hi, slots)
        if b2 > 8:
            va, vb = _first_hit_wide(va, vb, probe_rows_wide(
                t2[bkt2], key_lo, key_hi, slots2))
        if tail:
            bkt3 = canonical_bucket3(key_lo, key_hi, valid, t3.shape[0])
            va, vb = _first_hit_wide(va, vb, probe_rows_wide(
                t3[bkt3], key_lo, key_hi, t3.shape[1] // cps))
        return decode_canonical_wide(va, vb, valid, fwd_le, bad_ix, do_rc)
    val = probe_rows(t1[bkt1], key_lo, key_hi, slots)
    if b2 > 8:
        val = torch.where(val != 0, val, probe_rows(t2[bkt2], key_lo, key_hi, slots2))
    if tail:
        bkt3 = canonical_bucket3(key_lo, key_hi, valid, t3.shape[0])
        val = torch.where(val != 0, val,
                          probe_rows(t3[bkt3], key_lo, key_hi, t3.shape[1] // 3))
    return decode_canonical_vals(val, valid, fwd_le, bad_ix, do_rc)


def _canonical_family_ix(table: dict, qpre, qhi, qlo, valid, *,
                         bad_ix: int, do_rc: bool, num_labels: int):
    """Dispatch on the table ('c1' ladder / 'd1' displaced) and the entry
    width to per-window ids; concatenates the RC lanes."""
    wide = num_labels >= WIDE_LABELS
    cps = 4 if wide else 3
    if "d1" in table:
        r = lookup_kmers_displaced(table, qpre, qhi, qlo, valid,
                                   bad_ix=bad_ix, do_rc=do_rc, wide=wide)
    else:
        r = lookup_kmers_canonical(table, qpre, qhi, qlo, valid,
                                   slots=table["c1"].shape[1] // cps,
                                   slots2=table["c2"].shape[1] // cps,
                                   bad_ix=bad_ix, do_rc=do_rc, wide=wide)
    return torch.cat(r, dim=1) if do_rc else r


# ---- the bsearch replay (xtSuffixBS over the CTR records) -------------------

def _suffix_le(hi_a, lo_a, hi_b, lo_b):
    """(hi_a, lo_a) <= (hi_b, lo_b) on 40-bit suffix lanes; the lo lanes are
    u32 lanes (int64 in [0, 2^32)), so the comparison is unsigned."""
    return (hi_a < hi_b) | ((hi_a == hi_b) & (lo_a <= lo_b))


def lookup_kmers(table: dict, qpre, qhi, qlo, valid, probe_iters: int,
                 bad_ix: int) -> torch.Tensor:
    """Plain version of K7's replay: the batched XT_getIX32 (itree.c:720-730)
    over {bin_ix, suf_hi, suf_lo, ix} (suf_lo as its int32 bits), with JAX's
    fixed `probe_iters` trip count.  Returns int32 ids, bad_ix on a miss."""
    bin_ix, ix_arr = table["bin_ix"], table["ix"]
    suf_hi, suf_lo = table["suf_hi"].to(torch.int64), u32(table["suf_lo"])
    pre = torch.where(valid, qpre, 0)
    start = bin_ix[pre].to(torch.int64)
    end = bin_ix[pre + 1].to(torch.int64)
    empty = start >= end
    p = bsearch_descend(suf_hi, suf_lo, empty, start, end, qhi, qlo, probe_iters)
    found = (~empty) & valid & (suf_hi[p] == qhi) & (suf_lo[p] == qlo)
    return torch.where(found, ix_arr[p], bad_ix).to(torch.int32)


def bsearch_descend(suf_hi, suf_lo, empty, start, end, qhi, qlo, probe_iters: int):
    """The replay's `probe_iters` halvings of each lane's bin [start, end)
    (an empty lane stays at 0): the record it ends on, clamped to the last
    one (n = the sentinel or last padding record).  suf_hi int64, suf_lo a
    u32 lane."""
    n = suf_hi.shape[0] - 1
    p = torch.where(empty, 0, start)
    size = torch.where(empty, 0, end - start - 1)
    for _ in range(probe_iters):
        active = size > 0
        w = size >> 1
        probe = torch.clamp(p + w + 1, max=n)
        le = active & _suffix_le(suf_hi[probe], suf_lo[probe], qhi, qlo)
        p = torch.where(le, p + w + 1, p)
        size = torch.where(active, torch.where(le, size - w - 1, w), size)
    return torch.clamp(p, max=n)


def _with_rc_words(qpre, qhi, qlo, valid, do_rc: bool):
    """With RC the arithmetic RC words follow the forward words ([fwd |
    rc]), as window_lanes and _packed_window_ix's non-canonical branch
    append them; each is probed alone."""
    if do_rc:
        rpre, rhi, rlo = rc_word_lanes(qpre, qhi, qlo)
        qpre, qhi = torch.cat([qpre, rpre], dim=1), torch.cat([qhi, rhi], dim=1)
        qlo, valid = torch.cat([qlo, rlo], dim=1), torch.cat([valid, valid], dim=1)
    return qpre, qhi, qlo, valid


def _bsearch_ix(table: dict, qpre, qhi, qlo, valid, *, do_rc: bool,
                probe_iters: int | None, bad_ix: int):
    if probe_iters is None:
        raise ValueError("the bsearch replay needs probe_iters")
    return lookup_kmers(table, *_with_rc_words(qpre, qhi, qlo, valid, do_rc),
                        probe_iters, bad_ix)


# ---- the legacy two-table hash (t1/t2) -----------------------------------------

def lookup_kmers_hash(tables: dict, qpre, qhi, qlo, valid, *, slots: int,
                      bad_ix: int) -> torch.Tensor:
    """Plain version of K10: one t1 row and one t2 row per word, keyed on
    the forward word's int32 bits.  A slot matches on both key words and
    ix >= 0, a later slot wins, a t1 match wins over t2; a miss or an
    invalid window gives bad_ix (int32; bad_ix 2^32-1 wraps to -1)."""
    t1, t2 = tables["t1"], tables["t2"]
    b1, b2 = t1.shape[0], t2.shape[0]
    key_lo, key_hi = i32(qlo), i32((qpre << 8) | qhi)

    def probe(table, bucket):
        rows = table[bucket]
        ix = torch.zeros(bucket.shape, dtype=torch.int32, device=rows.device)
        found = torch.zeros(bucket.shape, dtype=torch.bool, device=rows.device)
        for s in range(slots):
            v = rows[..., s * 3 + 2]
            m = (rows[..., s * 3] == key_lo) & (rows[..., s * 3 + 1] == key_hi) & (v >= 0)
            ix = torch.where(m, v, ix)
            found |= m
        return found, ix

    # invalid windows probe bucket 0, as JAX's do
    f1, ix1 = probe(t1, torch.where(valid, mix(qpre, qhi, qlo) & (b1 - 1), 0))
    h2 = mix(qpre, qhi, qlo ^ 0x5BD1E995)
    f2, ix2 = probe(t2, torch.where(valid, h2 & (b2 - 1), 0))
    out = torch.where(f1, ix1.to(torch.int64), torch.where(f2, ix2.to(torch.int64), bad_ix))
    return i32(torch.where(valid, out, bad_ix))


def _hash_ix(tables: dict, qpre, qhi, qlo, valid, *, do_rc: bool, bad_ix: int):
    return lookup_kmers_hash(tables, *_with_rc_words(qpre, qhi, qlo, valid, do_rc),
                             slots=8, bad_ix=bad_ix)


def _trim(packed, vbits, true_len):
    if true_len is not None and true_len < packed.shape[1] * 4:
        return packed[:, : true_len // 4], vbits[:, : true_len // 8]
    return packed, vbits


def window_ids_plain(tables: dict, packed, vbits, lengths, *, do_rc: bool,
                     bad_ix: int, num_labels: int, true_len: int | None = None,
                     probe_iters: int | None = None) -> torch.Tensor:
    """Plain version of K1, K4, K7 and K10 (`_packed_window_ix`): packed
    reads -> (B, 2W) ids with RC ([ix_a | ix_b] on the canonical tables,
    [fwd | rc] on the legacy hash and on the bsearch replay, which needs
    `probe_iters`), else (B, W)."""
    packed, vbits = _trim(packed, vbits, true_len)
    codes = base_codes_packed(packed, vbits, lengths)
    qpre, qhi, qlo, valid = extract_windows(codes)
    if "t1" in tables:
        return _hash_ix(tables, qpre, qhi, qlo, valid, do_rc=do_rc, bad_ix=bad_ix)
    if "bin_ix" in tables:
        return _bsearch_ix(tables, qpre, qhi, qlo, valid, do_rc=do_rc,
                           probe_iters=probe_iters, bad_ix=bad_ix)
    return _canonical_family_ix(tables, qpre, qhi, qlo, valid, bad_ix=bad_ix,
                                do_rc=do_rc, num_labels=num_labels)


def _level(t: torch.Tensor, name: str, cps: int, dev):
    """(tensor, rows, slots) of one table level, checked for the kernels."""
    kernels.require(t, name, torch.int32, 2, dev)
    if t.shape[0] < 1 or t.shape[1] % cps:
        raise ValueError(f"{name} {tuple(t.shape)} is no table of {cps}-column slots")
    return t, t.shape[0], t.shape[1] // cps


def _row_aligned(t: torch.Tensor, name: str, align: int) -> None:
    """K1, K4, K12 and K17 load a two-slot row as three 8 B (narrow) or two
    16 B (wide) vector loads, K5 and K6 their 64-mer rows as 16 B loads:
    the table must start on that boundary."""
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align} B aligned for its vector row loads")


def _records(tables: dict, who: str, dev):
    """(bin_ix, rec, n) of the records that K7 and K15 read: rec is
    (n + 1, 4) int32 {suf_hi, suf_lo, ix, 0} (`hash_index.records`), one
    row for each of suf_hi's n + 1 (the arrays the plain versions read), 16 B
    aligned, n < 2^31 - 1."""
    bin_ix, rec = tables["bin_ix"], tables.get("rec")
    if rec is None:
        raise ValueError(f"{who} reads the records as 'rec' (n + 1, 4) "
                         "(hash_index.records_to_device places it)")
    kernels.require(bin_ix, "bin_ix", torch.int32, 1, dev)
    kernels.require(rec, "rec", torch.int32, 2, dev)
    n = tables["suf_hi"].shape[0] - 1
    if tuple(rec.shape) != (n + 1, 4) or n < 0 or n >= 0x7FFFFFFF:
        raise ValueError("rec must be (n + 1, 4) int32 records {suf_hi, suf_lo, "
                         "ix, 0}, the padding or sentinel last, n < 2^31 - 1")
    _row_aligned(rec, "rec", 16)
    return bin_ix, rec, n


def window_ids(tables: dict, packed, vbits, lengths, *, do_rc: bool,
               bad_ix: int, num_labels: int, true_len: int | None = None,
               probe_iters: int | None = None) -> torch.Tensor:
    """On CUDA tensors K1 `scan_probe[_wide]` (displaced table, 'd1'), K4
    `ladder_probe[_wide]` (ladder, 'c1'), K7 `bsearch_probe` (the CTR
    records: 'bin_ix' and 'rec', whose columns are suf_hi, suf_lo, ix) or
    K10 `hash_probe` (the legacy hash, 't1', whose full int32 ids serve
    narrow and wide labels alike); the plain version on CPU tensors.  K7 loops
    until every search range is empty, so it needs no `probe_iters`.  K1's
    d1 and a two-slot c1 must be 8 B aligned (narrow) or 16 B (wide), K7's
    rec 16 B."""
    if packed.device.type == "cpu":
        return window_ids_plain(tables, packed, vbits, lengths, do_rc=do_rc,
                                bad_ix=bad_ix, num_labels=num_labels,
                                true_len=true_len, probe_iters=probe_iters)
    dev = packed.device
    wide = num_labels >= WIDE_LABELS
    cps = 4 if wide else 3
    kernels.require(packed, "packed", torch.uint8, 2, dev)
    kernels.require(vbits, "vbits", torch.uint8, 2, dev)
    kernels.require(lengths, "lengths", torch.int32, 1, dev)
    b, row4 = packed.shape
    row8 = vbits.shape[1]
    if lengths.shape[0] != b or vbits.shape[0] != b or row8 * 2 != row4:
        raise ValueError("packed/vbits/lengths shapes disagree")
    t = row4 * 4 if true_len is None else min(true_len, row4 * 4)
    w = t - 31
    if w <= 0:
        raise ValueError("reads shorter than k after padding")
    out = torch.empty((b, 2 * w if do_rc else w), dtype=torch.int32, device=dev)
    front = (packed.data_ptr(), vbits.data_ptr(), lengths.data_ptr(), b, row4,
             row8, w)
    back = (int(do_rc), bad_ix, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    suffix = "_wide" if wide else ""
    if "bin_ix" in tables:
        bin_ix, rec, n = _records(tables, "K7", dev)
        if bin_ix.shape[0] != (1 << 24) + 1:
            raise ValueError("bin_ix must have 2^24+1 entries")
        kernels.launch("bsearch_probe", *front, bin_ix.data_ptr(), rec.data_ptr(), n,
                       *back)
    elif "t1" in tables:
        levels = [_level(tables[k], k, 3, dev) for k in ("t1", "t2")]
        if any(s != 8 or n & (n - 1) or tt.data_ptr() % 16 for tt, n, s in levels):
            raise ValueError("hash tables must have 8-slot rows (24 columns), "
                             "power-of-two row counts and 16 B alignment")
        kernels.launch("hash_probe", *front,
                       *(x for tt, n, _ in levels for x in (tt.data_ptr(), n)), *back)
    elif "d1" in tables:
        t1, _, _ = _level(tables["d1"], "d1", cps, dev)
        t3, n3, s3 = _level(tables["d3"], "d3", cps, dev)
        seeds = tables["ds"]
        kernels.require(seeds, "ds", torch.int32, 1, dev)
        nseed = 4 * seeds.shape[0]
        if t1.shape[1] != 2 * cps:
            raise ValueError("displaced t1 must have 2-slot rows")
        _row_aligned(t1, "d1", 16 if wide else 8)
        if nseed & (nseed - 1) or n3 & (n3 - 1):
            raise ValueError("seed table and d3 must have power-of-two sizes")
        kernels.launch("scan_probe" + suffix, *front, t1.data_ptr(), 2 * t1.shape[0],
                       seeds.data_ptr(), nseed, t3.data_ptr(), n3, s3, *back)
    else:
        levels = [_level(tables[k], k, cps, dev) for k in ("c1", "c2", "c3")]
        if any(n & (n - 1) for _, n, _ in levels):
            raise ValueError("ladder levels must have power-of-two row counts")
        if levels[0][2] == 2:
            _row_aligned(levels[0][0], "c1", 16 if wide else 8)
        kernels.launch("ladder_probe" + suffix, *front,
                       *(x for tt, n, s in levels for x in (tt.data_ptr(), n, s)),
                       *back)
    return out


# ---- histograms ------------------------------------------------------------

def compact_histogram(ix_mat: torch.Tensor, num_labels: int, cap: int):
    """Plain version of K2: per read, up to `cap` unique hit ids ascending
    (-1 pads), their counts, the true unique count (cap+1 = overflow) and
    the total hits; all int32."""
    b = ix_mat.shape[0]
    big = 0x7FFFFFFF
    ix = ix_mat.to(torch.int64)
    hit = ix < num_labels
    found = hit.sum(dim=1)
    key = torch.where(hit, ix, big)
    cur = torch.full((b, 1), -1, dtype=torch.int64, device=ix.device)
    labels, counts = [], []
    for _ in range(cap):
        cand = torch.where(key > cur, key, big)
        m = cand.min(dim=1, keepdim=True).values
        cnt = (key == m).sum(dim=1)
        some = m[:, 0] < big
        labels.append(torch.where(some, m[:, 0], -1))
        counts.append(torch.where(some, cnt, 0))
        cur = m
    labels = torch.stack(labels, dim=1)
    counts = torch.stack(counts, dim=1)
    used = (labels >= 0).sum(dim=1)
    overflow = (torch.where(key > cur, key, big) < big).any(dim=1)
    nuniq = torch.where(overflow, cap + 1, used)
    i = torch.int32
    return labels.to(i), counts.to(i), nuniq.to(i), found.to(i)


def pack_hist(ix: torch.Tensor, num_labels: int, cap: int) -> torch.Tensor:
    """Plain version of K2 `histogram_packed`: (B, cap+1) int32 rows, col
    j<cap = (label+1) | count<<16 (a -1 pad packs to 0), col cap = nuniq |
    found<<5; the int32 bits of JAX's wrapping int32 arithmetic."""
    labels, counts, nuniq, found = (x.to(torch.int64) for x in
                                    compact_histogram(ix, num_labels, cap))
    lc = (labels + 1) | (counts << 16)
    tail = nuniq | (found << 5)
    return i32(torch.cat([lc, tail[:, None]], dim=1))


def unpacked_hist(ix: torch.Tensor, num_labels: int, cap: int) -> torch.Tensor:
    """Plain version of K2 `histogram_unpacked`: (B, 2*cap+2) int32 rows
    [labels | counts | nuniq | found] (search_step_hist_packed_in's layout)."""
    labels, counts, nuniq, found = compact_histogram(ix, num_labels, cap)
    return torch.cat([labels, counts, nuniq[:, None], found[:, None]], dim=1)


def _check_hist(ids: torch.Tensor, cap: int):
    kernels.require(ids, "ids", torch.int32, 2, ids.device)
    if not 1 <= cap <= 30:
        raise ValueError(f"cap={cap} out of range 1..30")
    return ids.shape


def histogram(ids: torch.Tensor, num_labels: int, cap: int):
    """K2 `histogram` on CUDA tensors; the plain version on CPU tensors."""
    if ids.device.type == "cpu":
        return compact_histogram(ids, num_labels, cap)
    b, n = _check_hist(ids, cap)
    dev = ids.device
    labels = torch.empty((b, cap), dtype=torch.int32, device=dev)
    counts = torch.empty((b, cap), dtype=torch.int32, device=dev)
    nuniq = torch.empty(b, dtype=torch.int32, device=dev)
    found = torch.empty(b, dtype=torch.int32, device=dev)
    kernels.launch("histogram", ids.data_ptr(), b, n, num_labels, cap,
                   labels.data_ptr(), counts.data_ptr(), nuniq.data_ptr(),
                   found.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return labels, counts, nuniq, found


def _hist_rows(name: str, ids: torch.Tensor, num_labels: int, cap: int,
               width: int) -> torch.Tensor:
    b, n = _check_hist(ids, cap)
    rows = torch.empty((b, width), dtype=torch.int32, device=ids.device)
    kernels.launch(name, ids.data_ptr(), b, n, num_labels, cap, rows.data_ptr(),
                   torch.cuda.current_stream(ids.device).cuda_stream)
    return rows


def histogram_packed(ids: torch.Tensor, num_labels: int, cap: int) -> torch.Tensor:
    """K2 `histogram_packed` on CUDA tensors; `pack_hist` on CPU tensors."""
    if ids.device.type == "cpu":
        return pack_hist(ids, num_labels, cap)
    return _hist_rows("histogram_packed", ids, num_labels, cap, cap + 1)


def histogram_unpacked(ids: torch.Tensor, num_labels: int, cap: int) -> torch.Tensor:
    """K2 `histogram_unpacked` on CUDA tensors; `unpacked_hist` on CPU ones."""
    if ids.device.type == "cpu":
        return unpacked_hist(ids, num_labels, cap)
    return _hist_rows("histogram_unpacked", ids, num_labels, cap, 2 * cap + 2)


def compact_rows(rows: torch.Tensor, over_cap: int) -> torch.Tensor:
    """Plain version of K8: the epilogue of `search_step_hist_compact`
    (utree_tpu/lookup.py:751-766) over (B, cap+1) `pack_hist` rows.
    Returns one flat int32 vector of 2B + (over_cap+1)*(cap+1) entries: per
    read (tail, lc0), then an (over_cap+1, cap+1) block whose [0, 0] is
    n_over, the true count of reads with nuniq >= 2, and whose rows
    1..min(n_over, over_cap) are (read_id, lc[0..cap-1]) of those reads in
    read order; rows past over_cap are dropped."""
    b, c1 = rows.shape
    dev = rows.device
    lc, tail = rows[:, :c1 - 1], rows[:, c1 - 1]
    main = torch.stack([tail, lc[:, 0]], dim=1)
    flag = (tail & 31) >= 2  # includes the cap+1 overflow sentinel
    pos = torch.cumsum(flag.to(torch.int64), 0) - 1
    dest = torch.where(flag & (pos < over_cap), pos + 1, over_cap + 1)
    full = torch.cat([torch.arange(b, dtype=torch.int32, device=dev)[:, None], lc], dim=1)
    over = torch.zeros((over_cap + 1, c1), dtype=torch.int32, device=dev)
    keep = dest <= over_cap  # JAX's scatter with mode="drop"
    over[dest[keep]] = full[keep]
    over[0, 0] = flag.sum().to(torch.int32)
    return torch.cat([main.reshape(-1), over.reshape(-1)])


def hist_compact(rows: torch.Tensor, over_cap: int) -> torch.Tensor:
    """K8 `hist_compact` on CUDA tensors; `compact_rows` on CPU tensors."""
    if rows.device.type == "cpu":
        return compact_rows(rows, over_cap)
    dev = rows.device
    kernels.require(rows, "rows", torch.int32, 2, dev)
    b, c1 = rows.shape
    if not 2 <= c1 <= 31 or over_cap < 1:
        raise ValueError(f"hist_compact: cap {c1 - 1} or over_cap {over_cap} out of range")
    out = torch.empty(2 * b + (over_cap + 1) * c1, dtype=torch.int32, device=dev)
    tile_counts = torch.empty(max(1, -(-b // 1024)), dtype=torch.int32, device=dev)
    kernels.launch("hist_compact", rows.data_ptr(), b, c1 - 1, over_cap,
                   tile_counts.data_ptr(), out.data_ptr(),
                   torch.cuda.current_stream(dev).cuda_stream)
    return out


# ---- the device steps --------------------------------------------------------
# `table` holds d1/ds/d3, c1/c2/c3, t1/t2 or bin_ix/suf_hi/suf_lo/ix/rec (and,
# for the vote, the vote tables under `vt_*` keys); `probe_iters` is read by
# the bsearch replay's plain version only.

def search_step_vote_compact(table: dict, packed, vbits, lengths, *,
                             do_rc: bool, bad_ix: int, num_labels: int,
                             cap: int, taxacut: int, max_iters: int,
                             true_len: int | None = None,
                             probe_iters: int | None = None) -> torch.Tensor:
    """Packed reads -> (B, 3) int32 vote rows (w0, w1, w2; layout in
    `classify_device.pack_vote`): probe, K2 histogram, K3 vote."""
    vote_tab = {k[3:]: v for k, v in table.items() if k.startswith("vt_")}
    ids = window_ids(table, packed, vbits, lengths, do_rc=do_rc, bad_ix=bad_ix,
                     num_labels=num_labels, true_len=true_len,
                     probe_iters=probe_iters)
    labels, counts, nuniq, found = histogram(ids, num_labels, cap)
    return vote_rows(vote_tab, labels, counts, nuniq, found,
                     taxacut=taxacut, max_iters=max_iters)


def search_step_hist_packed(table: dict, packed, vbits, lengths, *,
                            do_rc: bool, bad_ix: int, num_labels: int,
                            cap: int, true_len: int | None = None,
                            probe_iters: int | None = None) -> torch.Tensor:
    """Packed reads -> (B, cap+1) `pack_hist` rows (narrow labels; window
    counts < 2^16): probe, K2 histogram_packed."""
    ids = window_ids(table, packed, vbits, lengths, do_rc=do_rc, bad_ix=bad_ix,
                     num_labels=num_labels, true_len=true_len,
                     probe_iters=probe_iters)
    return histogram_packed(ids, num_labels, cap)


def search_step_hist_compact(table: dict, packed, vbits, lengths, *,
                             do_rc: bool, bad_ix: int, num_labels: int,
                             cap: int, over_cap: int, true_len: int | None = None,
                             probe_iters: int | None = None) -> torch.Tensor:
    """Packed reads -> the compact readback vector (`compact_rows`): probe,
    K2 histogram_packed, K8 hist_compact.  A batch with more than over_cap
    reads of 2+ labels loses the rows past over_cap; its header still holds
    the true count, and the pipeline redispatches it through
    `search_step_hist_packed`."""
    return hist_compact(search_step_hist_packed(
        table, packed, vbits, lengths, do_rc=do_rc, bad_ix=bad_ix,
        num_labels=num_labels, cap=cap, true_len=true_len,
        probe_iters=probe_iters), over_cap)


def search_step_hist_packed_in(table: dict, packed, vbits, lengths, *,
                               do_rc: bool, bad_ix: int, num_labels: int,
                               cap: int, true_len: int | None = None,
                               probe_iters: int | None = None) -> torch.Tensor:
    """Packed reads -> (B, 2*cap+2) [labels | counts | nuniq | found] rows,
    the layout for wide label ids: probe, K2 histogram_unpacked."""
    ids = window_ids(table, packed, vbits, lengths, do_rc=do_rc, bad_ix=bad_ix,
                     num_labels=num_labels, true_len=true_len,
                     probe_iters=probe_iters)
    return histogram_unpacked(ids, num_labels, cap)


def pack_reads_host(reads_u8: np.ndarray, lengths: np.ndarray):
    """Host 2-bit packing of an ASCII (B, L) batch (L % 8 == 0); bit-identical
    to the C++ scanner's pack_2bit."""
    table = np.full(256, DINVALID, np.int32)
    for chars, c in ((b"Aa", 0), (b"Cc", 1), (b"Gg", 2), (b"Tt", 3)):
        for ch in chars:
            table[ch] = c
    codes = table[reads_u8]
    valid = codes <= 3
    c = np.where(valid, codes, 0).astype(np.uint8)
    packed = (c[:, 0::4] << 6) | (c[:, 1::4] << 4) | (c[:, 2::4] << 2) | c[:, 3::4]
    return packed, np.packbits(valid, axis=1), lengths.astype(np.int32)


# ---- PACKSIZE=64: ASCII reads, four-lane 64-mer keys -------------------------

_DEV_CODE = torch.full((256,), DINVALID, dtype=torch.int64)
for _chars, _c in ((b"Aa", 0), (b"Cc", 1), (b"Gg", 2), (b"Tt", 3)):
    for _ch in _chars:
        _DEV_CODE[_ch] = _c


def base_codes(reads_u8: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, L) uint8 ASCII -> (B, L) int64 codes (A=0 C=1 G=2 T=3, lower case
    too); anything else, or a position past the length, is DINVALID."""
    codes = _DEV_CODE.to(reads_u8.device)[reads_u8.to(torch.int64)]
    pos = torch.arange(reads_u8.shape[1], device=reads_u8.device)
    return torch.where(pos < lengths.to(torch.int64)[:, None], codes, DINVALID)


def extract_windows64(codes: torch.Tensor):
    """Slide 64-mers: u32 lanes (k0, k1, k2, k3) MSB-first (k0 = bases 0..15,
    ..., k3 = bases 48..63) + validity, each (B, T-63); built by pairing the
    32-mer lanes at offsets i and i+32, as JAX does."""
    qpre, qhi, qlo, valid = extract_windows(codes)
    w = qpre.shape[1]
    if w <= 32:
        raise ValueError("reads shorter than 64 after padding")
    w64 = w - 32
    top = (qpre << 8) | qhi
    return (top[:, :w64], qlo[:, :w64], top[:, 32:], qlo[:, 32:],
            valid[:, :w64] & valid[:, 32:])


def rc_lanes64(k0, k1, k2, k3):
    """128-bit reverse complement on four u32 lanes: lane mirror plus the
    complement-reverse of each lane."""
    def c(x):
        return rev2_32(~x & M)

    return c(k3), c(k2), c(k1), c(k0)


def canonicalize64(k0, k1, k2, k3):
    """Lex-min of (word, RC) on four u32 lanes, k0 most significant ->
    (c0, c1, c2, c3, fwd_le)."""
    fwd, rc = (k0, k1, k2, k3), rc_lanes64(k0, k1, k2, k3)
    le = fwd[3] <= rc[3]
    for i in (2, 1, 0):
        le = (fwd[i] < rc[i]) | ((fwd[i] == rc[i]) & le)
    return (*(torch.where(le, a, b) for a, b in zip(fwd, rc)), le)


def mix4(k0, k1, k2, k3, seed: int):
    """Twin of `utree_tpu.hash_index64.mix4` on u32 lanes."""
    h = mul32(k0 ^ seed, _M1)
    h = h ^ (h >> 16)
    h = (h + mul32(k1, _M3)) & M
    h = mul32(h, _M2)
    h = h ^ (h >> 13)
    h = h ^ mul32(k2, _M1)
    h = mul32(h, _M3)
    h = h ^ (h >> 16)
    h = (h + mul32(k3, _M2)) & M
    return h ^ (h >> 15)


def _fold64(c):
    """The folded two-mix hash of the first-level 64-mer tables."""
    h1 = mix4(*c, 0)
    hb = mix4(*c, 0x6A09E667)
    return h1 ^ (((hb << 15) | (hb >> 17)) & M)


def probe_rows64(rows: torch.Tensor, ci, nslots: int):
    """Slot compare over gathered rows (..., nslots*6) int32 of entries
    (k0, k1, k2, k3, va, vb); `ci` holds the key's int32 lanes.  A slot
    matches on all four words and (va | vb) != 0; a later slot wins."""
    va = torch.zeros(ci[0].shape, dtype=torch.int32, device=rows.device)
    vb = torch.zeros_like(va)
    for s in range(nslots):
        a, b = rows[..., s * 6 + 4], rows[..., s * 6 + 5]
        m = (a | b) != 0
        for j in range(4):
            m &= rows[..., s * 6 + j] == ci[j]
        va = torch.where(m, a, va)
        vb = torch.where(m, b, vb)
    return va, vb


def _decode64(va, vb, valid, fwd_le, miss: int, do_rc: bool):
    """(va, vb) raw values (label id + 1) -> int32 ids; JAX's signed test."""
    if do_rc:
        return (torch.where(valid & (va > 0), va - 1, miss).to(torch.int32),
                torch.where(valid & (vb > 0), vb - 1, miss).to(torch.int32))
    fwd = torch.where(fwd_le, va, vb)
    return torch.where(valid & (fwd > 0), fwd - 1, miss).to(torch.int32)


def _tail64(t3, c, ci, valid, va, vb):
    """The c64_3 / d64_3 tail where the earlier levels hold no entry; an
    8-row tail is the placement's "absent" sentinel and is not probed."""
    if t3 is None or t3.shape[0] <= 8:
        return va, vb
    bkt3 = torch.where(valid, mix4(*c, 0x27D4EB2F) & (t3.shape[0] - 1), 0)
    return _first_hit_wide(va, vb, probe_rows64(t3[bkt3], ci, t3.shape[1] // 6))


def lookup_kmers_canonical64(tables: dict, k0, k1, k2, k3, valid, *,
                             slots: int, slots2: int, miss: int, do_rc: bool):
    """Plain version of K6: the 64-mer ladder c64_1 -> c64_2 -> c64_3.
    Returns (ix_a, ix_b) with RC, else the forward-strand ids."""
    t1, t2, t3 = tables["c64_1"], tables["c64_2"], tables.get("c64_3")
    b1, b2 = t1.shape[0], t2.shape[0]
    if t1.shape[1] != slots * 6 or t2.shape[1] != slots2 * 6:
        raise ValueError("slot count does not match table geometry")
    *c, fwd_le = canonicalize64(k0, k1, k2, k3)
    ci = [i32(x) for x in c]
    bkt1 = torch.where(valid, _fold64(c) & (b1 - 1), 0)
    va, vb = probe_rows64(t1[bkt1], ci, slots)
    if b2 > 8:
        bkt2 = torch.where(valid, mix4(*c, 0x5BD1E995) & (b2 - 1), 0)
        va, vb = _first_hit_wide(va, vb, probe_rows64(t2[bkt2], ci, slots2))
    va, vb = _tail64(t3, c, ci, valid, va, vb)
    return _decode64(va, vb, valid, fwd_le, miss, do_rc)


def lookup_kmers_displaced64(tables: dict, k0, k1, k2, k3, valid, *,
                             miss: int, do_rc: bool):
    """Plain version of K5: u8 seed read, one 2-slot 48 B d64_1 row, the
    d64_3 tail on a miss."""
    t1, seeds, t3 = tables["d64_1"], tables["d64_s"], tables.get("d64_3")
    if t1.shape[1] != 12:
        raise ValueError("displaced64 t1 must have 2-slot rows")
    nslots = 2 * t1.shape[0]
    nseed = 4 * seeds.shape[0]
    *c, fwd_le = canonicalize64(k0, k1, k2, k3)
    ci = [i32(x) for x in c]
    bkt = torch.where(valid, _fold64(c) & (nseed - 1), 0)
    seed = displaced_seed(seeds, bkt)
    u2 = mix4(*c, 0x94D049BB)
    u3 = mix4(*c, 0x7FEB352D)
    h = (mul32(u2 ^ mul32(seed, 0x85EBCA6B), 0xC2B2AE35)
         ^ mul32(u3 ^ mul32(seed, 0xC2B2AE35), 0x85EBCA6B))
    slot = torch.where(valid, h % nslots, 0)
    va, vb = probe_rows64(t1[slot >> 1], ci, 2)
    va, vb = _tail64(t3, c, ci, valid, va, vb)
    return _decode64(va, vb, valid, fwd_le, miss, do_rc)


def window_ids64_plain(table: dict, reads, lengths, *, do_rc: bool,
                       bad_ix: int) -> torch.Tensor:
    """Plain version of K5 and K6 (`search_step`'s k=64 branch): ASCII
    (B, L) reads -> (B, 2W) ids as [ix_a | ix_b] with RC, else (B, W);
    W = L-63."""
    k0, k1, k2, k3, valid = extract_windows64(base_codes(reads, lengths))
    miss = min(bad_ix, 0x7FFFFFFF)
    if "d64_1" in table:
        r = lookup_kmers_displaced64(table, k0, k1, k2, k3, valid, miss=miss,
                                     do_rc=do_rc)
    else:
        r = lookup_kmers_canonical64(table, k0, k1, k2, k3, valid,
                                     slots=table["c64_1"].shape[1] // 6,
                                     slots2=table["c64_2"].shape[1] // 6,
                                     miss=miss, do_rc=do_rc)
    return torch.cat(r, dim=1) if do_rc else r


def window_ids64(table: dict, reads, lengths, *, do_rc: bool,
                 bad_ix: int) -> torch.Tensor:
    """On CUDA tensors K5 `scan_probe64` (displaced, 'd64_1') or K6
    `ladder_probe64` (ladder, 'c64_1'); the plain version on CPU tensors.
    Both kernels read their rows as 16 B loads, so d64_1 and d64_3, or
    c64_1, c64_2 and c64_3, must be 16 B aligned."""
    if reads.device.type == "cpu":
        return window_ids64_plain(table, reads, lengths, do_rc=do_rc, bad_ix=bad_ix)
    dev = reads.device
    kernels.require(reads, "reads", torch.uint8, 2, dev)
    kernels.require(lengths, "lengths", torch.int32, 1, dev)
    b, width = reads.shape
    if lengths.shape[0] != b:
        raise ValueError("reads/lengths shapes disagree")
    w = width - 63
    if w <= 0:
        raise ValueError("reads shorter than 64 after padding")
    out = torch.empty((b, 2 * w if do_rc else w), dtype=torch.int32, device=dev)
    front = (reads.data_ptr(), lengths.data_ptr(), b, width, w)
    back = (int(do_rc), min(bad_ix, 0x7FFFFFFF), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if "d64_1" in table:
        t1, _, _ = _level(table["d64_1"], "d64_1", 6, dev)
        t3, n3, s3 = _level(table["d64_3"], "d64_3", 6, dev)
        seeds = table["d64_s"]
        kernels.require(seeds, "d64_s", torch.int32, 1, dev)
        nseed = 4 * seeds.shape[0]
        if t1.shape[1] != 12:
            raise ValueError("displaced64 t1 must have 2-slot rows")
        if nseed & (nseed - 1) or n3 & (n3 - 1):
            raise ValueError("seed table and d64_3 must have power-of-two sizes")
        _row_aligned(t1, "d64_1", 16)
        _row_aligned(t3, "d64_3", 16)
        kernels.launch("scan_probe64", *front, t1.data_ptr(), 2 * t1.shape[0],
                       seeds.data_ptr(), nseed, t3.data_ptr(), n3, s3, *back)
    else:
        levels = [_level(table[k], k, 6, dev) for k in ("c64_1", "c64_2", "c64_3")]
        if any(n & (n - 1) for _, n, _ in levels):
            raise ValueError("ladder levels must have power-of-two row counts")
        for k, (tt, _, _) in zip(("c64_1", "c64_2", "c64_3"), levels):
            _row_aligned(tt, k, 16)
        kernels.launch("ladder_probe64", *front,
                       *(x for tt, n, s in levels for x in (tt.data_ptr(), n, s)),
                       *back)
    return out


# ---- ASCII reads at k=32: K14, search_step, search_step_hist -----------------

def append_rc(codes: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, L) codes -> (B, 2L+1): forward, sentinel, reverse complement
    (utree_tpu/lookup.py:66-80, its clip-then-gather included): position
    `length` is invalid, positions length+1..2*length hold 3 - code of the
    read reversed (an invalid code stays invalid)."""
    b, l = codes.shape
    t = torch.arange(2 * l + 1, device=codes.device)
    ln = lengths.to(torch.int64)[:, None]
    rc_src = torch.gather(codes, 1, torch.clamp(2 * ln - t, 0, l - 1))
    rc_val = torch.where(rc_src <= 3, 3 - rc_src, DINVALID)
    fwd_val = codes[:, torch.clamp(t, 0, l - 1)]
    return torch.where(t < ln, fwd_val,
                       torch.where((t > ln) & (t <= 2 * ln), rc_val, DINVALID))


def window_lanes(reads_u8: torch.Tensor, lengths: torch.Tensor, k: int, do_rc: bool):
    """ASCII reads -> per-window (qpre, qhi, qlo, valid) lanes, the forward
    windows followed by the arithmetic RC words at k=32
    (utree_tpu/lookup.py:568-581).  Any other k appends the RC text and
    then meets extract_windows' NotImplementedError, as in JAX."""
    codes = base_codes(reads_u8, lengths)
    if do_rc and k != 32:
        codes = append_rc(codes, lengths)
    qpre, qhi, qlo, valid = extract_windows(codes, k)
    return _with_rc_words(qpre, qhi, qlo, valid, do_rc and k == 32)


def ascii_pack_plain(reads_u8: torch.Tensor, lengths: torch.Tensor, rc: bool = False):
    """Plain version of K14: `base_codes` (with `rc`, then `append_rc`)
    packed as pack_reads_host packs: (B, T8/4) u8, 4 codes a byte
    MSB-first (an invalid code as 0), and (B, T8/8) u8 np.packbits validity
    bits; T8 is the positions (L, or 2L+1 with rc) rounded up to a multiple
    of 8, the pad invalid."""
    codes = base_codes(reads_u8, lengths)
    if rc:
        codes = append_rc(codes, lengths)
    b, t = codes.shape
    t8 = t + (-t) % 8
    codes = torch.nn.functional.pad(codes, (0, t8 - t), value=DINVALID)
    valid = codes <= 3
    c = torch.where(valid, codes, 0)
    packed = (c[:, 0::4] << 6) | (c[:, 1::4] << 4) | (c[:, 2::4] << 2) | c[:, 3::4]
    weights = 1 << torch.arange(7, -1, -1, device=codes.device)
    vbits = (valid.reshape(b, t8 // 8, 8).to(torch.int64) * weights).sum(2)
    return packed.to(torch.uint8), vbits.to(torch.uint8)


def ascii_pack(reads_u8: torch.Tensor, lengths: torch.Tensor, rc: bool = False):
    """K14 `ascii_pack` on CUDA tensors; `ascii_pack_plain` on CPU tensors."""
    if reads_u8.device.type == "cpu":
        return ascii_pack_plain(reads_u8, lengths, rc)
    dev = reads_u8.device
    kernels.require(reads_u8, "reads", torch.uint8, 2, dev)
    kernels.require(lengths, "lengths", torch.int32, 1, dev)
    b, l = reads_u8.shape
    if lengths.shape[0] != b:
        raise ValueError("reads/lengths shapes disagree")
    row8 = -(-(2 * l + 1 if rc else l) // 8)
    packed = torch.empty((b, 2 * row8), dtype=torch.uint8, device=dev)
    vbits = torch.empty((b, row8), dtype=torch.uint8, device=dev)
    kernels.launch("ascii_pack", reads_u8.data_ptr(), lengths.data_ptr(), b, l, row8,
                   int(rc), packed.data_ptr(), vbits.data_ptr(),
                   torch.cuda.current_stream(dev).cuda_stream)
    return packed, vbits


def int32_miss(bad_ix: int) -> None:
    """utree_tpu's k=32 lookups select bad_ix into int32 id lanes, which
    raises OverflowError for an IXTYPE=u32 bad_ix (2^32-1); so does the
    port."""
    if not -(1 << 31) <= bad_ix < (1 << 31):
        raise OverflowError(f"bad_ix {bad_ix} does not fit the int32 id lanes")


def ascii_window_ids(table: dict, reads_u8, lengths, *, do_rc: bool, bad_ix: int,
                     num_labels: int | None, probe_iters: int | None, k: int = 32,
                     hash_slots: int = 8) -> torch.Tensor:
    """`search_step`'s k=32 branches by way of the packed probes: K14 packs
    the reads over L8 positions (L rounded up to a multiple of 8), and
    `window_ids` (K1, K4, K7 or K10) probes W8 = L8-31 windows a strand;
    the ids are then trimmed to JAX's W = L-31, columns [:W] and, with RC,
    [W8:W8+W].  Every length is at most L, so the windows past L-31 are
    invalid in both.  On CPU tensors the same route runs the plain
    versions."""
    if k != 32:
        raise NotImplementedError("extract_windows implements the 32-mer geometry")
    w = reads_u8.shape[1] - 31
    if w <= 0:
        raise ValueError("reads shorter than k after padding")
    int32_miss(bad_ix)
    if "t1" in table and hash_slots != 8:
        raise ValueError(f"the hash probe takes 8-slot rows, not hash_slots={hash_slots}")
    packed, vbits = ascii_pack(reads_u8, lengths)
    ids = window_ids(table, packed, vbits, lengths, do_rc=do_rc, bad_ix=bad_ix,
                     num_labels=num_labels or 0, probe_iters=probe_iters)
    w8 = packed.shape[1] * 4 - 31
    if w8 == w:
        return ids
    return torch.cat([ids[:, :w], ids[:, w8:w8 + w]], 1) if do_rc else ids[:, :w].contiguous()


def search_step(table: dict, reads_u8, lengths, *, k: int, do_rc: bool,
                probe_iters: int | None, bad_ix: int, hash_slots: int = 8,
                num_labels: int | None = None) -> torch.Tensor:
    """ASCII reads -> per-window label ids, bad_ix on a miss
    (utree_tpu/lookup.py:584-618), in JAX's order: a k=32 canonical table
    (c1, d1) needs `num_labels` (ValueError) and probes both strands at
    once; a k=64 table (c64_1, d64_1) takes the 64-mer branch
    (`window_ids64`: K5, K6); anything else goes through `window_lanes`,
    then the legacy hash (t1) or the bsearch replay (bin_ix, `probe_iters`
    trips).  With RC the k=32 ids are [ix_a | ix_b] (canonical) or
    [fwd | rc].  On CPU tensors the k=32 branches are the plain twins of
    JAX's; on CUDA tensors `ascii_window_ids` (K14, then K1, K4, K7 or
    K10)."""
    canonical = ("c1" in table or "d1" in table) and k == 32
    if canonical and num_labels is None:
        raise ValueError("num_labels is required for canonical tables")
    if ("c64_1" in table or "d64_1" in table) and k == 64:
        return window_ids64(table, reads_u8, lengths, do_rc=do_rc, bad_ix=bad_ix)
    if reads_u8.device.type != "cpu":
        return ascii_window_ids(table, reads_u8, lengths, k=k, do_rc=do_rc, bad_ix=bad_ix,
                                num_labels=num_labels, probe_iters=probe_iters,
                                hash_slots=hash_slots)
    if canonical:
        lanes = extract_windows(base_codes(reads_u8, lengths), k)
        int32_miss(bad_ix)
        return _canonical_family_ix(table, *lanes, bad_ix=bad_ix, do_rc=do_rc,
                                    num_labels=num_labels)
    lanes = window_lanes(reads_u8, lengths, k, do_rc)
    int32_miss(bad_ix)
    if "t1" in table:
        return lookup_kmers_hash(table, *lanes, slots=hash_slots, bad_ix=bad_ix)
    return lookup_kmers(table, *lanes, probe_iters, bad_ix)


def search_step_hist(table: dict, reads, lengths, *, k: int, do_rc: bool,
                     probe_iters: int | None, bad_ix: int, num_labels: int,
                     cap: int = 16) -> torch.Tensor:
    """`search_step`, then K2 `histogram_unpacked` (utree_tpu/lookup.py:
    662-675): ASCII reads -> (B, 2*cap+2) int32 rows [labels | counts |
    nuniq | found], the PACKSIZE=64 readback.  Like JAX's, it hands
    search_step no `num_labels`, so a k=32 canonical table (c1, d1) raises
    its ValueError."""
    ids = search_step(table, reads, lengths, k=k, do_rc=do_rc, probe_iters=probe_iters,
                      bad_ix=bad_ix)
    return histogram_unpacked(ids, num_labels, cap)
