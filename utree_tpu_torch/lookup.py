"""Search step of the port: packed reads -> label ids -> histograms -> votes.

Counterpart of `utree_tpu/lookup.py` for 2-bit packed reads at PACKSIZE=32
over the two canonical-key tables: the seeded-displacement table (d1/ds/d3)
and the canonical ladder (c1/c2/c3), each with narrow (u16-packed, 3-column
slots) or wide (IXTYPE=u32, 4-column slots) entries; wide when
num_labels >= 0xFFFF, as in JAX.  Each device function has a plain PyTorch
version that mirrors the JAX code step for step on int64 lanes masked to 32
bits (see `_u32`), and a wrapper:

  window_ids          -> K1 `csrc/scan_probe.cu`   (d1: scan_probe[_wide])
                         K4 `csrc/ladder_probe.cu` (c1: ladder_probe[_wide])
                         (plain: window_ids_plain)
  histogram           -> K2 `csrc/histogram.cu`    (plain: compact_histogram)
  histogram_packed    -> K2, (B, cap+1) rows       (plain: pack_hist)
  histogram_unpacked  -> K2, (B, 2*cap+2) rows     (plain: unpacked_hist)

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


def _trim(packed, vbits, true_len):
    if true_len is not None and true_len < packed.shape[1] * 4:
        return packed[:, : true_len // 4], vbits[:, : true_len // 8]
    return packed, vbits


def window_ids_plain(tables: dict, packed, vbits, lengths, *, do_rc: bool,
                     bad_ix: int, num_labels: int,
                     true_len: int | None = None) -> torch.Tensor:
    """Plain version of K1 and K4 (`_packed_window_ix`, canonical family):
    packed reads -> (B, 2W) ids as [ix_a | ix_b] with RC, else (B, W)."""
    packed, vbits = _trim(packed, vbits, true_len)
    codes = base_codes_packed(packed, vbits, lengths)
    qpre, qhi, qlo, valid = extract_windows(codes)
    return _canonical_family_ix(tables, qpre, qhi, qlo, valid, bad_ix=bad_ix,
                                do_rc=do_rc, num_labels=num_labels)


def _level(t: torch.Tensor, name: str, cps: int, dev):
    """(tensor, rows, slots) of one table level, checked for the kernels."""
    kernels.require(t, name, torch.int32, 2, dev)
    if t.shape[0] < 1 or t.shape[1] % cps:
        raise ValueError(f"{name} {tuple(t.shape)} is no table of {cps}-column slots")
    return t, t.shape[0], t.shape[1] // cps


def window_ids(tables: dict, packed, vbits, lengths, *, do_rc: bool,
               bad_ix: int, num_labels: int,
               true_len: int | None = None) -> torch.Tensor:
    """On CUDA tensors K1 `scan_probe[_wide]` (displaced table, 'd1') or K4
    `ladder_probe[_wide]` (ladder, 'c1'); the plain version on CPU tensors."""
    if packed.device.type == "cpu":
        return window_ids_plain(tables, packed, vbits, lengths, do_rc=do_rc,
                                bad_ix=bad_ix, num_labels=num_labels,
                                true_len=true_len)
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
    if "d1" in tables:
        t1, _, _ = _level(tables["d1"], "d1", cps, dev)
        t3, n3, s3 = _level(tables["d3"], "d3", cps, dev)
        seeds = tables["ds"]
        kernels.require(seeds, "ds", torch.int32, 1, dev)
        nseed = 4 * seeds.shape[0]
        if t1.shape[1] != 2 * cps:
            raise ValueError("displaced t1 must have 2-slot rows")
        if nseed & (nseed - 1) or n3 & (n3 - 1):
            raise ValueError("seed table and d3 must have power-of-two sizes")
        kernels.launch("scan_probe" + suffix, *front, t1.data_ptr(), 2 * t1.shape[0],
                       seeds.data_ptr(), nseed, t3.data_ptr(), n3, s3, *back)
    else:
        levels = [_level(tables[k], k, cps, dev) for k in ("c1", "c2", "c3")]
        if any(n & (n - 1) for _, n, _ in levels):
            raise ValueError("ladder levels must have power-of-two row counts")
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


# ---- the device steps --------------------------------------------------------
# `table` holds d1/ds/d3 or c1/c2/c3 (and, for the vote, the vote tables
# under `vt_*` keys).

def search_step_vote_compact(table: dict, packed, vbits, lengths, *,
                             do_rc: bool, bad_ix: int, num_labels: int,
                             cap: int, taxacut: int, max_iters: int,
                             true_len: int | None = None) -> torch.Tensor:
    """Packed reads -> (B, 3) int32 vote rows (w0, w1, w2; layout in
    `classify_device.pack_vote`): probe, K2 histogram, K3 vote."""
    vote_tab = {k[3:]: v for k, v in table.items() if k.startswith("vt_")}
    ids = window_ids(table, packed, vbits, lengths, do_rc=do_rc, bad_ix=bad_ix,
                     num_labels=num_labels, true_len=true_len)
    labels, counts, nuniq, found = histogram(ids, num_labels, cap)
    return vote_rows(vote_tab, labels, counts, nuniq, found,
                     taxacut=taxacut, max_iters=max_iters)


def search_step_hist_packed(table: dict, packed, vbits, lengths, *,
                            do_rc: bool, bad_ix: int, num_labels: int,
                            cap: int, true_len: int | None = None) -> torch.Tensor:
    """Packed reads -> (B, cap+1) `pack_hist` rows (narrow labels; window
    counts < 2^16): probe, K2 histogram_packed."""
    ids = window_ids(table, packed, vbits, lengths, do_rc=do_rc, bad_ix=bad_ix,
                     num_labels=num_labels, true_len=true_len)
    return histogram_packed(ids, num_labels, cap)


def search_step_hist_packed_in(table: dict, packed, vbits, lengths, *,
                               do_rc: bool, bad_ix: int, num_labels: int,
                               cap: int, true_len: int | None = None) -> torch.Tensor:
    """Packed reads -> (B, 2*cap+2) [labels | counts | nuniq | found] rows,
    the layout for wide label ids: probe, K2 histogram_unpacked."""
    ids = window_ids(table, packed, vbits, lengths, do_rc=do_rc, bad_ix=bad_ix,
                     num_labels=num_labels, true_len=true_len)
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
