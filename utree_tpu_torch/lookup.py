"""Search step of the port: packed reads -> label ids -> histograms -> votes.

Counterpart of `utree_tpu/lookup.py`, restricted to the main path: 2-bit
packed reads, PACKSIZE=32, the seeded-displacement table with narrow
(u16-packed) entries.  Each device function has a plain PyTorch version
that mirrors the JAX code step for step on int64 lanes masked to 32 bits
(see `_u32`), and a wrapper:

  window_ids  -> K1 `csrc/scan_probe.cu`  (plain: window_ids_plain)
  histogram   -> K2 `csrc/histogram.cu`   (plain: compact_histogram)

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


# ---- displaced probe -------------------------------------------------------

def _split(key_lo, key_hi):
    return key_hi >> 8, key_hi & 0xFF, key_lo


def displaced_bucket(key_lo, key_hi, valid, nseed: int):
    c_pre, c_hi8, c_lo = _split(key_lo, key_hi)
    h1 = mix(c_pre, c_hi8, c_lo)
    hb = mix(c_pre, c_hi8, c_lo ^ 0x6A09E667)
    g = h1 ^ (((hb << 15) | (hb >> 17)) & M)
    return torch.where(valid, g & (nseed - 1), 0)


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


def displaced_probe_raw(tables: dict, key_lo, key_hi, valid) -> torch.Tensor:
    """Seed read -> one 2-slot d1 row -> d3 tail: the raw packed value."""
    t1, seeds, t3 = tables["d1"], tables["ds"], tables.get("d3")
    if t1.shape[1] != 6:
        raise NotImplementedError(
            "wide-label displaced rows (IXTYPE=u32) are not ported yet "
            "(ROADMAP A.7)")
    nslots = 2 * t1.shape[0]
    nseed = 4 * seeds.shape[0]
    bkt = displaced_bucket(key_lo, key_hi, valid, nseed)
    seed = displaced_seed(seeds, bkt)
    slot = displaced_slot(key_lo, key_hi, seed, valid, nslots)
    val = probe_rows(t1[slot >> 1], key_lo, key_hi, 2)
    if t3 is not None and t3.shape[0] > 8:
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


def lookup_kmers_displaced(tables: dict, qpre, qhi, qlo, valid, *,
                           bad_ix: int, do_rc: bool):
    key_lo, key_hi, fwd_le = canonical_keys(qpre, qhi, qlo)
    val = displaced_probe_raw(tables, key_lo, key_hi, valid)
    return decode_canonical_vals(val, valid, fwd_le, bad_ix, do_rc)


def _trim(packed, vbits, true_len):
    if true_len is not None and true_len < packed.shape[1] * 4:
        return packed[:, : true_len // 4], vbits[:, : true_len // 8]
    return packed, vbits


def window_ids_plain(tables: dict, packed, vbits, lengths, *, do_rc: bool,
                     bad_ix: int, true_len: int | None = None) -> torch.Tensor:
    """Plain version of K1 (`_packed_window_ix`, displaced branch): packed
    reads -> (B, 2W) ids as [ix_a | ix_b] with RC, else (B, W)."""
    packed, vbits = _trim(packed, vbits, true_len)
    codes = base_codes_packed(packed, vbits, lengths)
    qpre, qhi, qlo, valid = extract_windows(codes)
    r = lookup_kmers_displaced(tables, qpre, qhi, qlo, valid,
                               bad_ix=bad_ix, do_rc=do_rc)
    return torch.cat(r, dim=1) if do_rc else r


def window_ids(tables: dict, packed, vbits, lengths, *, do_rc: bool,
               bad_ix: int, true_len: int | None = None) -> torch.Tensor:
    """K1 `scan_probe` on CUDA tensors; the plain version on CPU tensors."""
    if packed.device.type == "cpu":
        return window_ids_plain(tables, packed, vbits, lengths, do_rc=do_rc,
                                bad_ix=bad_ix, true_len=true_len)
    dev = packed.device
    t1, seeds, t3 = tables["d1"], tables["ds"], tables["d3"]
    kernels.require(packed, "packed", torch.uint8, 2, dev)
    kernels.require(vbits, "vbits", torch.uint8, 2, dev)
    kernels.require(lengths, "lengths", torch.int32, 1, dev)
    for name, t, nd in (("d1", t1, 2), ("ds", seeds, 1), ("d3", t3, 2)):
        kernels.require(t, name, torch.int32, nd, dev)
    if t1.shape[1] != 6:
        raise NotImplementedError(
            "wide-label displaced rows (IXTYPE=u32) are not ported yet "
            "(ROADMAP A.7)")
    b, row4 = packed.shape
    row8 = vbits.shape[1]
    if lengths.shape[0] != b or vbits.shape[0] != b or row8 * 2 != row4:
        raise ValueError("packed/vbits/lengths shapes disagree")
    t = row4 * 4 if true_len is None else min(true_len, row4 * 4)
    w = t - 31
    if w <= 0:
        raise ValueError("reads shorter than k after padding")
    nseed = 4 * seeds.shape[0]
    if nseed & (nseed - 1) or t3.shape[0] & (t3.shape[0] - 1) or t3.shape[1] % 3:
        raise ValueError("seed table and d3 must have power-of-two sizes")
    out = torch.empty((b, 2 * w if do_rc else w), dtype=torch.int32, device=dev)
    kernels.launch(
        "scan_probe", packed.data_ptr(), vbits.data_ptr(), lengths.data_ptr(),
        b, row4, row8, w, t1.data_ptr(), 2 * t1.shape[0], seeds.data_ptr(),
        nseed, t3.data_ptr(), t3.shape[0], t3.shape[1] // 3, int(do_rc),
        bad_ix, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return out


# ---- histogram -------------------------------------------------------------

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


def histogram(ids: torch.Tensor, num_labels: int, cap: int):
    """K2 `histogram` on CUDA tensors; the plain version on CPU tensors."""
    if ids.device.type == "cpu":
        return compact_histogram(ids, num_labels, cap)
    dev = ids.device
    kernels.require(ids, "ids", torch.int32, 2, dev)
    if not 1 <= cap <= 30:
        raise ValueError(f"cap={cap} out of range 1..30")
    b, n = ids.shape
    labels = torch.empty((b, cap), dtype=torch.int32, device=dev)
    counts = torch.empty((b, cap), dtype=torch.int32, device=dev)
    nuniq = torch.empty(b, dtype=torch.int32, device=dev)
    found = torch.empty(b, dtype=torch.int32, device=dev)
    kernels.launch("histogram", ids.data_ptr(), b, n, num_labels, cap,
                   labels.data_ptr(), counts.data_ptr(), nuniq.data_ptr(),
                   found.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return labels, counts, nuniq, found


# ---- the device step ---------------------------------------------------------

def search_step_vote_compact(table: dict, packed, vbits, lengths, *,
                             do_rc: bool, bad_ix: int, num_labels: int,
                             cap: int, taxacut: int, max_iters: int,
                             true_len: int | None = None) -> torch.Tensor:
    """The whole device step: packed reads -> (B, 3) int32 vote rows
    (w0, w1, w2; layout in `classify_device.pack_vote`).  `table` holds
    d1/ds/d3 and the vote tables under `vt_*` keys."""
    vote_tab = {k[3:]: v for k, v in table.items() if k.startswith("vt_")}
    ids = window_ids(table, packed, vbits, lengths, do_rc=do_rc,
                     bad_ix=bad_ix, true_len=true_len)
    labels, counts, nuniq, found = histogram(ids, num_labels, cap)
    return vote_rows(vote_tab, labels, counts, nuniq, found,
                     taxacut=taxacut, max_iters=max_iters)


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
