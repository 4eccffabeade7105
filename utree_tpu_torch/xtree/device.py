"""XTree ALIGN device path of the port: the per-position k-mer probe
(xtree.c:1024-1081) over a seeded-displacement hash, on the GPU through
kernel K9 `csrc/xtree_probe.cu`.  Counterpart of `utree_tpu/xtree/device.py`.

The host engine's `_lookup` replays LBS_k (xtree.c:170-178) with a masked
bisection.  The device instead probes a canonical dual-value displaced hash
(`hash_index.place_displaced`, the utree displaced table's geometry):

  key   = min(word, rc(word)) of the k-mer word (2k <= 62 bits in two lanes)
  entry = (key_lo, key_hi, seed_fwd+1, seed_rc+1), where the values are what
          the reference's own probe would return for each orientation —
          including the one-past-the-bin LBS_k quirk (xtree.c:177) — so ONE
          32B row gather answers both strands of a position exactly.

Everything downstream (run expansion, tallies, conf/aufbau, redistribution,
writers) stays in the exact host engine; the device only replaces the
encode+lookup front end, returning per-window (seed, prefix) for both
orientations in the reference's scan order.

  xtree_step        K9 `xtree_probe` on CUDA tensors; the plain version on
                    CPU tensors
  xtree_step_plain  the plain PyTorch version, step for step as
                    `utree_tpu.xtree.device.xtree_device_step`, on int64
                    lanes masked to 32 bits (see `_u32`)
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from utree_tpu_torch import kernels
from utree_tpu_torch._u32 import M, i32
from utree_tpu_torch.hash_index import _rc64, displaced_to_device, place_displaced
from utree_tpu_torch.lookup import (_level, _row_aligned, base_codes, displaced_probe_raw,
                                    rev2_32)
from utree_tpu_torch.xtree.build import XtreeDB


def _xtree_reference_hits(bins: np.ndarray, sfx: np.ndarray):
    """Every (prefix_bin, suffix) -> LBS_k result the aligner's `_lookup` can
    produce: per nonempty bin its distinct suffixes' first-occurrence indices,
    plus the one-past entry (p, sfx[end]) -> end when that suffix exceeds the
    bin's last (the C reads one pod past the bin, xtree.c:177)."""
    n = len(sfx) - 1  # sfx carries the sentinel pod
    starts = bins[:-1]
    ends = bins[1:]
    pop = np.flatnonzero(ends > starts)
    if len(pop) == 0:
        return (np.zeros(0, np.int64),) * 3
    # first occurrence of each distinct suffix within its bin
    bin_of = np.searchsorted(bins, np.arange(n), side="right") - 1
    first = np.ones(n, bool)
    if n > 1:
        first[1:] = (sfx[1:n] != sfx[: n - 1]) | (bin_of[1:] != bin_of[:-1])
    idx = np.flatnonzero(first)
    pre = bin_of[idx]
    suf = sfx[idx]
    val = idx
    # one-past entries
    b = ends[pop]
    last = sfx[b - 1]
    past = sfx[np.minimum(b, n)]
    take = past > last
    pre = np.concatenate([pre, pop[take]])
    suf = np.concatenate([suf, past[take]])
    val = np.concatenate([val, b[take]])
    return pre.astype(np.int64), suf.astype(np.int64), val.astype(np.int64)


def _rc_word_np(w: np.ndarray, k: int) -> np.ndarray:
    """Reverse complement of 2k-bit words held in uint64."""
    return _rc64(w.astype(np.uint64)) >> np.uint64(64 - 2 * k)


@dataclasses.dataclass
class XtreeDeviceIndex:
    tables: dict  # {d1, ds, d3} int32 tensors on `device`
    k: int
    pl: int
    sl: int
    num_entries: int
    device: torch.device


def build_xtree_device_index(db: XtreeDB, aligner_sfx: np.ndarray,
                             aligner_bins: np.ndarray, device) -> XtreeDeviceIndex:
    """Canonical displaced hash over the aligner's pod arrays (sentinel
    included, so the one-past quirk values match the host replay), placed
    on `device`.  On "cuda" the card and the K9 build are checked first:
    either missing raises."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the xtree device front end needs a CUDA device; pass "
                "device='cpu' for its plain version or None for the host engine")
        kernels.library()  # a failed K9 build raises here, before the placement
    k, pl, sl = db.k, db.pl, db.sl
    if 2 * k > 62:
        raise ValueError("xtree device path supports k <= 31")
    pre, suf, val = _xtree_reference_hits(aligner_bins, aligner_sfx)
    if len(val) and int(val.max()) >= 0x7FFFFFFE:
        raise ValueError("pod indices exceed int32 device lanes")
    w = (pre.astype(np.uint64) << np.uint64(2 * sl)) | suf.astype(np.uint64)
    r = _rc_word_np(w, k)
    c = np.minimum(w, r)
    is_fwd = w == c
    order = np.argsort(c, kind="stable")
    cs, isf, vals_s = c[order], is_fwd[order], val[order].astype(np.uint32)
    new = np.ones(len(cs), bool)
    if len(cs) > 1:
        new[1:] = cs[1:] != cs[:-1]
    gid = np.cumsum(new) - 1
    ng = int(gid[-1]) + 1 if len(cs) else 0
    va = np.zeros(ng, np.uint32)
    vb = np.zeros(ng, np.uint32)
    va[gid[isf]] = vals_s[isf] + np.uint32(1)
    vb[gid[~isf]] = vals_s[~isf] + np.uint32(1)
    ck = cs[new]
    pal = ck == _rc_word_np(ck, k)  # even k only; hits both scans
    vb[pal] = va[pal]
    vals2d = np.stack([va.view(np.int32), vb.view(np.int32)], axis=1)
    key_lo = (ck & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    key_hi = (ck >> np.uint64(32)).astype(np.uint32).view(np.int32)
    chi32 = (ck >> np.uint64(32)).astype(np.int64)
    cpre = chi32 >> 8
    chi = chi32 & 0xFF
    clo = (ck & np.uint64(0xFFFFFFFF)).astype(np.int64)
    built = place_displaced(key_lo, key_hi, vals2d, cpre, chi, clo, ng)
    return XtreeDeviceIndex(tables=displaced_to_device(built, device), k=k, pl=pl,
                            sl=sl, num_entries=ng, device=device)


# --------------------------------------------------------------------------
# Device step
# --------------------------------------------------------------------------

def extract_windows_k(codes: torch.Tensor, k: int):
    """(B, T) codes -> k-mer lanes (w_hi, w_lo, valid), MSB-first; the first
    k-16 bases fill hi, the last 16 fill lo (14 <= k <= 31).  Lanes are
    int64 holding u32 values."""
    b, t = codes.shape
    w = t - k + 1
    if w <= 0:
        raise ValueError("queries shorter than k after padding")
    w_hi = torch.zeros((b, w), dtype=torch.int64, device=codes.device)
    w_lo = torch.zeros_like(w_hi)
    valid = torch.ones((b, w), dtype=torch.bool, device=codes.device)
    nh = k - 16
    for j in range(k):
        c = codes[:, j:j + w]
        valid &= c <= 3
        cc = torch.where(c <= 3, c, 0)
        if j < nh:
            w_hi |= cc << (2 * (nh - 1 - j))
        else:
            w_lo |= cc << (2 * (k - 1 - j))
    return w_hi, w_lo, valid


def rc_lanes_k(w_hi, w_lo, k: int):
    """RC of 2k-bit words in (hi, lo) u32 lanes (rev2 + complement + shift),
    with `_rc_lanes_k`'s shift branches (k <= 31, so s >= 2)."""
    r_lo_t = rev2_32(~w_hi & M)
    r_hi_t = rev2_32(~w_lo & M)
    s = 64 - 2 * k
    if s < 32:
        rc_lo = ((r_lo_t >> s) | (r_hi_t << (32 - s))) & M
        rc_hi = r_hi_t >> s
    elif s == 32:
        rc_lo, rc_hi = r_hi_t, torch.zeros_like(r_hi_t)
    else:
        rc_lo = r_hi_t >> (s - 32)
        rc_hi = torch.zeros_like(r_hi_t)
    return rc_hi, rc_lo


def prefix_of(w_hi, w_lo, sl: int) -> torch.Tensor:
    """The prefix bin of each word: its bits above the 2*sl suffix bits
    (sl <= 16, as build_xtree_db requires)."""
    b = 2 * sl
    if b < 32:
        return i32((w_hi << (32 - b)) | (w_lo >> b))
    return i32(w_hi)


def xtree_step_plain(tables: dict, reads: torch.Tensor, lengths: torch.Tensor, *,
                     k: int, sl: int):
    """Plain version of K9: (B, T) ASCII queries -> per-window (seed_f,
    seed_r, pre_f, pre_r) int32 matrices of (B, T-k+1) (seed = LBS_k pod
    index, -1 = miss or invalid window), scan-order exact."""
    codes = base_codes(reads, lengths)
    w_hi, w_lo, valid = extract_windows_k(codes, k)
    r_hi, r_lo = rc_lanes_k(w_hi, w_lo, k)
    fwd_le = (w_hi < r_hi) | ((w_hi == r_hi) & (w_lo <= r_lo))
    c_hi = torch.where(fwd_le, w_hi, r_hi)
    c_lo = torch.where(fwd_le, w_lo, r_lo)
    va, vb = displaced_probe_raw(tables, c_lo, c_hi, valid, wide=True)
    seed_c = va - 1   # value for the canonical word's orientation
    seed_rc = vb - 1  # value for its reverse complement
    seed_f = torch.where(valid, torch.where(fwd_le, seed_c, seed_rc), -1)
    seed_r = torch.where(valid, torch.where(fwd_le, seed_rc, seed_c), -1)
    return (seed_f.to(torch.int32), seed_r.to(torch.int32),
            prefix_of(w_hi, w_lo, sl), prefix_of(r_hi, r_lo, sl))


def xtree_step(tables: dict, reads: torch.Tensor, lengths: torch.Tensor, *,
               k: int, sl: int):
    """K9 `xtree_probe` on CUDA tensors; `xtree_step_plain` on CPU tensors.
    Returns (seed_f, seed_r, pre_f, pre_r), each (B, T-k+1) int32."""
    if reads.device.type == "cpu":
        return xtree_step_plain(tables, reads, lengths, k=k, sl=sl)
    dev = reads.device
    kernels.require(reads, "reads", torch.uint8, 2, dev)
    kernels.require(lengths, "lengths", torch.int32, 1, dev)
    b, t = reads.shape
    if lengths.shape[0] != b:
        raise ValueError("reads/lengths shapes disagree")
    if not (1 <= sl <= 16 and sl < k <= 31):
        raise ValueError(f"xtree_probe takes sl in 1..16 and sl < k <= 31, got k={k}, sl={sl}")
    w = t - k + 1
    if w <= 0:
        raise ValueError("queries shorter than k after padding")
    d1, _, _ = _level(tables["d1"], "d1", 4, dev)
    d3, n3, s3 = _level(tables["d3"], "d3", 4, dev)
    ds = tables["ds"]
    kernels.require(ds, "ds", torch.int32, 1, dev)
    nseed = 4 * ds.shape[0]
    if d1.shape[1] != 8:
        raise ValueError("xtree_probe takes d1 rows of 2 wide (4-column) slots")
    _row_aligned(d1, "d1", 16)
    if nseed & (nseed - 1) or n3 & (n3 - 1):
        raise ValueError("seed table and d3 must have power-of-two sizes")
    out = torch.empty((4, b, w), dtype=torch.int32, device=dev)
    kernels.launch("xtree_probe", reads.data_ptr(), lengths.data_ptr(), b, t, w, k, sl,
                   d1.data_ptr(), 2 * d1.shape[0], ds.data_ptr(), nseed,
                   d3.data_ptr(), n3, s3, out.data_ptr(),
                   kernels.stream(dev))
    return tuple(out)


def make_device_step(index: XtreeDeviceIndex):
    return functools.partial(xtree_step, k=index.k, sl=index.sl)
