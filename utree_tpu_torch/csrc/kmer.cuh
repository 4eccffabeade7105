// The front half shared by the probe kernels (K1 scan_probe, K4
// ladder_probe): one (read, window) -> its canonical 32-mer key, the 32-bit
// mixes the table placement uses, the slot compare over one gathered row, and
// the dual-value decode into per-window label ids.
//
// Twins (utree_tpu/lookup.py): base_codes_packed :39 + extract_windows :83
// (window_at), _rev2_32 :113, rc_word_lanes :123 and canonical_keys :243
// (canonical), _mix_jnp :188 (mix32), probe_rows :292 / probe_rows_wide :306
// (probe_row), decode_canonical_vals :335 / decode_canonical_wide :322 and
// the [ix_a | ix_b] concat of _canonical_family_ix :921 (write_ids).
// Arithmetic is true uint32, wrapping exactly as the jnp.uint32 code.
#pragma once

#include "common.cuh"

namespace kmer {

__device__ __forceinline__ uint32_t mix32(uint32_t pre, uint32_t hi, uint32_t lo) {
  uint32_t h = pre * 0x9E3779B1u;
  h ^= lo ^ (lo >> 16);
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h += hi * 0xC2B2AE35u;
  h ^= h >> 16;
  h *= 0x9E3779B1u;
  h ^= h >> 15;
  return h;
}

// Reverse the 2-bit groups of a word (base order reversal): reverse all bits,
// then swap the two bits back inside each group.
__device__ __forceinline__ uint32_t rev2(uint32_t x) {
  uint32_t r = __brev(x);
  return ((r >> 1) & 0x55555555u) | ((r & 0x55555555u) << 1);
}

// The 32 bases at w..w+31 of one packed read, MSB-first 2 bits each:
// hi32 = bases 0..15 (prefix24 << 8 | hi8), lo32 = bases 16..31.  Invalid
// bases (N, or past the read's length) code 0 and make the window invalid.
__device__ __forceinline__ bool window_at(const uint8_t* pk, const uint8_t* vb,
                                          int32_t len, int32_t w, uint32_t& hi32,
                                          uint32_t& lo32) {
  hi32 = 0;
  lo32 = 0;
  bool valid = true;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    int p = w + j;
    uint32_t code = (pk[p >> 2] >> (2 * (3 - (p & 3)))) & 3u;
    bool ok = ((vb[p >> 3] >> (7 - (p & 7))) & 1u) && p < len;
    valid &= ok;
    code = ok ? code : 0u;
    if (j < 16) hi32 |= code << (2 * (15 - j));
    else lo32 |= code << (2 * (31 - j));
  }
  return valid;
}

// A canonical key c = min(word, rc(word)) on its (hi32, lo32) lanes, with the
// pieces the mixes take (pre24, hi8, lo32) and the key's int32 bits.
struct Key {
  uint32_t pre, hi8, lo;
  int32_t klo, khi;
};

// rc(hi32:lo32) = rev2(~lo32):rev2(~hi32).  Returns whether the forward word
// is the minimum (fwd_le), which picks the forward-strand id without RC.
__device__ __forceinline__ bool canonical(uint32_t hi32, uint32_t lo32, Key& k) {
  uint32_t rhi = rev2(~lo32), rlo = rev2(~hi32);
  bool fwd_le = hi32 < rhi || (hi32 == rhi && lo32 <= rlo);
  uint32_t chi = fwd_le ? hi32 : rhi;
  uint32_t clo = fwd_le ? lo32 : rlo;
  k.pre = chi >> 8;
  k.hi8 = chi & 0xFFu;
  k.lo = clo;
  k.klo = static_cast<int32_t>(clo);
  k.khi = static_cast<int32_t>(chi);
  return fwd_le;
}

// The folded two-mix hash of the first-level tables (c1 bucket, d1 seed).
__device__ __forceinline__ uint32_t fold_hash(const Key& k) {
  uint32_t h1 = mix32(k.pre, k.hi8, k.lo);
  uint32_t hb = mix32(k.pre, k.hi8, k.lo ^ 0x6A09E667u);
  return h1 ^ ((hb << 15) | (hb >> 17));
}

// The raw value of a slot: narrow (CPS 3) a = (ix_c+1) | (ix_rc+1)<<16 and
// b = 0; wide (CPS 4) a = ix_c+1, b = ix_rc+1.  (0, 0) = no entry.
struct Raw {
  int32_t a, b;
  __device__ __forceinline__ bool miss() const { return (a | b) == 0; }
};

// Slot compare over one gathered row of `nslots` entries of CPS columns
// (key_lo, key_hi, value[, value]): a slot matches on both key words and a
// non-zero value; a later matching slot wins (probe_rows' where-chain).
template <int CPS>
__device__ __forceinline__ Raw probe_row(const int32_t* row, int nslots, const Key& k) {
  Raw r{0, 0};
  for (int s = 0; s < nslots; ++s) {
    const int32_t* e = row + CPS * s;
    int32_t a = e[2];
    int32_t b = CPS == 4 ? e[3] : 0;
    if (e[0] == k.klo && e[1] == k.khi && (a | b) != 0) r = Raw{a, b};
  }
  return r;
}

// Decode one window's raw value and write its ids: with RC [ix_a | ix_b]
// rows of 2W (canonical word's id, then its RC's), else the forward-strand
// id in rows of W.  A miss or an invalid window writes bad_ix.
template <int CPS>
__device__ __forceinline__ void write_ids(int32_t* out, int64_t b, int32_t W,
                                          int32_t w, bool valid, bool fwd_le,
                                          Raw r, int32_t do_rc, int32_t bad_ix) {
  int32_t ia = bad_ix, ib = bad_ix;
  if (valid) {
    int32_t va, vb;
    if (CPS == 4) {
      va = r.a - 1;
      vb = r.b - 1;
    } else {
      uint32_t vu = static_cast<uint32_t>(r.a);
      va = static_cast<int32_t>(vu & 0xFFFFu) - 1;
      vb = static_cast<int32_t>(vu >> 16) - 1;
    }
    if (do_rc) {
      ia = va >= 0 ? va : bad_ix;
      ib = vb >= 0 ? vb : bad_ix;
    } else {
      int32_t f = fwd_le ? va : vb;
      ia = f >= 0 ? f : bad_ix;
    }
  }
  if (do_rc) {
    out[b * 2 * W + w] = ia;
    out[b * 2 * W + W + w] = ib;
  } else {
    out[b * W + w] = ia;
  }
}

}  // namespace kmer
