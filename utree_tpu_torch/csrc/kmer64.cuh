// The front half shared by the 64-mer probe kernels (K5 scan_probe64, K6
// ladder_probe64): one (read, window) of an ASCII read -> its four-lane
// 64-mer, the lex-min canonical key, the mix4 hashes the 64-mer placement
// uses, the 6-column slot compare over one gathered row, and the decode into
// per-window label ids.
//
// Twins (utree_tpu/lookup.py): base_codes :31 with its _DEV_CODE table :23,
// extract_windows64 :395 (window_at), rc_lanes64 :412 and _canonicalize64
// :421 (canonical), _probe64 :442 (probe_row), the decode of
// lookup_kmers_canonical64 :513-518 / lookup_kmers_displaced64 :560-565 and
// search_step's [ix_a | ix_b] concat :613 (write_ids); mix4 is
// utree_tpu/hash_index64.py:30.  Arithmetic is true uint32, wrapping exactly
// as the jnp.uint32 code.
#pragma once

#include "kmer.cuh"

namespace kmer64 {

// _DEV_CODE: A/a=0, C/c=1, G/g=2, T/t=3; any other byte is invalid (4).
__device__ __forceinline__ uint32_t base_code(uint8_t ch) {
  switch (ch) {
    case 'A': case 'a': return 0u;
    case 'C': case 'c': return 1u;
    case 'G': case 'g': return 2u;
    case 'T': case 't': return 3u;
    default: return 4u;
  }
}

// The 64 bases at w..w+63 of one ASCII row, MSB-first 2 bits each: k[0] =
// bases 0..15, ..., k[3] = bases 48..63.  A base that is not ACGT, or lies
// past the read's length, codes 0 and makes the window invalid.
__device__ __forceinline__ bool window_at(const uint8_t* row, int32_t len,
                                          int32_t w, uint32_t k[4]) {
  bool valid = true;
#pragma unroll
  for (int lane = 0; lane < 4; ++lane) {
    uint32_t x = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      int p = w + 16 * lane + j;
      uint32_t code = base_code(row[p]);
      bool ok = code < 4u && p < len;
      valid &= ok;
      x |= (ok ? code : 0u) << (2 * (15 - j));
    }
    k[lane] = x;
  }
  return valid;
}

// A canonical 64-mer key: its u32 lanes and their int32 bits (the table's).
struct Key {
  uint32_t c[4];
  int32_t ci[4];
};

// rc(k0:k1:k2:k3) = rev2(~k3):rev2(~k2):rev2(~k1):rev2(~k0).  The key is the
// lexicographic minimum of the word and its RC, k0 most significant, compared
// unsigned (ties keep the word).  Returns fwd_le, which picks the
// forward-strand id without RC.
__device__ __forceinline__ bool canonical(const uint32_t k[4], Key& key) {
  uint32_t r[4] = {kmer::rev2(~k[3]), kmer::rev2(~k[2]), kmer::rev2(~k[1]),
                   kmer::rev2(~k[0])};
  bool le = k[3] <= r[3];
#pragma unroll
  for (int i = 2; i >= 0; --i) le = k[i] < r[i] || (k[i] == r[i] && le);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    key.c[i] = le ? k[i] : r[i];
    key.ci[i] = static_cast<int32_t>(key.c[i]);
  }
  return le;
}

__device__ __forceinline__ uint32_t mix4(const Key& k, uint32_t seed) {
  uint32_t h = (k.c[0] ^ seed) * 0x9E3779B1u;
  h ^= h >> 16;
  h += k.c[1] * 0xC2B2AE35u;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h ^= k.c[2] * 0x9E3779B1u;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  h += k.c[3] * 0x85EBCA6Bu;
  h ^= h >> 15;
  return h;
}

// The folded two-mix hash of the first-level tables (c64_1 bucket, d64 seed).
__device__ __forceinline__ uint32_t fold_hash(const Key& k) {
  uint32_t h1 = mix4(k, 0u);
  uint32_t hb = mix4(k, 0x6A09E667u);
  return h1 ^ ((hb << 15) | (hb >> 17));
}

// Slot compare over one gathered row of `nslots` 6-column entries
// (k0, k1, k2, k3, va, vb): a slot matches on all four key words and
// (va | vb) != 0; a later matching slot wins (_probe64's where-chain).
__device__ __forceinline__ kmer::Raw probe_row(const int32_t* row, int nslots,
                                               const Key& k) {
  kmer::Raw r{0, 0};
  for (int s = 0; s < nslots; ++s) {
    const int32_t* e = row + 6 * s;
    int32_t a = e[4], b = e[5];
    if (e[0] == k.ci[0] && e[1] == k.ci[1] && e[2] == k.ci[2] &&
        e[3] == k.ci[3] && (a | b) != 0)
      r = kmer::Raw{a, b};
  }
  return r;
}

// Decode one window's (va, vb) and write its ids: `valid & (v > 0) ? v-1 :
// miss`, v signed as in JAX.  With RC [ix_a | ix_b] rows of 2W, else the
// forward-strand id in rows of W.
__device__ __forceinline__ void write_ids(int32_t* out, int64_t b, int32_t W,
                                          int32_t w, bool valid, bool fwd_le,
                                          kmer::Raw r, int32_t do_rc,
                                          int32_t miss) {
  if (do_rc) {
    out[b * 2 * W + w] = valid && r.a > 0 ? r.a - 1 : miss;
    out[b * 2 * W + W + w] = valid && r.b > 0 ? r.b - 1 : miss;
  } else {
    int32_t f = fwd_le ? r.a : r.b;
    out[b * W + w] = valid && f > 0 ? f - 1 : miss;
  }
}

}  // namespace kmer64
