// K1 scan_probe: 2-bit packed reads -> per-window label ids over the
// seeded-displacement table.
//
// Replaces (utree_tpu/lookup.py): base_codes_packed :39, extract_windows :83,
// _rev2_32 :113, rc_word_lanes :123, canonical_keys :243, _mix_jnp :188,
// displaced_bucket/seed/slot_jnp :850-884, canonical_bucket3 :281,
// probe_rows :292, displaced_probe_raw :887 (narrow rows),
// decode_canonical_vals :335 and the [ix_a | ix_b] concat of
// _canonical_family_ix :921, including _packed_window_ix's true_len trim.
//
// Bound: each window is one chain of dependent loads -- the u8 seed word
// (the seed table is <= 32 MB, so it stays in the 50 MB L2), then one random
// 24 B two-slot row of d1 in HBM, then on a miss the small cached d3 tail.
// Arithmetic (two 32-bit mixes per hash, ~60 integer ops per window) is
// negligible beside the random row read.
//
// Design: one thread per (read, window), so the B*W row reads are all in
// flight at once and latency is hidden by occupancy rather than by a
// software pipeline.  Each thread rebuilds its 32 bases straight from the
// packed bytes (neighbouring threads read the same bytes, which L1 serves),
// so no (B, W) lane arrays ever reach device memory.  Invalid windows write
// bad_ix without touching the table: JAX probes bucket 0 for them and then
// discards the value (lookup.py:860,884,342), so the ids are identical.
// Arithmetic is true uint32, wrapping exactly as the jnp.uint32 code.

#include "common.cuh"

namespace {

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

// Slot compare over one gathered row of `nslots` (key_lo, key_hi, val)
// entries; a later matching slot wins, as in probe_rows' where-chain.
__device__ __forceinline__ int32_t probe_row(const int32_t* row, int nslots,
                                             int32_t klo, int32_t khi) {
  int32_t val = 0;
  for (int s = 0; s < nslots; ++s) {
    int32_t v = row[3 * s + 2];
    if (row[3 * s] == klo && row[3 * s + 1] == khi && v != 0) val = v;
  }
  return val;
}

__global__ void scan_probe_kernel(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ vbits,
    const int32_t* __restrict__ lens, int64_t B, int64_t row4, int64_t row8,
    int32_t W, const int32_t* __restrict__ d1, int64_t nslots,
    const int32_t* __restrict__ ds, int64_t nseed,
    const int32_t* __restrict__ d3, int64_t n3, int32_t s3,
    int32_t do_rc, int32_t bad_ix, int32_t* __restrict__ out) {
  int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= B * W) return;
  int64_t b = t / W;
  int32_t w = static_cast<int32_t>(t - b * W);
  const uint8_t* pk = packed + b * row4;
  const uint8_t* vb = vbits + b * row8;
  int32_t len = lens[b];

  // 32 bases at w..w+31, MSB-first 2 bits each: hi32 = bases 0..15
  // (prefix24 << 8 | hi8), lo32 = bases 16..31.  Invalid bases code 0.
  uint32_t hi32 = 0, lo32 = 0;
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

  int32_t ia = bad_ix, ib = bad_ix;
  bool fwd_le = true;
  if (valid) {
    // reverse complement on the lanes: rc(hi32:lo32) = rev2(~lo32):rev2(~hi32)
    uint32_t rhi = rev2(~lo32), rlo = rev2(~hi32);
    fwd_le = hi32 < rhi || (hi32 == rhi && lo32 <= rlo);
    uint32_t chi = fwd_le ? hi32 : rhi;
    uint32_t clo = fwd_le ? lo32 : rlo;
    uint32_t cpre = chi >> 8, chi8 = chi & 0xFFu;
    int32_t klo = static_cast<int32_t>(clo), khi = static_cast<int32_t>(chi);

    uint32_t h1 = mix32(cpre, chi8, clo);
    uint32_t hb = mix32(cpre, chi8, clo ^ 0x6A09E667u);
    uint32_t g = h1 ^ ((hb << 15) | (hb >> 17));
    uint32_t bkt = g & static_cast<uint32_t>(nseed - 1);
    uint32_t seed = (static_cast<uint32_t>(ds[bkt >> 2]) >> ((bkt & 3u) << 3)) & 0xFFu;
    uint32_t u2 = mix32(cpre, chi8, clo ^ 0x94D049BBu);
    uint32_t ub = mix32(cpre, chi8 ^ 0xA5u, clo ^ 0x7FEB352Du);
    uint32_t h = ((u2 ^ (seed * 0x85EBCA6Bu)) * 0xC2B2AE35u) ^
                 ((ub ^ (seed * 0xC2B2AE35u)) * 0x85EBCA6Bu);
    uint32_t slot = h % static_cast<uint32_t>(nslots);
    int32_t val = probe_row(d1 + static_cast<int64_t>(slot >> 1) * 6, 2, klo, khi);
    if (val == 0 && n3 > 8) {
      uint32_t b3 = mix32(cpre, chi8, clo ^ 0x27D4EB2Fu) & static_cast<uint32_t>(n3 - 1);
      val = probe_row(d3 + static_cast<int64_t>(b3) * 3 * s3, s3, klo, khi);
    }
    uint32_t vu = static_cast<uint32_t>(val);
    int32_t va = static_cast<int32_t>(vu & 0xFFFFu) - 1;  // ix of the canonical word
    int32_t vbb = static_cast<int32_t>(vu >> 16) - 1;     // ix of its RC
    if (do_rc) {
      ia = va >= 0 ? va : bad_ix;
      ib = vbb >= 0 ? vbb : bad_ix;
    } else {
      int32_t f = fwd_le ? va : vbb;
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

}  // namespace

extern "C" int utree_scan_probe(
    const void* packed, const void* vbits, const void* lens, int64_t B,
    int64_t row4, int64_t row8, int32_t W, const void* d1, int64_t nslots,
    const void* ds, int64_t nseed, const void* d3, int64_t n3, int32_t s3,
    int32_t do_rc, int32_t bad_ix, void* out, void* stream) {
  const int threads = 256;
  int64_t n = B * W;
  if (n > 0) {
    scan_probe_kernel<<<utree_blocks(n, threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed), static_cast<const uint8_t*>(vbits),
        static_cast<const int32_t*>(lens), B, row4, row8, W,
        static_cast<const int32_t*>(d1), nslots, static_cast<const int32_t*>(ds),
        nseed, static_cast<const int32_t*>(d3), n3, s3, do_rc, bad_ix,
        static_cast<int32_t*>(out));
  }
  UTREE_LAUNCH_RESULT();
}

extern "C" const char* utree_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
