// The front half shared by the 64-mer probe kernels (K5 scan_probe64, K6
// ladder_probe64, K9 xtree_probe): one (read, window) of an ASCII read ->
// its four-lane 64-mer, the lex-min canonical key, the mix4 hashes the
// 64-mer placement uses, the 6-column slot compare over one gathered row,
// and the decode into per-window label ids.  K5 and K6 cut their windows
// from a staged tile (staged_lane) and read their rows as 16 B loads
// (probe_row16); K9 cuts its k-mers of 14-31 bases from a staged tile too
// (staged_kmer).
//
// Twins (utree_tpu/lookup.py): base_codes :31 with its _DEV_CODE table :23,
// extract_windows64 :395 (window_at, staged_lane), utree_tpu/xtree/
// device.py's _extract_windows_k :120 (kmer_at, staged_kmer), rc_lanes64
// :412 and _canonicalize64 :421 (canonical), _probe64 :442 (probe_row,
// probe_row16),
// the decode of lookup_kmers_canonical64 :513-518 / lookup_kmers_displaced64
// :560-565 and search_step's [ix_a | ix_b] concat :613 (write_ids); mix4 is
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

// ---- staged ASCII windows (K5, K6) ------------------------------------------
// A block takes a tile of consecutive lanes p = b*W + w of a (B, L) ASCII
// matrix (W = L - 63), stages the bytes its lanes need, decoded once, into
// shared memory (`stage_ascii`), and cuts each lane's four lanes from them
// with funnel shifts (`staged_lane`): eight shared loads a lane where
// window_at makes 64 byte loads and 64 decodes.

// Four ASCII bytes (the first at the lowest address) -> their 2-bit codes
// MSB-first in the low 8 bits (an invalid byte codes 0) and their validity
// bits MSB-first in the low 4 (ACGT or acgt: base_code below 4).
__device__ __forceinline__ void decode4(uint32_t x, uint32_t& codes, uint32_t& ok) {
  const uint32_t l = x | 0x20202020u;  // A/a -> a, ...; nothing else -> acgt
  const uint32_t m = __vcmpeq4(l, 0x61616161u) | __vcmpeq4(l, 0x63636363u) |
                     __vcmpeq4(l, 0x67676767u) | __vcmpeq4(l, 0x74747474u);
  const uint32_t c = ((l >> 1) ^ (l >> 2)) & 0x03030303u & m;  // a0 c1 g2 t3
  codes = ((c << 6) & 0xC0u) | ((c >> 4) & 0x30u) | ((c >> 14) & 0x0Cu) | (c >> 24);
  ok = ((m << 3) & 8u) | ((m >> 6) & 4u) | ((m >> 15) & 2u) | (m >> 31);
}

// Stage bytes [g0, g1] of `src`, from the 16 B boundary at or below g0, as
// 32 B chunks, one a thread of NT: chunk c becomes code words 2c and 2c+1
// (16 bases each, MSB-first) and validity word c (32 bases, MSB-first).  One
// zero chunk follows them; the caller checks that they fit.  Returns base,
// the offset of the first staged byte.  A 16 B load that starts past g1 is
// not made; one that starts at or before it lies in the 16 B-aligned block
// of an in-bounds byte.
template <int NT>
__device__ __forceinline__ int64_t stage_ascii(const uint8_t* src, int64_t g0, int64_t g1,
                                               uint32_t* codes, uint32_t* valid) {
  const int64_t base = g0 - static_cast<int64_t>(reinterpret_cast<uintptr_t>(src + g0) & 15);
  const int nchunks = static_cast<int>((g1 - base) >> 5) + 1;
  for (int c = threadIdx.x; c <= nchunks; c += NT) {
    uint32_t cw[2] = {0u, 0u}, vw = 0u;
    if (c < nchunks) {
      const int4* q = reinterpret_cast<const int4*>(src + base) + 2 * c;
      const int4 a = __ldg(q);
      const int4 b = base + 32 * c + 16 <= g1 ? __ldg(q + 1) : make_int4(0, 0, 0, 0);
      const uint32_t x[8] = {static_cast<uint32_t>(a.x), static_cast<uint32_t>(a.y),
                             static_cast<uint32_t>(a.z), static_cast<uint32_t>(a.w),
                             static_cast<uint32_t>(b.x), static_cast<uint32_t>(b.y),
                             static_cast<uint32_t>(b.z), static_cast<uint32_t>(b.w)};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        uint32_t cd, ok;
        decode4(x[i], cd, ok);
        cw[i >> 2] |= cd << (8 * (3 - (i & 3)));
        vw |= ok << (4 * (7 - i));
      }
    }
    codes[2 * c] = cw[0];
    codes[2 * c + 1] = cw[1];
    valid[c] = vw;
  }
  return base;
}

// One lane of a staged 64-mer tile: its read and window, whether it lies in
// the grid (live) and is valid, and its four lanes (meaningful only when
// valid).
struct Lane {
  int64_t b;
  int32_t w;
  bool live, valid;
  uint32_t k[4];
};

// The tile of NT lanes from p0 of a (B, W) grid of P lanes over a (B, L)
// ASCII matrix, one lane a thread: thread t's lane is p0 + t.  The bytes
// the tile's lanes read are staged (stage_ascii) where they fit, with the
// zero chunk, in `chunks` chunks of 32 B (codes: 2 * chunks words, valid:
// chunks), which they do unless W is far below L; otherwise the lane reads
// its bases with window_at.  A window is valid when its 64 bytes are bases
// and w + 63 < len, which is window_at's test.  Synchronises the block
// once.
template <int NT>
__device__ __forceinline__ Lane staged_lane(const uint8_t* reads, const int32_t* lens,
                                            int64_t P, int64_t L, int32_t W, int64_t p0,
                                            uint32_t* codes, uint32_t* valid, int chunks) {
  const int64_t p1 = (p0 + NT < P ? p0 + NT : P) - 1;
  const int64_t b0 = p0 / W, b1 = p1 / W;
  const int64_t g0 = b0 * L + (p0 - b0 * W), g1 = b1 * L + (p1 - b1 * W) + 63;
  const bool staged = ((g1 - g0 + 15) >> 5) + 2 <= chunks;
  int64_t base = 0;
  if (staged) base = stage_ascii<NT>(reads, g0, g1, codes, valid);
  __syncthreads();
  Lane l{0, 0, p0 + threadIdx.x < P, false, {0u, 0u, 0u, 0u}};
  if (l.live) {
    const int32_t q = static_cast<int32_t>(p0 + threadIdx.x - b0 * W);  // < NT + W
    const int32_t bl = q / W;
    l.b = b0 + bl;
    l.w = q - bl * W;
    const int32_t len = lens[l.b];
    if (staged) {
      const int o = static_cast<int>(l.b * L + l.w - base);
      const int j = o >> 4, r = 2 * (o & 15);
#pragma unroll
      for (int i = 0; i < 4; ++i) l.k[i] = __funnelshift_l(codes[j + i + 1], codes[j + i], r);
      const int jv = o >> 5, s = o & 31;
      const uint32_t v0 = __funnelshift_l(valid[jv + 1], valid[jv], s);
      const uint32_t v1 = __funnelshift_l(valid[jv + 2], valid[jv + 1], s);
      l.valid = (v0 & v1) == 0xFFFFFFFFu && l.w + 63 < len;
    } else {
      l.valid = window_at(reads + l.b * L, len, l.w, l.k);
    }
  }
  return l;
}

// ---- staged k-mers of 14-31 bases (K9) -------------------------------------
// The same staging for the windows of k <= 31 bases of a (B, T) ASCII
// matrix (W = T - k + 1): a lane's k bases lie in at most three staged code
// words, cut with two funnel shifts into one 64-bit word.

// One lane of a staged k-mer tile: its row and window, whether it lies in
// the grid (live) and is valid, and its word x: the k bases MSB-first in
// the low 2k bits, a base that is not ACGT, or lies at or past the row's
// length, coded 0 (extract_windows_k's masked codes, which the prefix bins
// of an invalid window are taken from).
struct Kmer {
  int64_t b;
  int32_t w;
  bool live, valid;
  uint64_t x;
};

// The k bases at w..w+k-1 of one ASCII row, a byte load each.
__device__ __forceinline__ bool kmer_at(const uint8_t* row, int32_t len, int32_t w, int k,
                                        uint64_t& x) {
  x = 0;
  bool valid = true;
  for (int j = 0; j < k; ++j) {
    const int p = w + j;
    const uint32_t code = base_code(row[p]);
    const bool ok = code < 4u && p < len;
    valid &= ok;
    x = (x << 2) | (ok ? code : 0u);
  }
  return valid;
}

// The tile of NT lanes from p0 of a (B, W) grid of P lanes over a (B, T)
// ASCII matrix, one lane a thread, as staged_lane cuts 64-mers: the bytes
// are staged where they fit in `chunks` chunks (they do unless W is a few
// windows), else the lane reads them with kmer_at.  A staged decode codes
// a base past the length as the base it is, so the cut zeroes the bases
// from len - w on.  Synchronises the block once.
template <int NT>
__device__ __forceinline__ Kmer staged_kmer(const uint8_t* reads, const int32_t* lens,
                                            int64_t P, int64_t T, int32_t W, int k, int64_t p0,
                                            uint32_t* codes, uint32_t* valid, int chunks) {
  const int64_t p1 = (p0 + NT < P ? p0 + NT : P) - 1;
  const int64_t b0 = p0 / W, b1 = p1 / W;
  const int64_t g0 = b0 * T + (p0 - b0 * W), g1 = b1 * T + (p1 - b1 * W) + k - 1;
  const bool staged = ((g1 - g0 + 15) >> 5) + 2 <= chunks;
  int64_t base = 0;
  if (staged) base = stage_ascii<NT>(reads, g0, g1, codes, valid);
  __syncthreads();
  Kmer l{0, 0, p0 + threadIdx.x < P, false, 0ull};
  if (l.live) {
    const int32_t q = static_cast<int32_t>(p0 + threadIdx.x - b0 * W);  // < NT + W
    const int32_t bl = q / W;
    l.b = b0 + bl;
    l.w = q - bl * W;
    const int32_t len = lens[l.b];
    if (staged) {
      const int o = static_cast<int>(l.b * T + l.w - base);
      const int j = o >> 4, r = 2 * (o & 15);
      const uint32_t x0 = __funnelshift_l(codes[j + 1], codes[j], r);      // bases 0..15
      const uint32_t x1 = __funnelshift_l(codes[j + 2], codes[j + 1], r);  // 16..31
      const uint64_t x = ((static_cast<uint64_t>(x0) << 32) | x1) >> (64 - 2 * k);
      const int jv = o >> 5;
      const uint32_t ok = __funnelshift_l(valid[jv + 1], valid[jv], o & 31) >> (32 - k);
      const int32_t m = len - l.w;  // the window's bases before the length
      l.x = m >= k ? x : m <= 0 ? 0ull : x & (~0ull << (2 * (k - m)));
      l.valid = ok == (1u << k) - 1u && m >= k;
    } else {
      l.valid = kmer_at(reads + l.b * T, len, l.w, k, l.x);
    }
  }
  return l;
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

// probe_row over a row that starts on a 16 B boundary, read as 16 B loads,
// three a pair of slots (48 B), where the slot count is even; a row of an
// odd slot count is read slot by slot (probe_row).  The caller checks the
// table's alignment.
__device__ __forceinline__ kmer::Raw probe_row16(const int32_t* row, int nslots, const Key& k) {
  if (nslots & 1) return probe_row(row, nslots, k);
  kmer::Raw r{0, 0};
  const int4* q = reinterpret_cast<const int4*>(row);
  for (int s = 0; s < nslots; s += 2, q += 3) {
    // slots s and s+1: (k0 k1 k2 k3) (va vb) | (k0 k1) (k2 k3 va vb)
    const int4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
    if (a.x == k.ci[0] && a.y == k.ci[1] && a.z == k.ci[2] && a.w == k.ci[3] &&
        (b.x | b.y) != 0)
      r = kmer::Raw{b.x, b.y};
    if (b.z == k.ci[0] && b.w == k.ci[1] && c.x == k.ci[2] && c.y == k.ci[3] &&
        (c.z | c.w) != 0)
      r = kmer::Raw{c.z, c.w};
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
