// The front half shared by the probe kernels (K1 scan_probe, K4
// ladder_probe, K7 bsearch_probe, K9 xtree_probe, K10 hash_probe, K15
// bsearch_probe_shard, and the routed shards' K11-K13, K17, K18; K1 and K4
// take the staged windows (staged_front), the two-slot rows loaded as
// vectors (Row2) and the tails, K11 and K15 the staged windows (K15 with
// rev2); K7 and K10 take window_at, K7 rev2 too, K9 the key's hashes, the
// wide rows as vectors and t3_tail, K10 mix32, K12 displaced_slot and the
// rows as vectors, K13 t3_tail and write_ids, K17 the rows as vectors or
// probe_row, K18 c2_tail, t3_tail and write_ids): one (read, window) ->
// its canonical 32-mer key, the 32-bit mixes the table placement uses, the
// slot compare over one gathered row, the displaced-table probe, and the
// dual-value decode into per-window label ids.
//
// Twins (utree_tpu/lookup.py): base_codes_packed :39 + extract_windows :83
// (window_at), _rev2_32 :113, rc_word_lanes :123 and canonical_keys :243
// (canonical), _mix_jnp :188 (mix32), probe_rows :292 / probe_rows_wide :306
// (probe_row), displaced_probe_raw :887 (displaced_slot, load_row2,
// match_row2, t3_tail),
// decode_canonical_vals :335 / decode_canonical_wide :322 and
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

// ---- staged windows (K1, K4, K11) ------------------------------------------
// A block takes a tile of consecutive lanes p = b*W + w, stages the packed
// bytes and validity bits its lanes need into shared memory as aligned words
// (`stage`), and cuts each lane's 32 bases from them with byte permutes and
// funnel shifts (`staged_window`): seven shared loads a lane where window_at
// makes 64 byte loads.

// The bytes lanes [p0, p1] of a (B, W) window grid need, for reads of row4
// packed and row8 validity bytes: b0 is the first lane's read.
struct Span {
  int64_t b0, pk0, pk1, vb0, vb1;
};

__device__ __forceinline__ Span span_of(int64_t p0, int64_t p1, int32_t W, int64_t row4,
                                        int64_t row8) {
  const int64_t b0 = p0 / W, b1 = p1 / W, w0 = p0 - b0 * W, w1 = p1 - b1 * W;
  return Span{b0, b0 * row4 + (w0 >> 2), b1 * row4 + ((w1 + 31) >> 2),
              b0 * row8 + (w0 >> 3), b1 * row8 + ((w1 + 31) >> 3)};
}

// The shared words `stage` writes for bytes [g0, g1]: the words that hold
// them (one more for the alignment) and three words of slack.
__device__ __forceinline__ int64_t staged_words(int64_t g0, int64_t g1) {
  return ((g1 - g0 + 3) >> 2) + 4;
}

// Copy bytes [g0, g1] of `src` into `dst` as the aligned words that hold
// them, NT threads a block; returns the byte offset of dst[0] relative to
// src (<= g0).  The three words after them are zeroed.
template <int NT>
__device__ __forceinline__ int64_t stage(const uint8_t* src, int64_t g0, int64_t g1,
                                         uint32_t* dst) {
  const int64_t lead = static_cast<int64_t>(reinterpret_cast<uintptr_t>(src + g0) & 3);
  const int64_t base = g0 - lead;
  const int nwords = static_cast<int>((g1 - base) >> 2) + 1;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(src + base);
  for (int k = threadIdx.x; k < nwords + 3; k += NT) dst[k] = k < nwords ? w[k] : 0u;
  return base;
}

// The bytes o..o+3 of the staged words as a big-endian word: 32 bits of
// the MSB-first stream the packed bases and validity bits make.
__device__ __forceinline__ uint32_t be32(const uint32_t* s, int o) {
  const uint32_t sel = 0x0123u + 0x1111u * static_cast<uint32_t>(o & 3);
  return __byte_perm(s[o >> 2], s[(o >> 2) + 1], sel);
}

// window_at on staged words: o and ov are the offsets of the window's first
// packed and validity bytes in spk and svb.  hi32/lo32 are the window's
// bases; they are meaningful only when it is valid (every base valid and
// w + 31 < len).
__device__ __forceinline__ bool staged_window(const uint32_t* spk, const uint32_t* svb,
                                              int o, int ov, int32_t w, int32_t len,
                                              uint32_t& hi32, uint32_t& lo32) {
  const uint32_t x0 = be32(spk, o), x1 = be32(spk, o + 4), x2 = be32(spk, o + 8);
  const int r2 = 2 * (w & 3);
  hi32 = __funnelshift_l(x1, x0, r2);
  lo32 = __funnelshift_l(x2, x1, r2);
  const uint32_t ok = __funnelshift_l(be32(svb, ov + 4), be32(svb, ov), w & 7);
  return ok == 0xFFFFFFFFu && w + 31 < len;
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

// The key of a (key_lo, key_hi) pair of int32 lanes, as the routed shards
// carry it (routed.py's send buffer).
__device__ __forceinline__ Key key_of(int32_t klo, int32_t khi) {
  Key k;
  k.pre = static_cast<uint32_t>(khi) >> 8;
  k.hi8 = static_cast<uint32_t>(khi) & 0xFFu;
  k.lo = static_cast<uint32_t>(klo);
  k.klo = klo;
  k.khi = khi;
  return k;
}

// The d1 slot of a key whose bucket's seed word is `word` (four u8 seeds).
__device__ __forceinline__ uint32_t displaced_slot(const Key& k, uint32_t bkt, uint32_t word,
                                                   int64_t nslots) {
  uint32_t seed = (word >> ((bkt & 3u) << 3)) & 0xFFu;
  uint32_t u2 = mix32(k.pre, k.hi8, k.lo ^ 0x94D049BBu);
  uint32_t ub = mix32(k.pre, k.hi8 ^ 0xA5u, k.lo ^ 0x7FEB352Du);
  uint32_t h = ((u2 ^ (seed * 0x85EBCA6Bu)) * 0xC2B2AE35u) ^
               ((ub ^ (seed * 0xC2B2AE35u)) * 0x85EBCA6Bu);
  return h % static_cast<uint32_t>(nslots);
}

// The tails update `r` in place: taking and returning a Raw by value gave
// K4 a longer, slower schedule than the same lines written inline, whose
// SASS this form reproduces.
//
// The ladder's second level (lookup_kmers_canonical's c2 line, the routed
// canonical steps' _tail_probe): on a miss, one c2 row at the key's c2
// bucket, unless c2 is the 8-row "absent" sentinel.
template <int CPS>
__device__ __forceinline__ void c2_tail(Raw& r, const Key& k, const int32_t* c2, int64_t n2,
                                        int32_t s2) {
  if (r.miss() && n2 > 8) {
    uint32_t b2 = mix32(k.pre, k.hi8, k.lo ^ 0x5BD1E995u) & static_cast<uint32_t>(n2 - 1);
    r = probe_row<CPS>(c2 + static_cast<int64_t>(b2) * CPS * s2, s2, k);
  }
}

// The cached spill tail (_displaced_t3_tail; the ladder's c3 level and the
// routed canonical steps' t3, whose bucket is the same mix): on a miss, one
// d3 row, unless d3 is the 8-row "absent" sentinel.
template <int CPS>
__device__ __forceinline__ void t3_tail(Raw& r, const Key& k, const int32_t* d3, int64_t n3,
                                        int32_t s3) {
  if (r.miss() && n3 > 8) {
    uint32_t b3 = mix32(k.pre, k.hi8, k.lo ^ 0x27D4EB2Fu) & static_cast<uint32_t>(n3 - 1);
    r = probe_row<CPS>(d3 + static_cast<int64_t>(b3) * CPS * s3, s3, k);
  }
}

// A two-slot first-level row (d1, or a c1 of tier A) in registers, loaded
// with vector loads: 24 B as three 8 B loads (narrow; the table 8 B
// aligned), 32 B as two 16 B loads (wide; 16 B aligned).  The caller checks
// the alignment.
template <int CPS>
struct Row2 {
  int32_t v[2 * CPS];
};

template <int CPS>
__device__ __forceinline__ Row2<CPS> load_row2(const int32_t* row) {
  Row2<CPS> r;
  if constexpr (CPS == 4) {
    const int4* q = reinterpret_cast<const int4*>(row);
    const int4 a = __ldg(q), b = __ldg(q + 1);
    r = Row2<CPS>{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
  } else {
    const int2* q = reinterpret_cast<const int2*>(row);
    const int2 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
    r = Row2<CPS>{{a.x, a.y, b.x, b.y, c.x, c.y}};
  }
  return r;
}

// probe_row over a loaded two-slot row.
template <int CPS>
__device__ __forceinline__ Raw match_row2(const Row2<CPS>& row, const Key& k) {
  Raw r{0, 0};
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int32_t* e = row.v + CPS * s;
    const int32_t a = e[2], b = CPS == 4 ? e[3] : 0;
    if (e[0] == k.klo && e[1] == k.khi && (a | b) != 0) r = Raw{a, b};
  }
  return r;
}

// One lane of a staged probe: its read and window, whether it lies in the
// grid (live) and is valid, and its canonical key (zero unless valid).
struct Window {
  int64_t b;
  int32_t w;
  bool live, valid, fwd_le;
  Key k;
};

// The front half of K1 and K4 for the tile of NT lanes from p0 of a (B, W)
// grid of P lanes, one lane a thread: thread t's lane is p0 + t.  The
// tile's packed and validity bytes are staged into spk and svb (pkw and
// vbw words) where they fit, which they do unless W is far below the packed
// width (a true_len trim to a few windows); otherwise the lane reads its
// bases with window_at.  Synchronises the block once.
template <int NT>
__device__ __forceinline__ Window staged_front(const uint8_t* packed, const uint8_t* vbits,
                                               const int32_t* lens, int64_t P, int64_t row4,
                                               int64_t row8, int32_t W, int64_t p0,
                                               uint32_t* spk, int pkw, uint32_t* svb,
                                               int vbw) {
  const int64_t p1 = (p0 + NT < P ? p0 + NT : P) - 1;
  const Span sp = span_of(p0, p1, W, row4, row8);
  const bool staged =
      staged_words(sp.pk0, sp.pk1) <= pkw && staged_words(sp.vb0, sp.vb1) <= vbw;
  int64_t pbase = 0, vbase = 0;
  if (staged) {
    pbase = stage<NT>(packed, sp.pk0, sp.pk1, spk);
    vbase = stage<NT>(vbits, sp.vb0, sp.vb1, svb);
  }
  __syncthreads();
  Window l{0, 0, p0 + threadIdx.x < P, false, true, Key{0, 0, 0, 0, 0}};
  if (l.live) {
    const int32_t q = static_cast<int32_t>(p0 + threadIdx.x - sp.b0 * W);  // < NT + W
    const int32_t bl = q / W;
    l.b = sp.b0 + bl;
    l.w = q - bl * W;
    const int64_t pk = l.b * row4 + (l.w >> 2), vb = l.b * row8 + (l.w >> 3);
    uint32_t hi32, lo32;
    l.valid = staged ? staged_window(spk, svb, static_cast<int>(pk - pbase),
                                     static_cast<int>(vb - vbase), l.w, lens[l.b], hi32, lo32)
                     : window_at(packed + l.b * row4, vbits + l.b * row8, lens[l.b], l.w,
                                 hi32, lo32);
    if (l.valid) l.fwd_le = canonical(hi32, lo32, l.k);
  }
  return l;
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
