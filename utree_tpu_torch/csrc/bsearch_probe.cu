// K7 bsearch_probe: 2-bit packed reads -> per-window label ids by the literal
// xtSuffixBS replay over the sorted CTR records (PACKSIZE=32, --lookup-mode
// bsearch, and `auto` below 80M records when neither device table builds).
// K15 bsearch_probe_shard: the same replay against one prefix-range slice of
// the records (parallel/sharded.py's prefix-sharded step).
//
// Replaces (utree_tpu/lookup.py): lookup_kmers :149 with _suffix_le :140, and
// _packed_window_ix's non-canonical branch :698-708, which appends the
// arithmetic RC words (rc_word_lanes :123) and probes each word on its own;
// windows come from kmer.cuh's window_at (base_codes_packed :39,
// extract_windows :83), the true_len trim included.  K15 replaces
// _local_lookup (utree_tpu/parallel/sharded.py:130-157) under
// sharded_search_step :160: the prefix is taken relative to the slice's
// first prefix, a word outside the slice's bins (or invalid) misses without
// a table read, and the outputs are where(found, ix, 0) and found, which the
// step sums over the `table` axis.
//
// Bound: each word is a chain of dependent loads -- bin_ix[pre] and
// bin_ix[pre+1] (64 MB, one random sector), then one random (suf_hi, suf_lo)
// pair per halving of the bin, then ix[p].  At 20M records in 2^24 bins a bin
// holds about 1.2 records, so a word costs about three dependent HBM round
// trips; the replay is latency-bound, not bandwidth-bound.  K15 makes that
// trip for the words of its slice only (a quarter of them at S = 4), but
// decodes every window and writes five bytes for each.
//
// Design: one thread per (read, window), doing the forward word and, with
// RC, its RC word, so the B*W chains are all in flight and occupancy hides
// their latency.  The loop runs while the range is non-empty.  JAX runs a
// fixed `probe_iters` = ceil(log2(max bin + 1)) trips instead, but a lane
// whose size reached 0 is frozen there (no branch moves p or size), and
// `probe_iters` trips always empty the largest bin, so both end on the same
// p, on the quirky merged bins too.  A slice keeps the global bins' record
// ranges (its offsets are the global ones less the slice's first record), so
// the same holds for K15.  The clamp `min(p + w + 1, n)` and the final
// `min(p, n)` keep every read inside the n+1 records; for K7 record n is the
// sentinel (suffix 0, id bad_ix), for K15 n is the slice's padded length
// (max_local over the slices, not its own count), so the clamp reads the
// zero-suffix, id-bad_ix padding records exactly where JAX reads them.  K7's
// invalid windows write bad_ix and read no bin (JAX searches bin 0 for them
// and discards the result).

#include "kmer.cuh"

namespace {

struct Records {
  const int32_t* bin_ix;  // bin starts: (2^24 + 1,), or a slice's (nbins + 1,)
  const int32_t* suf_hi;  // (n + 1,) suffix bits 39..32
  const uint32_t* suf_lo; // (n + 1,) suffix bits 31..0
  const int32_t* ix;      // (n + 1,) label ids
  int64_t n;              // index of the sentinel (K7) or last padding record (K15)
};

// The probe sequence over the records [start, end) of a non-empty bin: the
// record it ends on.  The suffix compare is (hi, lo) with lo unsigned.
__device__ __forceinline__ int64_t descend(const Records& t, int64_t start, int64_t end,
                                           int32_t qhi, uint32_t qlo) {
  int64_t p = start;
  int64_t size = end - start - 1;
  while (size > 0) {
    int64_t w = size >> 1;
    int64_t probe = p + w + 1 < t.n ? p + w + 1 : t.n;
    int32_t h = t.suf_hi[probe];
    bool le = h < qhi || (h == qhi && t.suf_lo[probe] <= qlo);
    if (le) {
      p += w + 1;
      size -= w + 1;
    } else {
      size = w;
    }
  }
  return p < t.n ? p : t.n;
}

__device__ __forceinline__ bool matches(const Records& t, int64_t p, int32_t qhi,
                                        uint32_t qlo) {
  return t.suf_hi[p] == qhi && t.suf_lo[p] == qlo;
}

// One word's replay over the whole table: the label id of the record the
// probe sequence ends on, or bad_ix.
__device__ __forceinline__ int32_t replay(const Records& t, bool valid, uint32_t qpre,
                                          int32_t qhi, uint32_t qlo, int32_t bad_ix) {
  if (!valid) return bad_ix;
  int64_t start = t.bin_ix[qpre], end = t.bin_ix[qpre + 1];
  if (start >= end) return bad_ix;
  int64_t p = descend(t, start, end, qhi, qlo);
  return matches(t, p, qhi, qlo) ? t.ix[p] : bad_ix;
}

// One word's replay over a slice of `nbins` bins from prefix `lo`: writes
// where(found, ix, 0) and found.
__device__ __forceinline__ void replay_local(const Records& t, int64_t lo, int64_t nbins,
                                             bool valid, uint32_t qpre, int32_t qhi,
                                             uint32_t qlo, int32_t* ix_out,
                                             uint8_t* found_out) {
  int64_t local = static_cast<int64_t>(qpre) - lo;
  bool found = false;
  int32_t ix = 0;
  if (valid && local >= 0 && local < nbins) {
    int64_t start = t.bin_ix[local], end = t.bin_ix[local + 1];
    if (start < end) {
      int64_t p = descend(t, start, end, qhi, qlo);
      found = matches(t, p, qhi, qlo);
      ix = found ? t.ix[p] : 0;
    }
  }
  *ix_out = ix;
  *found_out = found;
}

__global__ void bsearch_probe_kernel(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ vbits,
    const int32_t* __restrict__ lens, int64_t B, int64_t row4, int64_t row8,
    int32_t W, Records t, int32_t do_rc, int32_t bad_ix,
    int32_t* __restrict__ out) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= B * W) return;
  int64_t b = i / W;
  int32_t w = static_cast<int32_t>(i - b * W);
  uint32_t hi32, lo32;
  bool valid = kmer::window_at(packed + b * row4, vbits + b * row8, lens[b], w,
                               hi32, lo32);
  int32_t fwd = replay(t, valid, hi32 >> 8, static_cast<int32_t>(hi32 & 0xFFu),
                       lo32, bad_ix);
  if (!do_rc) {
    out[b * W + w] = fwd;
    return;
  }
  // rc_word_lanes: rc(hi32:lo32) = rev2(~lo32):rev2(~hi32)
  uint32_t rhi = kmer::rev2(~lo32), rlo = kmer::rev2(~hi32);
  out[b * 2 * W + w] = fwd;
  out[b * 2 * W + W + w] = replay(t, valid, rhi >> 8,
                                  static_cast<int32_t>(rhi & 0xFFu), rlo, bad_ix);
}

}  // namespace

extern "C" int utree_bsearch_probe(
    const void* packed, const void* vbits, const void* lens, int64_t B,
    int64_t row4, int64_t row8, int32_t W, const void* bin_ix,
    const void* suf_hi, const void* suf_lo, const void* ix, int64_t n,
    int32_t do_rc, int32_t bad_ix, void* out, void* stream) {
  const int threads = 256;
  int64_t total = B * W;
  if (total > 0) {
    Records t{static_cast<const int32_t*>(bin_ix), static_cast<const int32_t*>(suf_hi),
              static_cast<const uint32_t*>(suf_lo), static_cast<const int32_t*>(ix), n};
    bsearch_probe_kernel<<<utree_blocks(total, threads), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed), static_cast<const uint8_t*>(vbits),
        static_cast<const int32_t*>(lens), B, row4, row8, W, t, do_rc, bad_ix,
        static_cast<int32_t*>(out));
  }
  UTREE_LAUNCH_RESULT();
}

namespace {

__global__ void bsearch_probe_shard_kernel(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ vbits,
    const int32_t* __restrict__ lens, int64_t B, int64_t row4, int64_t row8,
    int32_t W, Records t, int64_t lo, int64_t nbins, int32_t do_rc,
    int32_t* __restrict__ ix_out, uint8_t* __restrict__ found_out) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= B * W) return;
  int64_t b = i / W;
  int32_t w = static_cast<int32_t>(i - b * W);
  uint32_t hi32, lo32;
  bool valid = kmer::window_at(packed + b * row4, vbits + b * row8, lens[b], w,
                               hi32, lo32);
  int64_t at = b * (do_rc ? 2 * W : W) + w;
  replay_local(t, lo, nbins, valid, hi32 >> 8, static_cast<int32_t>(hi32 & 0xFFu), lo32,
               ix_out + at, found_out + at);
  if (do_rc) {
    uint32_t rhi = kmer::rev2(~lo32), rlo = kmer::rev2(~hi32);
    replay_local(t, lo, nbins, valid, rhi >> 8, static_cast<int32_t>(rhi & 0xFFu), rlo,
                 ix_out + at + W, found_out + at + W);
  }
}

}  // namespace

// One slice: bin_ix (nbins + 1,) local offsets, suf_hi / suf_lo / ix
// (n + 1,) with zero-suffix, id-bad_ix padding; lo = the slice's first
// prefix.  Writes (B, 2W or W) int32 where(found, ix, 0) and u8 found.
extern "C" int utree_bsearch_probe_shard(
    const void* packed, const void* vbits, const void* lens, int64_t B, int64_t row4,
    int64_t row8, int32_t W, const void* bin_ix, const void* suf_hi, const void* suf_lo,
    const void* ix, int64_t n, int64_t lo, int64_t nbins, int32_t do_rc, void* ix_out,
    void* found_out, void* stream) {
  const int threads = 256;
  int64_t total = B * W;
  if (total > 0) {
    Records t{static_cast<const int32_t*>(bin_ix), static_cast<const int32_t*>(suf_hi),
              static_cast<const uint32_t*>(suf_lo), static_cast<const int32_t*>(ix), n};
    bsearch_probe_shard_kernel<<<utree_blocks(total, threads), threads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed), static_cast<const uint8_t*>(vbits),
        static_cast<const int32_t*>(lens), B, row4, row8, W, t, lo, nbins, do_rc,
        static_cast<int32_t*>(ix_out), static_cast<uint8_t*>(found_out));
  }
  UTREE_LAUNCH_RESULT();
}
