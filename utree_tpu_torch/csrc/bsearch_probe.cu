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
// bin_ix[pre+1] (64 MB, one random sector), then the records its descent
// visits.  At 20M records in 2^24 bins a bin holds 1.2 records, but a
// stored word's bin 2.2: of phase 10's 15.6M valid words (both strands)
// 2.8M meet an empty bin, 5.3M a bin of one record and 7.5M a larger one.
// The sectors are random, and K7 runs at the rate the card reads random
// sectors from device memory (PERF.md §6), so it saves sectors: it reads
// a record as one 16 B {suf_hi, suf_lo, ix, 0} entry of `rec` (a derived
// copy the bsearch table's dict carries, hash_index.bsearch_records), one
// sector where the three arrays cost three.  K15 makes its trip for the
// words of its slice only (a quarter of them at S = 4), over the three
// arrays, but decodes every window and writes five bytes for each.
//
// Design of K7: one thread a (read, window) lane, both strands' words in
// flight together.  The thread cuts its forward word with window_at (K1's
// staged windows bought nothing here: the front half hides behind the
// chains), and its RC word is rev2(~lo32):rev2(~hi32).  Both words' bin
// offsets are loaded before either descent, and both descend together.
// A word in a one-record bin loads that record with its partner's first
// probe, so it costs two dependent round trips, which the thread's two
// words share; in a larger bin each probe's record replaces the one held
// when the probe moves p, and the start record is loaded only by a
// descent that ends on it (loading it with the first probe took 5% more
// time on an H100: a sector more for most such words).
//
// The loop runs while the range is non-empty.  JAX runs a fixed
// `probe_iters` = ceil(log2(max bin + 1)) trips instead, but a lane whose
// size reached 0 is frozen there (no branch moves p or size), and
// `probe_iters` trips always empty the largest bin, so both end on the same
// p, on the quirky merged bins too.  A slice keeps the global bins' record
// ranges (its offsets are the global ones less the slice's first record), so
// the same holds for K15.  The clamp `min(p + w + 1, n)` and the final
// `min(p, n)` keep every read inside the n+1 records; for K7 record n is the
// sentinel (suffix 0, id bad_ix), for K15 n is the slice's padded length
// (max_local over the slices, not its own count), so the clamp reads the
// zero-suffix, id-bad_ix padding records exactly where JAX reads them.  An
// invalid window writes bad_ix and reads no bin (JAX searches bin 0 for it
// and discards the result).  The suffix compare is (hi, lo) with lo
// unsigned.

#include "kmer.cuh"

namespace {

// K15's slice of the records, as three arrays.
struct Records {
  const int32_t* bin_ix;  // a slice's bin starts (nbins + 1,)
  const int32_t* suf_hi;  // (n + 1,) suffix bits 39..32
  const uint32_t* suf_lo; // (n + 1,) suffix bits 31..0
  const int32_t* ix;      // (n + 1,) label ids
  int64_t n;              // index of the last padding record
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

// ---- K7 ---------------------------------------------------------------------

constexpr int TPB = 256;

// record <= (qhi, qlo) on a 16 B record {suf_hi, suf_lo, ix, 0}
__device__ __forceinline__ bool rec_le(const int4& r, int32_t qhi, uint32_t qlo) {
  return r.x < qhi || (r.x == qhi && static_cast<uint32_t>(r.y) <= qlo);
}

// The replay of NW words (the forward word, and with RC its RC word) over
// the whole table, their chains interleaved: the label id of the record
// each word's probe sequence ends on, or bad_ix.
template <int NW>
__device__ __forceinline__ void replay_words(const int32_t* __restrict__ bin_ix,
                                             const int4* __restrict__ rec, int32_t n,
                                             const uint32_t (&hi)[NW],
                                             const uint32_t (&lo)[NW], int32_t bad_ix,
                                             int32_t (&ids)[NW]) {
  int32_t p[NW], size[NW];
  int4 r[NW];    // the record at min(p, n), once `have`
  bool have[NW];
#pragma unroll
  for (int s = 0; s < NW; ++s) {
    const uint32_t pre = hi[s] >> 8;
    const int32_t start = __ldg(bin_ix + pre), end = __ldg(bin_ix + pre + 1);
    p[s] = start;
    size[s] = end - start - 1;  // -1 (or less): an empty bin, no descent
    r[s] = make_int4(0, 0, 0, 0);
  }
  // a one-record bin's record now; a larger bin's start record only if
  // its descent ends there
#pragma unroll
  for (int s = 0; s < NW; ++s) {
    have[s] = size[s] == 0;
    if (have[s]) r[s] = __ldg(rec + (p[s] < n ? p[s] : n));
  }
  bool more = true;
  while (more) {
    int4 pr[NW];
    int32_t w[NW];
#pragma unroll
    for (int s = 0; s < NW; ++s) {
      if (size[s] > 0) {
        w[s] = size[s] >> 1;
        const int32_t probe = p[s] + w[s] + 1;  // <= p + size < end <= n
        pr[s] = __ldg(rec + (probe < n ? probe : n));
      }
    }
    more = false;
#pragma unroll
    for (int s = 0; s < NW; ++s) {
      if (size[s] > 0) {
        if (rec_le(pr[s], static_cast<int32_t>(hi[s] & 0xFFu), lo[s])) {
          p[s] += w[s] + 1;
          size[s] -= w[s] + 1;
          r[s] = pr[s];
          have[s] = true;
        } else {
          size[s] = w[s];
        }
        more |= size[s] > 0;
      }
    }
  }
#pragma unroll
  for (int s = 0; s < NW; ++s)
    if (size[s] == 0 && !have[s]) r[s] = __ldg(rec + (p[s] < n ? p[s] : n));
#pragma unroll
  for (int s = 0; s < NW; ++s)
    ids[s] = size[s] == 0 && r[s].x == static_cast<int32_t>(hi[s] & 0xFFu) &&
                     static_cast<uint32_t>(r[s].y) == lo[s]
                 ? r[s].z
                 : bad_ix;
}

template <bool RC>
__global__ void __launch_bounds__(TPB) bsearch_probe_kernel(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ vbits,
    const int32_t* __restrict__ lens, int64_t B, int64_t row4, int64_t row8,
    int32_t W, const int32_t* __restrict__ bin_ix, const int4* __restrict__ rec,
    int32_t n, int32_t bad_ix, int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * TPB + threadIdx.x;
  if (i >= B * W) return;
  const int64_t b = i / W;
  const int32_t w = static_cast<int32_t>(i - b * W);
  uint32_t hi32, lo32;
  const bool valid = kmer::window_at(packed + b * row4, vbits + b * row8, lens[b], w, hi32,
                                     lo32);
  if constexpr (RC) {
    int32_t ids[2] = {bad_ix, bad_ix};
    if (valid) {
      // rc_word_lanes: rc(hi32:lo32) = rev2(~lo32):rev2(~hi32)
      const uint32_t hi[2] = {hi32, kmer::rev2(~lo32)}, lo[2] = {lo32, kmer::rev2(~hi32)};
      replay_words<2>(bin_ix, rec, n, hi, lo, bad_ix, ids);
    }
    out[b * 2 * W + w] = ids[0];
    out[b * 2 * W + W + w] = ids[1];
  } else {
    int32_t ids[1] = {bad_ix};
    if (valid) {
      const uint32_t hi[1] = {hi32}, lo[1] = {lo32};
      replay_words<1>(bin_ix, rec, n, hi, lo, bad_ix, ids);
    }
    out[b * W + w] = ids[0];
  }
}

}  // namespace

// rec: (n + 1, 4) int32 records {suf_hi, suf_lo, ix, 0}, 16 B aligned;
// n < 2^31 - 1.  Writes (B, 2W) [fwd | rc] ids with RC, else (B, W).
extern "C" int utree_bsearch_probe(
    const void* packed, const void* vbits, const void* lens, int64_t B,
    int64_t row4, int64_t row8, int32_t W, const void* bin_ix, const void* rec,
    int64_t n, int32_t do_rc, int32_t bad_ix, void* out, void* stream) {
  int64_t total = B * W;
  if (total > 0) {
    auto* kernel = do_rc ? bsearch_probe_kernel<true> : bsearch_probe_kernel<false>;
    kernel<<<utree_blocks(total, TPB), TPB, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed), static_cast<const uint8_t*>(vbits),
        static_cast<const int32_t*>(lens), B, row4, row8, W,
        static_cast<const int32_t*>(bin_ix), static_cast<const int4*>(rec),
        static_cast<int32_t>(n), bad_ix, static_cast<int32_t*>(out));
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
