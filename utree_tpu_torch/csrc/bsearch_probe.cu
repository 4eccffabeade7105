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
// words of its slice only (a quarter of them at S = 4), over the slice's
// own `rec` (ShardedIndex.to_devices), but decodes every window and writes
// five bytes for each.  A thread a window, as K15 first ran, set its time by
// its front half (window_at: 310 of 412 us at (2, 4) slice 0 on an H100,
// PERF.md §6), and each warp ran as long as its longest chain while three
// quarters of its lanes, out of range, waited.
//
// Design of K15: a block of 256 threads takes a tile of 1024 consecutive
// (read, window) lanes, 128 a warp, four a thread.  It stages the tile's
// packed bytes and validity bits as K1 does (kmer::stage; a tile that spans
// more reads than the staged words hold reads its bases with window_at),
// and each lane cuts its forward and RC words.  A word out of the slice's
// range, or of an invalid window, writes its zeros at once (ix 0, found 0,
// as a miss does); the others go to the warp's queue in shared memory, in
// lane order by a ballot and a popcount, room for every word of its lanes.
// Then the warp replays its own queue with every lane busy, two words a
// lane at a time with their chains interleaved as K7's strands are
// (replay_words, shared with K7, over the 16 B records and int32
// offsets), and writes each result at its word's (read, column).  No
// barrier but the staging's stands between a warp's front half and its
// chains, so one warp's chains run while another cuts its windows (a block
// that queued all its words before any chain ran took 4% longer at (2, 4)
// on an H100).  Its chains alone then take 249 of its 280 us there
// (PERF.md §6): at K7's rate a word, they bound it now.  The order of the
// writes changes, their values do not.
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

// ---- the descent over 16 B records (K7, K15) ----------------------------------

// record <= (qhi, qlo) on a 16 B record {suf_hi, suf_lo, ix, 0}
__device__ __forceinline__ bool rec_le(const int4& r, int32_t qhi, uint32_t qlo) {
  return r.x < qhi || (r.x == qhi && static_cast<uint32_t>(r.y) <= qlo);
}

// The replay of NW words over 16 B records, their chains interleaved: word
// s searches bin hi[s] >> 8 of bin_ix (K7 passes the whole table's bin_ix,
// K15 its slice's shifted down by the slice's first prefix).  K7 (SLICE
// false) gets in ids the label id of the record each word's probe sequence
// ends on, or bad_ix; K15 (SLICE true) gets in found whether that record
// equals the word, and in ids where(found, id, 0).  The switch keeps K7's
// own match expression, and so its SASS, as it was before K15 shared the
// loop.
template <int NW, bool SLICE>
__device__ __forceinline__ void replay_words(const int32_t* __restrict__ bin_ix,
                                             const int4* __restrict__ rec, int32_t n,
                                             const uint32_t (&hi)[NW],
                                             const uint32_t (&lo)[NW], int32_t bad_ix,
                                             int32_t (&ids)[NW], bool (&found)[NW]) {
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
  for (int s = 0; s < NW; ++s) {
    if constexpr (SLICE) {
      found[s] = size[s] == 0 && r[s].x == static_cast<int32_t>(hi[s] & 0xFFu) &&
                 static_cast<uint32_t>(r[s].y) == lo[s];
      ids[s] = found[s] ? r[s].z : 0;
    } else {
      ids[s] = size[s] == 0 && r[s].x == static_cast<int32_t>(hi[s] & 0xFFu) &&
                     static_cast<uint32_t>(r[s].y) == lo[s]
                 ? r[s].z
                 : bad_ix;
    }
  }
}

// ---- K7 ---------------------------------------------------------------------

constexpr int TPB = 256;

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
      bool found[2];
      replay_words<2, false>(bin_ix, rec, n, hi, lo, bad_ix, ids, found);
    }
    out[b * 2 * W + w] = ids[0];
    out[b * 2 * W + W + w] = ids[1];
  } else {
    int32_t ids[1] = {bad_ix};
    if (valid) {
      const uint32_t hi[1] = {hi32}, lo[1] = {lo32};
      bool found[1];
      replay_words<1, false>(bin_ix, rec, n, hi, lo, bad_ix, ids, found);
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

// ---- K15 --------------------------------------------------------------------

constexpr int SH_TPB = 256;                 // threads a block
constexpr int SH_WARPS = SH_TPB / 32;
constexpr int SH_LANES = 4;                 // (read, window) lanes a thread
constexpr int SH_TILE = SH_TPB * SH_LANES;  // lanes a block
constexpr int SH_WQ = 2 * 32 * SH_LANES;    // a warp's queue: every word of its lanes
// staged words of a tile (kmer::stage): its reads' packed bytes and
// validity bits while W is not far below the packed width (at width 150,
// 1024 lanes span 10 reads, 380 packed bytes); a tile that needs more reads
// its bases with window_at
constexpr int SH_PK_WORDS = 520;
constexpr int SH_VB_WORDS = 264;

// A warp's queue of words in range: each word's (hi, lo) and its output's
// offset from the tile's first read's.
struct Queue {
  uint32_t hi[SH_WQ], lo[SH_WQ], at[SH_WQ];
};

// Appends the lanes whose `in` is set to the warp's queue of n words, in
// lane order (a ballot and a popcount, no atomics); returns the new n.
// Every lane of the warp calls it.
__device__ __forceinline__ int enqueue(bool in, uint32_t hi, uint32_t lo, uint32_t at,
                                       int n, Queue& q) {
  const unsigned mask = __ballot_sync(0xFFFFFFFFu, in);
  if (in) {
    const int slot = n + __popc(mask & ((1u << (threadIdx.x & 31u)) - 1u));
    q.hi[slot] = hi;
    q.lo[slot] = lo;
    q.at[slot] = at;
  }
  return n + __popc(mask);
}

// The replay of NW queued words against the slice; bins[pre] is the bin of
// prefix pre (the slice's bin_ix shifted down by its first prefix).
// Writes where(found, ix, 0) and found at each word's output.
template <int NW>
__device__ __forceinline__ void replay_queued(const int (&idx)[NW], const Queue& q,
                                              const int32_t* bins,
                                              const int4* __restrict__ rec, int32_t n,
                                              int32_t* ix_out, uint8_t* found_out) {
  uint32_t hi[NW], lo[NW];
#pragma unroll
  for (int s = 0; s < NW; ++s) {
    hi[s] = q.hi[idx[s]];
    lo[s] = q.lo[idx[s]];
  }
  int32_t ids[NW];
  bool found[NW];
  replay_words<NW, true>(bins, rec, n, hi, lo, 0, ids, found);
#pragma unroll
  for (int s = 0; s < NW; ++s) {
    const uint32_t at = q.at[idx[s]];
    ix_out[at] = ids[s];
    found_out[at] = found[s];
  }
}

__global__ void __launch_bounds__(SH_TPB) bsearch_probe_shard_kernel(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ vbits,
    const int32_t* __restrict__ lens, int64_t B, int64_t row4, int64_t row8, int32_t W,
    const int32_t* __restrict__ bin_ix, const int4* __restrict__ rec, int32_t n,
    uint32_t lo, uint32_t nbins, int32_t do_rc, int32_t* __restrict__ ix_out,
    uint8_t* __restrict__ found_out) {
  __shared__ uint32_t spk[SH_PK_WORDS], svb[SH_VB_WORDS];
  __shared__ Queue queues[SH_WARPS];
  const int64_t P = B * W, p0 = static_cast<int64_t>(blockIdx.x) * SH_TILE;
  const int64_t p1 = (p0 + SH_TILE < P ? p0 + SH_TILE : P) - 1;
  const kmer::Span sp = kmer::span_of(p0, p1, W, row4, row8);
  const bool staged = kmer::staged_words(sp.pk0, sp.pk1) <= SH_PK_WORDS &&
                      kmer::staged_words(sp.vb0, sp.vb1) <= SH_VB_WORDS;
  int64_t pbase = 0, vbase = 0;
  if (staged) {
    pbase = kmer::stage<SH_TPB>(packed, sp.pk0, sp.pk1, spk);
    vbase = kmer::stage<SH_TPB>(vbits, sp.vb0, sp.vb1, svb);
  }
  __syncthreads();
  // the outputs of the tile, from its first read's: the words out of range
  // (or invalid) write their zeros here, the others go to the warp's queue
  const uint32_t cols = do_rc ? 2u * W : static_cast<uint32_t>(W);
  int32_t* ix_tile = ix_out + sp.b0 * cols;
  uint8_t* found_tile = found_out + sp.b0 * cols;
  Queue& queue = queues[threadIdx.x >> 5];
  // warp v takes the tile's lanes [32 * SH_LANES * v, 32 * SH_LANES * (v + 1))
  const int32_t first = 32 * SH_LANES * static_cast<int32_t>(threadIdx.x >> 5) +
                        static_cast<int32_t>(threadIdx.x & 31u);
  const int32_t w0 = static_cast<int32_t>(p0 - sp.b0 * W);
  int nq = 0;
#pragma unroll 1
  for (int j = 0; j < SH_LANES; ++j) {
    const int32_t t = first + 32 * j;  // the lane's place in the tile
    const bool live = p0 + t <= p1;
    const int32_t bl = (w0 + t) / W;  // w0 + t < TILE + W
    const int32_t w = w0 + t - bl * W;
    const int64_t b = sp.b0 + bl;
    uint32_t hi32 = 0, lo32 = 0;
    bool valid = false;
    if (live) {
      const int64_t pk = b * row4 + (w >> 2), vb = b * row8 + (w >> 3);
      valid = staged ? kmer::staged_window(spk, svb, static_cast<int>(pk - pbase),
                                           static_cast<int>(vb - vbase), w, lens[b], hi32,
                                           lo32)
                     : kmer::window_at(packed + b * row4, vbits + b * row8, lens[b], w, hi32,
                                       lo32);
    }
    const uint32_t at = static_cast<uint32_t>(bl) * cols + static_cast<uint32_t>(w);
    // a word is in range when its prefix less the slice's first lies below
    // nbins (unsigned: a prefix below lo wraps above it)
    const bool fwd = valid && (hi32 >> 8) - lo < nbins;
    if (live && !fwd) {
      ix_tile[at] = 0;
      found_tile[at] = 0;
    }
    nq = enqueue(fwd, hi32, lo32, at, nq, queue);
    if (do_rc) {
      // rc_word_lanes: rc(hi32:lo32) = rev2(~lo32):rev2(~hi32)
      const uint32_t rhi = kmer::rev2(~lo32), rlo = kmer::rev2(~hi32);
      const bool rc = valid && (rhi >> 8) - lo < nbins;
      if (live && !rc) {
        ix_tile[at + W] = 0;
        found_tile[at + W] = 0;
      }
      nq = enqueue(rc, rhi, rlo, at + W, nq, queue);
    }
  }
  __syncwarp();
  // the warp replays its queue, every lane busy: two words a lane while
  // two are left
  const int32_t* bins = bin_ix - lo;  // bins[pre] is the slice's bin_ix[pre - lo]
  for (int i = static_cast<int>(threadIdx.x & 31u); i < nq; i += 64) {
    if (i + 32 < nq) {
      replay_queued<2>({i, i + 32}, queue, bins, rec, n, ix_tile, found_tile);
    } else {
      replay_queued<1>({i}, queue, bins, rec, n, ix_tile, found_tile);
    }
  }
}

}  // namespace

// One slice: bin_ix (nbins + 1,) local offsets, rec (n + 1, 4) int32
// records {suf_hi, suf_lo, ix, 0} with zero-suffix, id-bad_ix padding, 16 B
// aligned, n < 2^31 - 1; lo = the slice's first prefix.  Writes (B, 2W or
// W) int32 where(found, ix, 0) and u8 found.
extern "C" int utree_bsearch_probe_shard(
    const void* packed, const void* vbits, const void* lens, int64_t B, int64_t row4,
    int64_t row8, int32_t W, const void* bin_ix, const void* rec, int64_t n, int64_t lo,
    int64_t nbins, int32_t do_rc, void* ix_out, void* found_out, void* stream) {
  int64_t total = B * W;
  if (total > 0) {
    bsearch_probe_shard_kernel<<<utree_blocks(total, SH_TILE), SH_TPB, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed), static_cast<const uint8_t*>(vbits),
        static_cast<const int32_t*>(lens), B, row4, row8, W,
        static_cast<const int32_t*>(bin_ix), static_cast<const int4*>(rec),
        static_cast<int32_t>(n), static_cast<uint32_t>(lo), static_cast<uint32_t>(nbins),
        do_rc, static_cast<int32_t*>(ix_out), static_cast<uint8_t*>(found_out));
  }
  UTREE_LAUNCH_RESULT();
}
