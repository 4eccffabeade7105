// K9 xtree_probe: ASCII queries -> per-window LBS_k pod index and prefix bin
// of both strands, over the xtree canonical displaced table (wide, 4-column
// slots: key_lo, key_hi, seed_fwd+1, seed_rc+1).
//
// Replaces (utree_tpu/xtree/device.py): xtree_device_step :178 with
// _extract_windows_k :120, _rc_lanes_k :145 and _prefix_of :167, and from
// utree_tpu/lookup.py base_codes :31 and displaced_probe_raw(wide=True) :887.
// Shares kmer64's staging (stage_ascii, as K5 and K6 stage their 64-mers)
// and kmer::key_of, fold_hash, displaced_slot, load_row2<4>, match_row2<4>
// and t3_tail<4> (the seed, slot and row of K1's wide probe) with K1.
//
// Layout: a k-mer (14 <= k <= 31) is 2k bits, MSB-first.  JAX holds it in
// two u32 lanes, hi = the first k-16 bases and lo = the last 16, and takes
// its RC as rev2(~lo):rev2(~hi) shifted right by s = 64-2k across the lanes,
// in three branches (s < 32, s == 32, s > 32) because a u32 shift by 32 is
// not defined.  Here the word is one uint64_t x whose (hi, lo) halves are
// exactly those lanes; its RC is rev2_64(~x) >> s, with s in [2, 62], which
// equals all three branches, and the prefix bin (x >> 2*sl) as u32 equals
// _prefix_of's (hi << (32-b)) | (lo >> b) and its b == 32 case.  The
// canonical compare (hi first, then lo, unsigned) is x <= rc.
//
// Bound: each window is one chain of dependent loads -- the u8 seed word,
// then one random 32 B d1 row (one sector; d1 is far larger than the 50 MB
// L2 at real database sizes), then on a miss the small cached d3 tail --
// plus the four int32 outputs, 16 B a window, which at 164 windows a
// 150 bp query outweigh the query bytes 13 to 1.  The arithmetic (two
// 32-bit mixes per hash) is negligible beside the random row read.
//
// Design: one thread per (query, window), as K1: all B*W row reads are in
// flight at once and occupancy hides their latency.  A thread that read its
// k bytes one at a time and decoded each spent as long on that front half
// as on its seed word and row (57 and 59 of 71 us on an H100, PERF.md §6),
// so a block of 256 threads takes a tile of 256 consecutive lanes, stages
// the ASCII bytes they read in shared memory, each decoded once into its
// 2-bit code and validity bit (kmer64::staged_kmer, K5's staging), and each
// lane cuts its k bases from three code words with two funnel shifts; a
// tile whose rows hold a few windows each reads its bases byte by byte.
// The staged decode codes a base as itself past the query's length, where
// JAX masks it to 0, so the cut zeroes the bases from len - w on: the
// prefix bins of such an invalid window then equal JAX's.  The d1 row comes
// as two 16 B loads (d1 must start on a 16 B boundary).  No lane arrays
// reach device memory; the four outputs are written coalesced, output m of
// (b, w) at m*B*W + b*W + w.  Invalid windows (an N, a byte past the
// length, the padding) skip the table: JAX probes bucket 0 for them and
// discards the value with where(valid, ..., -1).

#include "kmer64.cuh"

namespace {

// Reverse the 2-bit groups of a 64-bit word (base order reversal).
__device__ __forceinline__ uint64_t rev2_64(uint64_t x) {
  uint64_t r = __brevll(x);
  return ((r >> 1) & 0x5555555555555555ull) | ((r & 0x5555555555555555ull) << 1);
}

constexpr int TPB = 256;  // lanes a tile, one a thread
// staged 32 B chunks of a tile: 64 cover a tile's bytes while W >= 5
constexpr int CHUNKS = 64;

__global__ void __launch_bounds__(TPB) xtree_probe_kernel(
    const uint8_t* __restrict__ reads, const int32_t* __restrict__ lens,
    int64_t B, int64_t T, int32_t W, int32_t k, int32_t sl,
    const int32_t* __restrict__ d1, int64_t nslots, const int32_t* __restrict__ ds,
    int64_t nseed, const int32_t* __restrict__ d3, int64_t n3, int32_t s3,
    int32_t* __restrict__ out) {
  __shared__ uint32_t codes[2 * CHUNKS], valid[CHUNKS];
  const int64_t n = B * W, t = static_cast<int64_t>(blockIdx.x) * TPB + threadIdx.x;
  const kmer64::Kmer l = kmer64::staged_kmer<TPB>(
      reads, lens, n, T, W, k, static_cast<int64_t>(blockIdx.x) * TPB, codes, valid, CHUNKS);
  if (!l.live) return;
  const uint64_t x = l.x;
  const uint64_t rc = rev2_64(~x) >> (64 - 2 * k);
  int32_t seed_f = -1, seed_r = -1;
  if (l.valid) {
    const bool fwd_le = x <= rc;
    const uint64_t c = fwd_le ? x : rc;
    const kmer::Key key = kmer::key_of(static_cast<int32_t>(static_cast<uint32_t>(c)),
                                       static_cast<int32_t>(static_cast<uint32_t>(c >> 32)));
    const uint32_t bkt = kmer::fold_hash(key) & static_cast<uint32_t>(nseed - 1);
    const uint32_t slot = kmer::displaced_slot(
        key, bkt, static_cast<uint32_t>(__ldg(ds + (bkt >> 2))), nslots);
    kmer::Raw r = kmer::match_row2<4>(
        kmer::load_row2<4>(d1 + static_cast<int64_t>(slot >> 1) * 8), key);
    kmer::t3_tail<4>(r, key, d3, n3, s3);
    // r.a is the canonical word's pod + 1, r.b its RC's; 0 = that
    // orientation misses, so the seed is -1
    seed_f = fwd_le ? r.a - 1 : r.b - 1;
    seed_r = fwd_le ? r.b - 1 : r.a - 1;
  }
  out[t] = seed_f;
  out[n + t] = seed_r;
  out[2 * n + t] = static_cast<int32_t>(static_cast<uint32_t>(x >> (2 * sl)));
  out[3 * n + t] = static_cast<int32_t>(static_cast<uint32_t>(rc >> (2 * sl)));
}

}  // namespace

extern "C" int utree_xtree_probe(
    const void* reads, const void* lens, int64_t B, int64_t T, int32_t W, int32_t k,
    int32_t sl, const void* d1, int64_t nslots, const void* ds, int64_t nseed,
    const void* d3, int64_t n3, int32_t s3, void* out, void* stream) {
  int64_t n = B * W;
  if (n > 0) {
    xtree_probe_kernel<<<utree_blocks(n, TPB), TPB, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(reads), static_cast<const int32_t*>(lens), B, T,
        W, k, sl, static_cast<const int32_t*>(d1), nslots,
        static_cast<const int32_t*>(ds), nseed, static_cast<const int32_t*>(d3), n3,
        s3, static_cast<int32_t*>(out));
  }
  UTREE_LAUNCH_RESULT();
}
