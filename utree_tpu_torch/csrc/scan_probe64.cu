// K5 scan_probe64: ASCII reads -> per-window label ids over the 64-mer
// seeded-displacement table (PACKSIZE=64, 6-column slots at any label width).
//
// Replaces (utree_tpu/lookup.py): lookup_kmers_displaced64 :521 with its
// seed read displaced_seed_jnp :863, and search_step's k=64 branch :600-613
// for a 'd64_1' table, with the shared front half of kmer64.cuh (ASCII
// windows, four-lane canonical keys, mix4, 6-column slot compare, decode).
//
// Bound: each window is one chain of dependent loads -- the u8 seed word
// (the seed table is at most 64 MB, mostly L2-resident), then one random
// two-slot d64_1 row of 48 B (two 32 B sectors, 1.5x K1's bytes per probe),
// then on a miss the small cached d64_3 tail.  Arithmetic (five mix4 per
// window, the 64-base ASCII decode) is small beside the random row read.
//
// Design: one thread per (read, window), as K1, so all B*W row reads are in
// flight at once.  Each thread rebuilds its 64 bases from the ASCII row
// (neighbouring threads read the same bytes, which L1 serves), so no (B, W)
// lane array reaches device memory.  An invalid window reads seed word 0 and
// row 0 as JAX does (its bucket and slot are 0) and writes the miss id.

#include "kmer64.cuh"

namespace {

__global__ void scan_probe64_kernel(
    const uint8_t* __restrict__ reads, const int32_t* __restrict__ lens,
    int64_t B, int64_t L, int32_t W, const int32_t* __restrict__ d1,
    int64_t nslots, const int32_t* __restrict__ ds, int64_t nseed,
    const int32_t* __restrict__ d3, int64_t n3, int32_t s3, int32_t do_rc,
    int32_t miss, int32_t* __restrict__ out) {
  int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= B * W) return;
  int64_t b = t / W;
  int32_t w = static_cast<int32_t>(t - b * W);
  uint32_t k[4];
  bool valid = kmer64::window_at(reads + b * L, lens[b], w, k);
  kmer64::Key key;
  bool fwd_le = kmer64::canonical(k, key);
  uint32_t bkt = valid ? kmer64::fold_hash(key) & static_cast<uint32_t>(nseed - 1) : 0u;
  uint32_t seed = (static_cast<uint32_t>(ds[bkt >> 2]) >> ((bkt & 3u) << 3)) & 0xFFu;
  uint32_t u2 = kmer64::mix4(key, 0x94D049BBu);
  uint32_t u3 = kmer64::mix4(key, 0x7FEB352Du);
  uint32_t h = ((u2 ^ (seed * 0x85EBCA6Bu)) * 0xC2B2AE35u) ^
               ((u3 ^ (seed * 0xC2B2AE35u)) * 0x85EBCA6Bu);
  uint32_t slot = valid ? h % static_cast<uint32_t>(nslots) : 0u;
  kmer::Raw r = kmer64::probe_row(d1 + static_cast<int64_t>(slot >> 1) * 12, 2, key);
  if (r.miss() && n3 > 8) {
    uint32_t b3 = valid ? kmer64::mix4(key, 0x27D4EB2Fu) & static_cast<uint32_t>(n3 - 1) : 0u;
    r = kmer64::probe_row(d3 + static_cast<int64_t>(b3) * 6 * s3, s3, key);
  }
  kmer64::write_ids(out, b, W, w, valid, fwd_le, r, do_rc, miss);
}

}  // namespace

extern "C" int utree_scan_probe64(
    const void* reads, const void* lens, int64_t B, int64_t L, int32_t W,
    const void* d1, int64_t nslots, const void* ds, int64_t nseed,
    const void* d3, int64_t n3, int32_t s3, int32_t do_rc, int32_t miss,
    void* out, void* stream) {
  const int threads = 256;
  int64_t n = B * W;
  if (n > 0) {
    scan_probe64_kernel<<<utree_blocks(n, threads), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(reads), static_cast<const int32_t*>(lens), B,
        L, W, static_cast<const int32_t*>(d1), nslots,
        static_cast<const int32_t*>(ds), nseed, static_cast<const int32_t*>(d3),
        n3, s3, do_rc, miss, static_cast<int32_t*>(out));
  }
  UTREE_LAUNCH_RESULT();
}
