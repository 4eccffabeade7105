// K5 scan_probe64: ASCII reads -> per-window label ids over the 64-mer
// seeded-displacement table (PACKSIZE=64, 6-column slots at any label width).
//
// Replaces (utree_tpu/lookup.py): lookup_kmers_displaced64 :521 with its
// seed read displaced_seed_jnp :863, and search_step's k=64 branch :600-613
// for a 'd64_1' table, with the shared front half of kmer64.cuh (ASCII
// windows, four-lane canonical keys, mix4, 6-column slot compare, decode).
//
// Bound: each window is one chain of dependent loads -- the u8 seed word
// (the seed table is at most 64 MB; 8 MB at 20M 64-mers, in the 50 MB L2),
// then one random two-slot d64_1 row of 48 B (two 32 B sectors, 1.5x K1's
// bytes per probe), then on a miss the small cached d64_3 tail.  Arithmetic
// (five mix4 per window) is small beside the random row read.  On an H100
// window_at's front half took 730 of the 787 us a batch took when each
// thread cut its own window (PERF.md §6).
//
// Design: K6's (ladder_probe64.cu).  One thread a (read, window) lane, so
// that all B*W row reads are in flight at once.  A block of 256 threads
// takes a tile of 256 consecutive lanes p = b*W + w; the ASCII bytes its
// lanes read are staged in shared memory, each decoded once into its 2-bit
// code and validity bit, and each lane cuts its four lanes from them with
// funnel shifts (kmer64::staged_lane; a tile whose reads span more than the
// staged chunks, W far below L, reads its bases with window_at).  The seed
// word is one 4 B load; the d64_1 row comes as three 16 B loads and a d64_3
// row of an even slot count the same way, two slots a 48 B step, one of an
// odd count slot by slot (kmer64::probe_row16; both tables must start on a
// 16 B boundary).  An invalid window reads seed word 0 and row 0 as JAX
// does (its bucket and slot are 0) and writes the miss id.

#include "kmer64.cuh"

namespace {

constexpr int TPB = 256;  // lanes a tile, one a thread
// staged 32 B chunks of a tile: 64 cover a tile's bytes while W >= 10
constexpr int CHUNKS = 64;

__global__ void __launch_bounds__(TPB) scan_probe64_kernel(
    const uint8_t* __restrict__ reads, const int32_t* __restrict__ lens,
    int64_t B, int64_t L, int32_t W, const int32_t* __restrict__ d1,
    int64_t nslots, const int32_t* __restrict__ ds, int64_t nseed,
    const int32_t* __restrict__ d3, int64_t n3, int32_t s3, int32_t do_rc,
    int32_t miss, int32_t* __restrict__ out) {
  __shared__ uint32_t codes[2 * CHUNKS], valid[CHUNKS];
  const kmer64::Lane l = kmer64::staged_lane<TPB>(
      reads, lens, B * W, L, W, static_cast<int64_t>(blockIdx.x) * TPB, codes, valid, CHUNKS);
  if (!l.live) return;
  kmer64::Key key;
  const bool fwd_le = kmer64::canonical(l.k, key);
  const uint32_t bkt =
      l.valid ? kmer64::fold_hash(key) & static_cast<uint32_t>(nseed - 1) : 0u;
  const uint32_t seed = (static_cast<uint32_t>(__ldg(ds + (bkt >> 2))) >> ((bkt & 3u) << 3)) &
                        0xFFu;
  const uint32_t u2 = kmer64::mix4(key, 0x94D049BBu);
  const uint32_t u3 = kmer64::mix4(key, 0x7FEB352Du);
  const uint32_t h = ((u2 ^ (seed * 0x85EBCA6Bu)) * 0xC2B2AE35u) ^
                     ((u3 ^ (seed * 0xC2B2AE35u)) * 0x85EBCA6Bu);
  const uint32_t slot = l.valid ? h % static_cast<uint32_t>(nslots) : 0u;
  kmer::Raw r = kmer64::probe_row16(d1 + static_cast<int64_t>(slot >> 1) * 12, 2, key);
  if (r.miss() && n3 > 8) {
    const uint32_t b3 =
        l.valid ? kmer64::mix4(key, 0x27D4EB2Fu) & static_cast<uint32_t>(n3 - 1) : 0u;
    r = kmer64::probe_row16(d3 + static_cast<int64_t>(b3) * 6 * s3, s3, key);
  }
  kmer64::write_ids(out, l.b, W, l.w, l.valid, fwd_le, r, do_rc, miss);
}

}  // namespace

extern "C" int utree_scan_probe64(
    const void* reads, const void* lens, int64_t B, int64_t L, int32_t W,
    const void* d1, int64_t nslots, const void* ds, int64_t nseed,
    const void* d3, int64_t n3, int32_t s3, int32_t do_rc, int32_t miss,
    void* out, void* stream) {
  int64_t n = B * W;
  if (n > 0) {
    scan_probe64_kernel<<<utree_blocks(n, TPB), TPB, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(reads), static_cast<const int32_t*>(lens), B,
        L, W, static_cast<const int32_t*>(d1), nslots,
        static_cast<const int32_t*>(ds), nseed, static_cast<const int32_t*>(d3),
        n3, s3, do_rc, miss, static_cast<int32_t*>(out));
  }
  UTREE_LAUNCH_RESULT();
}
