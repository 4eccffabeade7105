// K6 ladder_probe64: ASCII reads -> per-window label ids over the 64-mer
// canonical ladder (c64_1 -> c64_2 -> c64_3; PACKSIZE=64, 6-column slots at
// any label width).
//
// Replaces (utree_tpu/lookup.py): lookup_kmers_canonical64 :460 and
// search_step's k=64 branch :600-613 for a 'c64_1' table, with the shared
// front half of kmer64.cuh (ASCII windows, four-lane canonical keys, mix4,
// 6-column slot compare, decode).
//
// Bound: one random c64_1 row per window (2 slots, 48 B, two sectors), plus a
// c64_2 row (8 slots, 192 B, usually L2-resident) for the windows c64_1 does
// not hold and a c64_3 row for what c64_2 does not hold.  The three bucket
// indices derive from the key alone; a thread reads a later level only after
// a miss, as a hit never needs it.
//
// Design: one thread per (read, window), as K4.  Slot counts come from the
// table shapes at run time.  Each level has its own mix4 seed (0 folded with
// 0x6A09E667, 0x5BD1E995, 0x27D4EB2F).  A c64_2 or c64_3 of 8 rows is the
// placement's "absent" sentinel and is never probed.  Invalid windows probe
// bucket 0 of each level they reach, as JAX does, and write the miss id.

#include "kmer64.cuh"

namespace {

struct Level {
  const int32_t* rows;
  int64_t nrows;  // a power of two, or the 8-row "absent" sentinel
  int32_t slots;
};

__device__ __forceinline__ kmer::Raw probe_level(const Level& lv, uint32_t h,
                                                 bool valid, const kmer64::Key& k) {
  uint32_t bkt = valid ? h & static_cast<uint32_t>(lv.nrows - 1) : 0u;
  return kmer64::probe_row(lv.rows + static_cast<int64_t>(bkt) * 6 * lv.slots,
                           lv.slots, k);
}

__global__ void ladder_probe64_kernel(
    const uint8_t* __restrict__ reads, const int32_t* __restrict__ lens,
    int64_t B, int64_t L, int32_t W, Level c1, Level c2, Level c3,
    int32_t do_rc, int32_t miss, int32_t* __restrict__ out) {
  int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= B * W) return;
  int64_t b = t / W;
  int32_t w = static_cast<int32_t>(t - b * W);
  uint32_t k[4];
  bool valid = kmer64::window_at(reads + b * L, lens[b], w, k);
  kmer64::Key key;
  bool fwd_le = kmer64::canonical(k, key);
  kmer::Raw r = probe_level(c1, kmer64::fold_hash(key), valid, key);
  if (r.miss() && c2.nrows > 8)
    r = probe_level(c2, kmer64::mix4(key, 0x5BD1E995u), valid, key);
  if (r.miss() && c3.nrows > 8)
    r = probe_level(c3, kmer64::mix4(key, 0x27D4EB2Fu), valid, key);
  kmer64::write_ids(out, b, W, w, valid, fwd_le, r, do_rc, miss);
}

}  // namespace

extern "C" int utree_ladder_probe64(
    const void* reads, const void* lens, int64_t B, int64_t L, int32_t W,
    const void* c1, int64_t n1, int32_t s1, const void* c2, int64_t n2, int32_t s2,
    const void* c3, int64_t n3, int32_t s3, int32_t do_rc, int32_t miss,
    void* out, void* stream) {
  const int threads = 256;
  int64_t n = B * W;
  if (n > 0) {
    ladder_probe64_kernel<<<utree_blocks(n, threads), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(reads), static_cast<const int32_t*>(lens), B,
        L, W, Level{static_cast<const int32_t*>(c1), n1, s1},
        Level{static_cast<const int32_t*>(c2), n2, s2},
        Level{static_cast<const int32_t*>(c3), n3, s3}, do_rc, miss,
        static_cast<int32_t*>(out));
  }
  UTREE_LAUNCH_RESULT();
}
