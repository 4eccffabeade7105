// K6 ladder_probe64: ASCII reads -> per-window label ids over the 64-mer
// canonical ladder (c64_1 -> c64_2 -> c64_3; PACKSIZE=64, 6-column slots at
// any label width).
//
// Replaces (utree_tpu/lookup.py): lookup_kmers_canonical64 :460 and
// search_step's k=64 branch :600-613 for a 'c64_1' table, with the shared
// front half of kmer64.cuh (ASCII windows, four-lane canonical keys, mix4,
// 6-column slot compare, decode).
//
// Bound: one random c64_1 row per valid window (2 slots, 48 B, two
// sectors), plus a c64_2 row for the windows c64_1 does not hold -- most
// windows with a mutated base, 47% of phase 9's valid windows -- and a
// c64_3 row for what c64_2 does not hold.  At 20M 64-mers c64_2 holds 48 B
// rows (96 MiB) and c64_3 192 B rows (3 MB, in L2).  The three bucket
// indices derive from the key alone; a thread reads a later level only
// after a miss, as a hit never needs it.  The row reads are random sectors,
// and K6 reads them at the rate K1 and K7 do (PERF.md §6).
//
// Design: one thread a (read, window) lane, as K4.  A block of 256 threads
// takes a tile of 256 consecutive lanes p = b*W + w; the ASCII bytes its
// lanes read are staged in shared memory, each decoded once into its 2-bit
// code and validity bit, and each lane cuts its four lanes from them with
// funnel shifts (kmer64::staged_lane; a tile whose reads span more than the
// staged chunks, W far below L, reads its bases with window_at).  A row is
// read as 16 B loads, three a pair of slots (the levels must start on a 16
// B boundary; a level of an odd slot count is read slot by slot), and
// compared in probe_row's slot order.  Slot counts come from the table
// shapes at run time.  Each level has its own mix4 seed (0 folded with
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

constexpr int TPB = 256;  // lanes a tile, one a thread
// staged 32 B chunks of a tile: 64 cover a tile's bytes while W >= 10
constexpr int CHUNKS = 64;

// One level's row at bucket h (bucket 0 for an invalid window): a later
// matching slot wins.
__device__ __forceinline__ kmer::Raw probe_level(const Level& lv, uint32_t h,
                                                 bool valid, const kmer64::Key& k) {
  const uint32_t bkt = valid ? h & static_cast<uint32_t>(lv.nrows - 1) : 0u;
  const int32_t* row = lv.rows + static_cast<int64_t>(bkt) * 6 * lv.slots;
  if (lv.slots & 1) return kmer64::probe_row(row, lv.slots, k);
  kmer::Raw r{0, 0};
  const int4* q = reinterpret_cast<const int4*>(row);
  for (int s = 0; s < lv.slots; s += 2, q += 3) {
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

__global__ void __launch_bounds__(TPB) ladder_probe64_kernel(
    const uint8_t* __restrict__ reads, const int32_t* __restrict__ lens,
    int64_t B, int64_t L, int32_t W, Level c1, Level c2, Level c3,
    int32_t do_rc, int32_t miss, int32_t* __restrict__ out) {
  __shared__ uint32_t codes[2 * CHUNKS], valid[CHUNKS];
  const kmer64::Lane l = kmer64::staged_lane<TPB>(
      reads, lens, B * W, L, W, static_cast<int64_t>(blockIdx.x) * TPB, codes, valid, CHUNKS);
  if (!l.live) return;
  kmer64::Key key;
  const bool fwd_le = kmer64::canonical(l.k, key);
  kmer::Raw r = probe_level(c1, kmer64::fold_hash(key), l.valid, key);
  if (r.miss() && c2.nrows > 8)
    r = probe_level(c2, kmer64::mix4(key, 0x5BD1E995u), l.valid, key);
  if (r.miss() && c3.nrows > 8)
    r = probe_level(c3, kmer64::mix4(key, 0x27D4EB2Fu), l.valid, key);
  kmer64::write_ids(out, l.b, W, l.w, l.valid, fwd_le, r, do_rc, miss);
}

}  // namespace

extern "C" int utree_ladder_probe64(
    const void* reads, const void* lens, int64_t B, int64_t L, int32_t W,
    const void* c1, int64_t n1, int32_t s1, const void* c2, int64_t n2, int32_t s2,
    const void* c3, int64_t n3, int32_t s3, int32_t do_rc, int32_t miss,
    void* out, void* stream) {
  int64_t n = B * W;
  if (n > 0) {
    ladder_probe64_kernel<<<utree_blocks(n, TPB), TPB, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(reads), static_cast<const int32_t*>(lens), B,
        L, W, Level{static_cast<const int32_t*>(c1), n1, s1},
        Level{static_cast<const int32_t*>(c2), n2, s2},
        Level{static_cast<const int32_t*>(c3), n3, s3}, do_rc, miss,
        static_cast<int32_t*>(out));
  }
  UTREE_LAUNCH_RESULT();
}
