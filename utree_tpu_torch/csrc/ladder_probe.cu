// K4 ladder_probe / ladder_probe_wide: 2-bit packed reads -> per-window
// label ids over the canonical ladder (c1 -> c2 -> c3), narrow (3-column
// slots) or wide (4-column slots, IXTYPE=u32 label ids).
//
// Replaces (utree_tpu/lookup.py): canonical_buckets :262, canonical_bucket3
// :281 and lookup_kmers_canonical :349 (both branches), with the shared
// front half of kmer.cuh (windows, canonical keys, mixes, slot compare,
// decode; the c2 and c3 levels are kmer.cuh's c2_tail and t3_tail, which
// K18 shares) as _packed_window_ix and _canonical_family_ix compose them.
//
// Bound: bytes.  One random c1 row per valid window (tier A: 2 slots, 24 B
// narrow or 32 B wide), plus a c2 row for the windows whose key c1 does not
// hold (the spill tier; c2 is small and mostly L2-resident) and a c3 row for
// what c2 does not hold (tier B's cached tail); the reads in and the ids out
// stream.  The three bucket indices derive from the key alone, so a thread
// could start all three loads at once; it reads c2 and c3 only after a
// miss, since a hit never needs them.  As in K1, the random c1 rows set the
// time (scan_probe.cu).
//
// Design: K1's (scan_probe.cu): one thread a lane, a block a tile of 256
// lanes through kmer.cuh's staged_front, then the c1 row, as three 8 B or
// two 16 B loads where it has two slots (tier A; kmer::Row2), else by
// probe_row (tiers B and C place 4), then the c2 and c3 levels (kmer.cuh's
// c2_tail and t3_tail, which K18 shares) for the misses only, in order.
// The slot counts come from the table shapes at run time, the slot width
// is a template parameter.  A c2 (or c3) table of 8 rows is the placement's
// "absent" sentinel and is never probed, as in JAX.  Invalid windows write
// bad_ix without a probe: JAX probes bucket 0 for them and then discards
// the value, so the ids are identical.

#include "kmer.cuh"

namespace {

constexpr int TPB = 256;      // lanes a tile, one a thread
constexpr int PK_WORDS = 520;  // staged words of a tile, as K1's
constexpr int VB_WORDS = 264;

struct Level {
  const int32_t* rows;
  int64_t nrows;  // a power of two, or the 8-row "absent" sentinel
  int32_t slots;
};

template <int CPS>
__global__ void __launch_bounds__(TPB) ladder_probe_kernel(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ vbits,
    const int32_t* __restrict__ lens, int64_t B, int64_t row4, int64_t row8,
    int32_t W, Level c1, Level c2, Level c3, int32_t do_rc, int32_t bad_ix,
    int32_t* __restrict__ out) {
  __shared__ uint32_t spk[PK_WORDS], svb[VB_WORDS];
  const kmer::Window l = kmer::staged_front<TPB>(
      packed, vbits, lens, B * W, row4, row8, W, static_cast<int64_t>(blockIdx.x) * TPB, spk,
      PK_WORDS, svb, VB_WORDS);
  if (!l.live) return;
  kmer::Raw r{0, 0};
  if (l.valid) {
    const uint32_t b1 = kmer::fold_hash(l.k) & static_cast<uint32_t>(c1.nrows - 1);
    const int32_t* row = c1.rows + static_cast<int64_t>(b1) * CPS * c1.slots;
    r = c1.slots == 2 ? kmer::match_row2<CPS>(kmer::load_row2<CPS>(row), l.k)
                      : kmer::probe_row<CPS>(row, c1.slots, l.k);
    kmer::c2_tail<CPS>(r, l.k, c2.rows, c2.nrows, c2.slots);
    kmer::t3_tail<CPS>(r, l.k, c3.rows, c3.nrows, c3.slots);
  }
  kmer::write_ids<CPS>(out, l.b, W, l.w, l.valid, l.fwd_le, r, do_rc, bad_ix);
}

template <int CPS>
int launch(const void* packed, const void* vbits, const void* lens, int64_t B,
           int64_t row4, int64_t row8, int32_t W, const void* c1, int64_t n1,
           int32_t s1, const void* c2, int64_t n2, int32_t s2, const void* c3,
           int64_t n3, int32_t s3, int32_t do_rc, int32_t bad_ix, void* out,
           void* stream) {
  int64_t n = B * W;
  if (n > 0) {
    ladder_probe_kernel<CPS><<<utree_blocks(n, TPB), TPB, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed), static_cast<const uint8_t*>(vbits),
        static_cast<const int32_t*>(lens), B, row4, row8, W,
        Level{static_cast<const int32_t*>(c1), n1, s1},
        Level{static_cast<const int32_t*>(c2), n2, s2},
        Level{static_cast<const int32_t*>(c3), n3, s3}, do_rc, bad_ix,
        static_cast<int32_t*>(out));
  }
  UTREE_LAUNCH_RESULT();
}

}  // namespace

extern "C" int utree_ladder_probe(
    const void* packed, const void* vbits, const void* lens, int64_t B,
    int64_t row4, int64_t row8, int32_t W, const void* c1, int64_t n1, int32_t s1,
    const void* c2, int64_t n2, int32_t s2, const void* c3, int64_t n3, int32_t s3,
    int32_t do_rc, int32_t bad_ix, void* out, void* stream) {
  return launch<3>(packed, vbits, lens, B, row4, row8, W, c1, n1, s1, c2, n2, s2,
                   c3, n3, s3, do_rc, bad_ix, out, stream);
}

extern "C" int utree_ladder_probe_wide(
    const void* packed, const void* vbits, const void* lens, int64_t B,
    int64_t row4, int64_t row8, int32_t W, const void* c1, int64_t n1, int32_t s1,
    const void* c2, int64_t n2, int32_t s2, const void* c3, int64_t n3, int32_t s3,
    int32_t do_rc, int32_t bad_ix, void* out, void* stream) {
  return launch<4>(packed, vbits, lens, B, row4, row8, W, c1, n1, s1, c2, n2, s2,
                   c3, n3, s3, do_rc, bad_ix, out, stream);
}
