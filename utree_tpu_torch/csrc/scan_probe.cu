// K1 scan_probe / scan_probe_wide: 2-bit packed reads -> per-window label
// ids over the seeded-displacement table, narrow (3-column slots, u16-packed
// dual values) or wide (4-column slots, IXTYPE=u32 label ids).
//
// Replaces (utree_tpu/lookup.py): displaced_bucket/seed/slot_jnp :850-884,
// canonical_bucket3 :281 and displaced_probe_raw :887 (both branches), with
// the shared front half of kmer.cuh (windows, canonical keys, mixes, the
// displaced probe, slot compare, decode), including _packed_window_ix's
// true_len trim.
//
// Bound: bytes.  Each valid window needs one random two-slot d1 row in HBM
// (24 B narrow, 32 B wide), after its u8 seed word (the seed table is <= 32
// MB, so it stays in the 50 MB L2), then on a miss a row of the small cached
// d3 tail; the reads in and the ids out stream.  Arithmetic (two 32-bit
// mixes a hash, about 60 integer operations a window) is far under the
// card's rate.  Random 24 B rows do not reach the memory's rate: on an
// H100 the narrow probe takes about as long as torch.index_select of the
// same d1 rows (PERF.md §6).
//
// Design: one thread a (read, window) lane, so that the card holds as many
// row reads in flight as its occupancy allows (a thread of two or four
// lanes, each lane's loads issued before any compare, was slower: more
// registers, fewer threads; PERF.md §6).  A block of 256 threads takes a
// tile of 256 consecutive lanes p = b*W + w.  The front half is kmer.cuh's
// staged_front: the tile's packed bytes and validity bits are staged in
// shared memory and each lane's 32 bases cut from them with byte permutes
// and funnel shifts (seven shared loads where window_at makes 64 byte
// loads), as K11 does.  The d1 row then comes as three 8 B (narrow) or two
// 16 B (wide) loads (kmer::Row2); the d3 tail follows for the misses only.
// Tiles are independent (no ranks across them), so blocks take them in
// blockIdx order.  The slot width is a template parameter, so both layouts
// compile to fixed-stride loads.  Invalid windows write bad_ix without
// touching the table: JAX probes bucket 0 for them and then discards the
// value (lookup.py:860,884,342), so the ids are identical.

#include "kmer.cuh"

namespace {

constexpr int TPB = 256;  // lanes a tile, one a thread
// staged words of a tile: a lane adds at most 8 packed and 4 validity bytes
// once W is near the packed width, plus the slack kmer::stage writes
constexpr int PK_WORDS = 520;
constexpr int VB_WORDS = 264;

template <int CPS>
__global__ void __launch_bounds__(TPB) scan_probe_kernel(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ vbits,
    const int32_t* __restrict__ lens, int64_t B, int64_t row4, int64_t row8,
    int32_t W, const int32_t* __restrict__ d1, int64_t nslots,
    const int32_t* __restrict__ ds, int64_t nseed,
    const int32_t* __restrict__ d3, int64_t n3, int32_t s3,
    int32_t do_rc, int32_t bad_ix, int32_t* __restrict__ out) {
  __shared__ uint32_t spk[PK_WORDS], svb[VB_WORDS];
  const kmer::Window l = kmer::staged_front<TPB>(
      packed, vbits, lens, B * W, row4, row8, W, static_cast<int64_t>(blockIdx.x) * TPB, spk,
      PK_WORDS, svb, VB_WORDS);
  if (!l.live) return;
  kmer::Raw r{0, 0};
  if (l.valid) {
    const uint32_t bkt = kmer::fold_hash(l.k) & static_cast<uint32_t>(nseed - 1);
    const uint32_t slot = kmer::displaced_slot(
        l.k, bkt, static_cast<uint32_t>(__ldg(ds + (bkt >> 2))), nslots);
    r = kmer::match_row2<CPS>(
        kmer::load_row2<CPS>(d1 + static_cast<int64_t>(slot >> 1) * 2 * CPS), l.k);
    kmer::t3_tail<CPS>(r, l.k, d3, n3, s3);
  }
  kmer::write_ids<CPS>(out, l.b, W, l.w, l.valid, l.fwd_le, r, do_rc, bad_ix);
}

template <int CPS>
int launch(const void* packed, const void* vbits, const void* lens, int64_t B,
           int64_t row4, int64_t row8, int32_t W, const void* d1, int64_t nslots,
           const void* ds, int64_t nseed, const void* d3, int64_t n3, int32_t s3,
           int32_t do_rc, int32_t bad_ix, void* out, void* stream) {
  int64_t n = B * W;
  if (n > 0) {
    scan_probe_kernel<CPS><<<utree_blocks(n, TPB), TPB, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed), static_cast<const uint8_t*>(vbits),
        static_cast<const int32_t*>(lens), B, row4, row8, W,
        static_cast<const int32_t*>(d1), nslots, static_cast<const int32_t*>(ds),
        nseed, static_cast<const int32_t*>(d3), n3, s3, do_rc, bad_ix,
        static_cast<int32_t*>(out));
  }
  UTREE_LAUNCH_RESULT();
}

}  // namespace

extern "C" int utree_scan_probe(
    const void* packed, const void* vbits, const void* lens, int64_t B,
    int64_t row4, int64_t row8, int32_t W, const void* d1, int64_t nslots,
    const void* ds, int64_t nseed, const void* d3, int64_t n3, int32_t s3,
    int32_t do_rc, int32_t bad_ix, void* out, void* stream) {
  return launch<3>(packed, vbits, lens, B, row4, row8, W, d1, nslots, ds, nseed,
                   d3, n3, s3, do_rc, bad_ix, out, stream);
}

extern "C" int utree_scan_probe_wide(
    const void* packed, const void* vbits, const void* lens, int64_t B,
    int64_t row4, int64_t row8, int32_t W, const void* d1, int64_t nslots,
    const void* ds, int64_t nseed, const void* d3, int64_t n3, int32_t s3,
    int32_t do_rc, int32_t bad_ix, void* out, void* stream) {
  return launch<4>(packed, vbits, lens, B, row4, row8, W, d1, nslots, ds, nseed,
                   d3, n3, s3, do_rc, bad_ix, out, stream);
}

extern "C" const char* utree_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
