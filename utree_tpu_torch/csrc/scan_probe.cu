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
// Bound: each window is one chain of dependent loads -- the u8 seed word
// (the seed table is <= 32 MB, so it stays in the 50 MB L2), then one random
// two-slot d1 row in HBM (24 B narrow, 32 B wide: one sector either way),
// then on a miss the small cached d3 tail.  Arithmetic (two 32-bit mixes per
// hash, ~60 integer ops per window) is negligible beside the random row read.
//
// Design: one thread per (read, window), so the B*W row reads are all in
// flight at once and latency is hidden by occupancy rather than by a
// software pipeline.  Each thread rebuilds its 32 bases straight from the
// packed bytes (neighbouring threads read the same bytes, which L1 serves),
// so no (B, W) lane arrays ever reach device memory.  The slot width is a
// template parameter, so both layouts compile to fixed-stride loads.
// Invalid windows write bad_ix without touching the table: JAX probes
// bucket 0 for them and then discards the value (lookup.py:860,884,342), so
// the ids are identical.

#include "kmer.cuh"

namespace {

template <int CPS>
__global__ void scan_probe_kernel(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ vbits,
    const int32_t* __restrict__ lens, int64_t B, int64_t row4, int64_t row8,
    int32_t W, const int32_t* __restrict__ d1, int64_t nslots,
    const int32_t* __restrict__ ds, int64_t nseed,
    const int32_t* __restrict__ d3, int64_t n3, int32_t s3,
    int32_t do_rc, int32_t bad_ix, int32_t* __restrict__ out) {
  int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= B * W) return;
  int64_t b = t / W;
  int32_t w = static_cast<int32_t>(t - b * W);
  uint32_t hi32, lo32;
  bool valid = kmer::window_at(packed + b * row4, vbits + b * row8, lens[b], w,
                               hi32, lo32);
  kmer::Key k;
  bool fwd_le = true;
  kmer::Raw r{0, 0};
  if (valid) {
    fwd_le = kmer::canonical(hi32, lo32, k);
    r = kmer::displaced_probe<CPS>(k, d1, nslots, ds, nseed, d3, n3, s3);
  }
  kmer::write_ids<CPS>(out, b, W, w, valid, fwd_le, r, do_rc, bad_ix);
}

template <int CPS>
int launch(const void* packed, const void* vbits, const void* lens, int64_t B,
           int64_t row4, int64_t row8, int32_t W, const void* d1, int64_t nslots,
           const void* ds, int64_t nseed, const void* d3, int64_t n3, int32_t s3,
           int32_t do_rc, int32_t bad_ix, void* out, void* stream) {
  const int threads = 256;
  int64_t n = B * W;
  if (n > 0) {
    scan_probe_kernel<CPS><<<utree_blocks(n, threads), threads, 0,
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
