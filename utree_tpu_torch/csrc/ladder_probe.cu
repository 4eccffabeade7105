// K4 ladder_probe / ladder_probe_wide: 2-bit packed reads -> per-window
// label ids over the canonical ladder (c1 -> c2 -> c3), narrow (3-column
// slots) or wide (4-column slots, IXTYPE=u32 label ids).
//
// Replaces (utree_tpu/lookup.py): canonical_buckets :262, canonical_bucket3
// :281 and lookup_kmers_canonical :349 (both branches), with the shared
// front half of kmer.cuh (windows, canonical keys, mixes, slot compare,
// decode) as _packed_window_ix and _canonical_family_ix compose them.
//
// Bound: one random c1 row per valid window (tier A: 2 slots, 24 B narrow
// or 32 B wide, one sector), plus a c2 row for the windows whose key c1 does
// not hold (the spill tier; c2 is small and mostly L2-resident) and a c3 row
// for what c2 does not hold (tier B's cached tail).  The three bucket indices
// derive from the key alone, so a thread could start all three loads at
// once; it reads c2 and c3 only after a miss, since a hit never needs them.
//
// Design: one thread per (read, window), as K1.  The slot counts come from
// the table shapes at run time (tiers A, B and C place 2, 4 and 4 c1 slots),
// the slot width is a template parameter.  A c2 (or c3) table of 8 rows is
// the placement's "absent" sentinel and is never probed, as in JAX.  Invalid
// windows write bad_ix without a probe: JAX probes bucket 0 for them and
// then discards the value, so the ids are identical.

#include "kmer.cuh"

namespace {

struct Level {
  const int32_t* rows;
  int64_t nrows;  // a power of two, or the 8-row "absent" sentinel
  int32_t slots;
};

template <int CPS>
__global__ void ladder_probe_kernel(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ vbits,
    const int32_t* __restrict__ lens, int64_t B, int64_t row4, int64_t row8,
    int32_t W, Level c1, Level c2, Level c3, int32_t do_rc, int32_t bad_ix,
    int32_t* __restrict__ out) {
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
    uint32_t b1 = kmer::fold_hash(k) & static_cast<uint32_t>(c1.nrows - 1);
    r = kmer::probe_row<CPS>(c1.rows + static_cast<int64_t>(b1) * CPS * c1.slots,
                             c1.slots, k);
    if (r.miss() && c2.nrows > 8) {
      uint32_t b2 = kmer::mix32(k.pre, k.hi8, k.lo ^ 0x5BD1E995u) &
                    static_cast<uint32_t>(c2.nrows - 1);
      r = kmer::probe_row<CPS>(c2.rows + static_cast<int64_t>(b2) * CPS * c2.slots,
                               c2.slots, k);
    }
    if (r.miss() && c3.nrows > 8) {
      uint32_t b3 = kmer::mix32(k.pre, k.hi8, k.lo ^ 0x27D4EB2Fu) &
                    static_cast<uint32_t>(c3.nrows - 1);
      r = kmer::probe_row<CPS>(c3.rows + static_cast<int64_t>(b3) * CPS * c3.slots,
                               c3.slots, k);
    }
  }
  kmer::write_ids<CPS>(out, b, W, w, valid, fwd_le, r, do_rc, bad_ix);
}

template <int CPS>
int launch(const void* packed, const void* vbits, const void* lens, int64_t B,
           int64_t row4, int64_t row8, int32_t W, const void* c1, int64_t n1,
           int32_t s1, const void* c2, int64_t n2, int32_t s2, const void* c3,
           int64_t n3, int32_t s3, int32_t do_rc, int32_t bad_ix, void* out,
           void* stream) {
  const int threads = 256;
  int64_t n = B * W;
  if (n > 0) {
    ladder_probe_kernel<CPS><<<utree_blocks(n, threads), threads, 0,
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
