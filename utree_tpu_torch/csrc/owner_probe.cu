// K12 owner_probe / owner_probe_wide: routed lanes of (bucket, key_lo,
// key_hi) -> the raw value of each lane's key in one shard's slice of the
// seeded-displacement table, narrow (3-column slots, one int32 a lane) or
// wide (4-column slots, the (va, vb) pair).
//
// Replaces (utree_tpu/parallel/routed.py): _displaced_local_probe :405-419,
// the owner side of _routed_probe_displaced :443-457 and the probe of
// routed_displaced_fallback_step :554-570 (displaced_seed_jnp,
// displaced_slot_jnp, one 2-slot row compare), with kmer.cuh's
// displaced_slot, the seed and slot lines of K1's displaced probe.
//
// K17 canonical_owner_probe / canonical_owner_probe_wide: the same lanes
// -> the raw value of each lane's key in one shard's slice of the
// canonical hash table's t1, rows of `slots` slots.
//
// Replaces (utree_tpu/parallel/routed.py): the owner side of
// _routed_probe_t1 :153-165 (t1_local[recv[..., 0]], probe_rows[_wide])
// and the probe of routed_fallback_step :250-266.  K12 less the seed read:
// the lane's bucket is its row.
//
// In both, a lane whose bucket lies outside [base, base + per) gives 0.
// The routed step's receive buffer holds local buckets (base 0: every lane
// is probed, the unwritten slots at bucket 0 with key 0, whose replies
// nobody reads); the broadcast fallback holds global buckets and shard s
// passes base s*per, so each bucket is probed by its one owner and the sum
// of the shards' values is the value.
//
// Bound: bytes.  Per lane the 12 B lane is read and 4 or 8 B written, plus
// one random row for each lane a sender wrote (K12: a 24 or 32 B d1 row
// and the seed word, whose slice (2 MB a shard at 20M entries) stays in
// the 50 MB L2; K17: a c1 row of slots*12 or slots*16 B, 24 or 32 B at
// tier A's two slots): at 3.4M lanes about 0.035 ms at 3.35 TB/s.  The
// random rows set the time: at the routed step's shape about 1.95M of
// them, half the 24 B ones across two sectors.
//
// Design: one thread a lane, 256 a block, all row reads in flight at once.
// A two-slot row (every d1 row; a c1 row at tier A) is loaded as K1 and
// K4 load theirs (kmer.cuh's load_row2: three 8 B loads narrow, two 16 B
// wide; the table 8 or 16 B aligned, which the wrapper checks) and
// compared by match_row2, so its second sector no longer waits for the
// first slot's compare; a c1 of other slot counts (the chain geometry's 4)
// goes through probe_row.  The wide pair is written as one 8 B store.
// Measured on an H100 and not kept (PERF.md §6): the lanes staged through
// shared memory by 16 B loads, two lanes a thread, cache hints on the rows
// and seed words, and skipping the lane reads of K11's zeroed tail given
// each sender's count (which the step would have to exchange).

#include "kmer.cuh"

namespace {

constexpr int TPB = 256;  // lanes a block, one a thread

template <int CPS>
__device__ __forceinline__ void write_raw(int32_t* out, int64_t i, kmer::Raw r) {
  if constexpr (CPS == 4) {
    reinterpret_cast<int2*>(out)[i] = make_int2(r.a, r.b);
  } else {
    out[i] = r.a;
  }
}

template <int CPS>
__global__ void __launch_bounds__(TPB) owner_probe_kernel(
    const int32_t* __restrict__ lanes, int64_t N, int64_t base, int64_t per_seed,
    const int32_t* __restrict__ d1, int64_t nslots, const int32_t* __restrict__ ds,
    int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * TPB + threadIdx.x;
  if (i >= N) return;
  const int64_t bkt = lanes[3 * i];
  kmer::Raw r{0, 0};
  if (bkt >= base && bkt < base + per_seed) {
    const kmer::Key k = kmer::key_of(lanes[3 * i + 1], lanes[3 * i + 2]);
    const uint32_t b = static_cast<uint32_t>(bkt - base);
    const uint32_t slot =
        kmer::displaced_slot(k, b, static_cast<uint32_t>(__ldg(ds + (b >> 2))), nslots);
    r = kmer::match_row2<CPS>(
        kmer::load_row2<CPS>(d1 + static_cast<int64_t>(slot >> 1) * 2 * CPS), k);
  }
  write_raw<CPS>(out, i, r);
}

template <int CPS>
__global__ void __launch_bounds__(TPB) canonical_owner_probe_kernel(
    const int32_t* __restrict__ lanes, int64_t N, int64_t base, int64_t per_shard,
    const int32_t* __restrict__ t1, int32_t slots, int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * TPB + threadIdx.x;
  if (i >= N) return;
  const int64_t bkt = lanes[3 * i];
  kmer::Raw r{0, 0};
  if (bkt >= base && bkt < base + per_shard) {
    const kmer::Key k = kmer::key_of(lanes[3 * i + 1], lanes[3 * i + 2]);
    const int32_t* row = t1 + (bkt - base) * CPS * slots;
    r = slots == 2 ? kmer::match_row2<CPS>(kmer::load_row2<CPS>(row), k)
                   : kmer::probe_row<CPS>(row, slots, k);
  }
  write_raw<CPS>(out, i, r);
}

template <int CPS>
int launch(const void* lanes, int64_t N, int64_t base, int64_t per_seed, const void* d1,
           int64_t nslots, const void* ds, void* out, void* stream) {
  if (N > 0) {
    owner_probe_kernel<CPS><<<utree_blocks(N, TPB), TPB, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(lanes), N, base, per_seed,
        static_cast<const int32_t*>(d1), nslots, static_cast<const int32_t*>(ds),
        static_cast<int32_t*>(out));
  }
  UTREE_LAUNCH_RESULT();
}

template <int CPS>
int launch_canonical(const void* lanes, int64_t N, int64_t base, int64_t per_shard,
                     const void* t1, int32_t slots, void* out, void* stream) {
  if (N > 0) {
    canonical_owner_probe_kernel<CPS><<<utree_blocks(N, TPB), TPB, 0,
                                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(lanes), N, base, per_shard,
        static_cast<const int32_t*>(t1), slots, static_cast<int32_t*>(out));
  }
  UTREE_LAUNCH_RESULT();
}

}  // namespace

// lanes (N, 3) int32; d1 (nslots/2, 2*CPS), 8 B aligned narrow and 16 B
// wide, and ds (per_seed/4,) one shard's slices; out (N,) narrow or (N, 2)
// wide int32.
extern "C" int utree_owner_probe(const void* lanes, int64_t N, int64_t base,
                                 int64_t per_seed, const void* d1, int64_t nslots,
                                 const void* ds, void* out, void* stream) {
  return launch<3>(lanes, N, base, per_seed, d1, nslots, ds, out, stream);
}

extern "C" int utree_owner_probe_wide(const void* lanes, int64_t N, int64_t base,
                                      int64_t per_seed, const void* d1, int64_t nslots,
                                      const void* ds, void* out, void* stream) {
  return launch<4>(lanes, N, base, per_seed, d1, nslots, ds, out, stream);
}

// lanes (N, 3) int32; t1 (per_shard, slots*CPS) one shard's slice, 8 B
// aligned narrow and 16 B wide where slots is 2; out (N,) narrow or (N, 2)
// wide int32.
extern "C" int utree_canonical_owner_probe(const void* lanes, int64_t N, int64_t base,
                                           int64_t per_shard, const void* t1,
                                           int32_t slots, void* out, void* stream) {
  return launch_canonical<3>(lanes, N, base, per_shard, t1, slots, out, stream);
}

extern "C" int utree_canonical_owner_probe_wide(const void* lanes, int64_t N, int64_t base,
                                                int64_t per_shard, const void* t1,
                                                int32_t slots, void* out, void* stream) {
  return launch_canonical<4>(lanes, N, base, per_shard, t1, slots, out, stream);
}
