// K12 owner_probe / owner_probe_wide: routed lanes of (bucket, key_lo,
// key_hi) -> the raw value of each lane's key in one shard's slice of the
// seeded-displacement table, narrow (3-column slots, one int32 a lane) or
// wide (4-column slots, the (va, vb) pair).
//
// Replaces (utree_tpu/parallel/routed.py): _displaced_local_probe :405-419,
// the owner side of _routed_probe_displaced :443-457 and the probe of
// routed_displaced_fallback_step :554-570 (displaced_seed_jnp,
// displaced_slot_jnp, one 2-slot row compare), with kmer.cuh's
// displaced_t1, the seed and slot lines of K1's displaced probe.
//
// K17 canonical_owner_probe / canonical_owner_probe_wide: the same lanes
// -> the raw value of each lane's key in one shard's slice of the
// canonical hash table's t1, rows of `slots` slots.
//
// Replaces (utree_tpu/parallel/routed.py): the owner side of
// _routed_probe_t1 :153-165 (t1_local[recv[..., 0]], probe_rows[_wide])
// and the probe of routed_fallback_step :250-266, with kmer.cuh's
// probe_row.  K12 less the seed read: the lane's bucket is its row.
//
// In both, a lane whose bucket lies outside [base, base + per) gives 0.
// The routed step's receive buffer holds local buckets (base 0: every lane
// is probed, the unwritten slots at bucket 0 with key 0, whose replies
// nobody reads); the broadcast fallback holds global buckets and shard s
// passes base s*per, so each bucket is probed by its one owner and the sum
// of the shards' values is the value.
//
// Bound: bytes.  Per lane the 12 B lane is read and 4 or 8 B written, plus
// one random row for each lane a sender wrote (K12: a 24 or 32 B d1 row,
// one sector, and the seed word, whose table (a quarter of the 8 MB seed
// table at 20M entries) stays in the 50 MB L2; K17: a c1 row of slots*12
// or slots*16 B, one sector at tier A's two slots): at 3.4M lanes about
// 0.04 ms at 3.35 TB/s.
//
// Design: one thread per lane, so all row reads are in flight at once, as
// in K1; no lane depends on another.

#include "kmer.cuh"

namespace {

template <int CPS>
__global__ void owner_probe_kernel(const int32_t* __restrict__ lanes, int64_t N,
                                   int64_t base, int64_t per_seed,
                                   const int32_t* __restrict__ d1, int64_t nslots,
                                   const int32_t* __restrict__ ds,
                                   int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int64_t bkt = lanes[3 * i];
  kmer::Raw r{0, 0};
  if (bkt >= base && bkt < base + per_seed) {
    r = kmer::displaced_t1<CPS>(kmer::key_of(lanes[3 * i + 1], lanes[3 * i + 2]),
                                static_cast<uint32_t>(bkt - base), d1, nslots, ds);
  }
  if (CPS == 4) {
    out[2 * i] = r.a;
    out[2 * i + 1] = r.b;
  } else {
    out[i] = r.a;
  }
}

template <int CPS>
__global__ void canonical_owner_probe_kernel(const int32_t* __restrict__ lanes, int64_t N,
                                             int64_t base, int64_t per_shard,
                                             const int32_t* __restrict__ t1,
                                             int32_t slots, int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int64_t bkt = lanes[3 * i];
  kmer::Raw r{0, 0};
  if (bkt >= base && bkt < base + per_shard) {
    r = kmer::probe_row<CPS>(t1 + (bkt - base) * CPS * slots, slots,
                             kmer::key_of(lanes[3 * i + 1], lanes[3 * i + 2]));
  }
  if (CPS == 4) {
    out[2 * i] = r.a;
    out[2 * i + 1] = r.b;
  } else {
    out[i] = r.a;
  }
}

template <int CPS>
int launch(const void* lanes, int64_t N, int64_t base, int64_t per_seed, const void* d1,
           int64_t nslots, const void* ds, void* out, void* stream) {
  const int threads = 256;
  if (N > 0) {
    owner_probe_kernel<CPS><<<utree_blocks(N, threads), threads, 0,
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
  const int threads = 256;
  if (N > 0) {
    canonical_owner_probe_kernel<CPS><<<utree_blocks(N, threads), threads, 0,
                                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(lanes), N, base, per_shard,
        static_cast<const int32_t*>(t1), slots, static_cast<int32_t*>(out));
  }
  UTREE_LAUNCH_RESULT();
}

}  // namespace

// lanes (N, 3) int32; d1 (nslots/2, 2*CPS) and ds (per_seed/4,) one
// shard's slices; out (N,) narrow or (N, 2) wide int32.
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

// lanes (N, 3) int32; t1 (per_shard, slots*CPS) one shard's slice; out (N,)
// narrow or (N, 2) wide int32.
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
