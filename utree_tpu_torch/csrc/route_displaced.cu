// K11 route_displaced: one data shard's 2-bit packed reads -> the routed
// displaced probe's send buffer, one record a window lane, and the count of
// valid lanes for each owner shard.
//
// Replaces (utree_tpu/parallel/routed.py): the data side of
// _routed_probe_displaced :422-441 and the lane set-up of
// routed_displaced_search_step :492-500 (windows, canonical keys,
// displaced_bucket_jnp, owner and local bucket, each lane's rank among the
// valid lanes of its owner, the (S, C, 3) scatter with mode="drop", the
// overflow test), with kmer.cuh's window_at, canonical and fold_hash.
// The routed canonical steps call it with nseed = b1: the same fold, masked
// to a power of two, is the canonical t1 bucket (canonical_buckets,
// utree_tpu/lookup.py:262-279), so it also replaces the data side of
// _routed_probe_t1 :121-150 and the lane set-up of
// routed_canonical_search_step :185-198.
// Output, for P = B*W lanes p = b*W + w:
//   send   (S, C, 3) int32: (local bucket, key_lo, key_hi) of the lane of
//          rank r in block (owner, r); unwritten slots stay 0;
//   rec    (P, 4) int32: (slot = owner*C + rank, or -1 for a lane not
//          routed; key_lo; key_hi; valid | fwd_le<<1), (-1, 0, 0, 0) for
//          an invalid window;
//   counts (S+1,) int32: valid lanes per owner, then 1 if any exceeds C.
//
// Bound: bytes.  The packed reads are read once (about 0.8 MB for 16,384
// reads of 192 bases), the records (16 B a lane, 42 MB at 2.6M lanes) and
// the send buffer (12 B a slot) written once: about 0.025 ms at 3.35 TB/s.
// The arithmetic is K1's front half, some 60 integer operations a lane.
//
// Design: a lane's rank is its place among its owner's valid lanes in lane
// order, as the cumsum of routed.py:430-434 gives it, so that a batch that
// overflows drops the same lanes as JAX.  A slot taken with atomicAdd would
// not keep that order, so the rank is an exclusive prefix sum in three
// launches over tiles of 1024 lanes, as K8 orders its rows: `lanes` writes
// each lane's record (local bucket in the slot field, owner in the flags)
// and its tile's count for each owner (S <= 8 block counts); `scan`, one
// block, turns the tile counts into each tile's exclusive prefix for each
// owner and the totals; `scatter` adds the in-tile rank from warp ballots,
// writes the payload of each lane of rank < C to its slot and rewrites the
// record.  The record is written twice (a second 42 MB pass), which keeps
// every pass a single read of each lane.

#include "kmer.cuh"

namespace {

constexpr int TPB = 1024;  // one tile = one block of 32 warps
constexpr int MAX_SHARDS = 8;
constexpr unsigned FULL = 0xFFFFFFFFu;

__global__ void __launch_bounds__(TPB)
lanes(const uint8_t* __restrict__ packed, const uint8_t* __restrict__ vbits,
      const int32_t* __restrict__ lens, int64_t B, int64_t row4, int64_t row8,
      int32_t W, int64_t nseed, int32_t S, int4* __restrict__ rec,
      int32_t* __restrict__ tile_counts) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * TPB + threadIdx.x;
  int owner = -1;
  if (p < B * W) {
    const int64_t b = p / W;
    const int32_t w = static_cast<int32_t>(p - b * W);
    uint32_t hi32, lo32;
    int4 r = make_int4(-1, 0, 0, 0);
    if (kmer::window_at(packed + b * row4, vbits + b * row8, lens[b], w, hi32, lo32)) {
      kmer::Key k;
      const int fwd_le = kmer::canonical(hi32, lo32, k) ? 1 : 0;
      const uint32_t per_seed = static_cast<uint32_t>(nseed / S);
      const uint32_t g = kmer::fold_hash(k) & static_cast<uint32_t>(nseed - 1);
      owner = static_cast<int>(g / per_seed);
      r = make_int4(static_cast<int32_t>(g - owner * per_seed), k.klo, k.khi,
                    1 | (fwd_le << 1) | (owner << 2));
    }
    rec[p] = r;
  }
  for (int o = 0; o < S; ++o) {
    const int n = __syncthreads_count(owner == o);
    if (threadIdx.x == 0) tile_counts[static_cast<int64_t>(blockIdx.x) * S + o] = n;
  }
}

// Inclusive scan of v over the block (1024 threads); `total` gets the sum.
__device__ __forceinline__ int32_t block_scan(int32_t v, int32_t* red, int32_t& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) red[warp] = inc;
  __syncthreads();
  const int32_t ws = red[lane];
  int32_t wi = ws;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(FULL, wi, o);
    if (lane >= o) wi += y;
  }
  const int32_t before = __shfl_sync(FULL, wi - ws, warp);
  total = __shfl_sync(FULL, wi, 31);
  __syncthreads();  // red may be written again after this
  return before + inc;
}

__global__ void __launch_bounds__(TPB)
scan(const int32_t* __restrict__ tile_counts, int64_t tiles, int32_t S, int32_t C,
     int32_t* __restrict__ tile_before, int32_t* __restrict__ counts) {
  __shared__ int32_t red[32];
  int32_t over = 0;
  for (int o = 0; o < S; ++o) {
    int32_t carry = 0;
    for (int64_t base = 0; base < tiles; base += TPB) {
      const int64_t j = base + threadIdx.x;
      const int32_t v = j < tiles ? tile_counts[j * S + o] : 0;
      int32_t total;
      const int32_t inc = block_scan(v, red, total);
      if (j < tiles) tile_before[j * S + o] = carry + inc - v;
      carry += total;
    }
    if (threadIdx.x == 0) counts[o] = carry;
    over |= carry > C;
  }
  if (threadIdx.x == 0) counts[S] = over;
}

__global__ void __launch_bounds__(TPB)
scatter(int4* __restrict__ rec, int64_t P, int32_t S, int32_t C,
        const int32_t* __restrict__ tile_before, int32_t* __restrict__ send) {
  __shared__ int32_t wcount[MAX_SHARDS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * TPB + threadIdx.x;
  int4 r = p < P ? rec[p] : make_int4(-1, 0, 0, 0);
  const bool valid = p < P && (r.w & 1);
  const int owner = valid ? (r.w >> 2) : -1;
  unsigned mine = 0;
  for (int o = 0; o < S; ++o) {
    const unsigned bal = __ballot_sync(FULL, owner == o);
    if (lane == 0) wcount[o][warp] = __popc(bal);
    if (owner == o) mine = bal;
  }
  __syncthreads();
  if (p >= P) return;
  int32_t slot = -1;
  if (valid) {
    int32_t rank = tile_before[static_cast<int64_t>(blockIdx.x) * S + owner] +
                   __popc(mine & ((1u << lane) - 1u));
    for (int j = 0; j < warp; ++j) rank += wcount[owner][j];
    if (rank < C) {
      slot = owner * C + rank;
      int32_t* d = send + static_cast<int64_t>(slot) * 3;
      d[0] = r.x;
      d[1] = r.y;
      d[2] = r.z;
    }
  }
  r.x = slot;
  r.w = valid ? (r.w & 3) : 0;
  rec[p] = r;
}

}  // namespace

// packed (B, row4) u8, vbits (B, row8) u8, lens (B,) i32; W windows a read;
// nseed the global seed count (S divides it); S shards (1..8); C slots an
// owner; tile_counts, tile_before: ceil(B*W/1024)*S int32 scratch; send
// (S, C, 3), rec (B*W, 4), counts (S+1,) int32.
extern "C" int utree_route_displaced(
    const void* packed, const void* vbits, const void* lens, int64_t B, int64_t row4,
    int64_t row8, int32_t W, int64_t nseed, int32_t S, int32_t C, void* tile_counts,
    void* tile_before, void* send, void* rec, void* counts, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      send, 0, static_cast<size_t>(S) * C * 3 * sizeof(int32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t P = B * W;
  const unsigned tiles = utree_blocks(P, TPB);
  auto* r = static_cast<int4*>(rec);
  auto* tc = static_cast<int32_t*>(tile_counts);
  auto* tb = static_cast<int32_t*>(tile_before);
  if (tiles > 0) {
    lanes<<<tiles, TPB, 0, st>>>(static_cast<const uint8_t*>(packed),
                                 static_cast<const uint8_t*>(vbits),
                                 static_cast<const int32_t*>(lens), B, row4, row8, W,
                                 nseed, S, r, tc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  scan<<<1, TPB, 0, st>>>(tc, tiles, S, C, tb, static_cast<int32_t*>(counts));
  if (tiles == 0) UTREE_LAUNCH_RESULT();
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter<<<tiles, TPB, 0, st>>>(r, P, S, C, tb, static_cast<int32_t*>(send));
  UTREE_LAUNCH_RESULT();
}
