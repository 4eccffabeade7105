// K8 hist_compact: packed histogram rows -> the compact readback vector.
//
// Replaces (utree_tpu/lookup.py): the epilogue of search_step_hist_compact
// :726-766.  Input: the (B, cap+1) int32 rows that K2 histogram_packed
// writes, slots (label+1) | count<<16 and a tail nuniq | found<<5.  Output:
// one flat int32 vector of 2B + (over_cap+1)*(cap+1) entries:
//   [0, 2B)  per read the pair (tail, lc0);
//   block    an (over_cap+1, cap+1) matrix: entry [0, 0] = n_over, the true
//            number of reads with nuniq >= 2 (the cap+1 overflow sentinel
//            included); rows 1..min(n_over, over_cap) = (read_id,
//            lc[0..cap-1]) of those reads in read order; the rest 0.
//
// Bound: bytes.  The rows are read once (36 B a read at cap 8) and the
// vector written once (8 B a read plus the block), 3.2 MB at the main path's
// B = 65,536: about 1 us at 3.35 TB/s.  The operations are a prefix sum of
// one flag a read.
//
// Design: the order of the block rows must be read order, which a slot
// taken with atomicAdd would not give.  So each row's place is an exclusive
// prefix sum of the flags, in two launches over tiles of 1024 reads:
// `pairs` writes the pairs and each tile's flag count; `scatter` sums the
// counts of the tiles before its own (and, in tile 0, of all tiles for the
// header), scans its tile's flags with warp ballots and writes each flagged
// row below over_cap to its place.  The block is zeroed first.

#include "common.cuh"

namespace {

constexpr int TPB = 1024;  // one tile = one block of 1024 threads = 32 warps
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ int32_t warp_sum(int32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Sum of v over the block, returned to every thread; `red` holds 32 ints.
__device__ __forceinline__ int32_t block_sum(int32_t v, int32_t* red) {
  const int lane = threadIdx.x & 31;
  v = warp_sum(v);
  if (lane == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  const int32_t t = warp_sum(red[lane]);
  __syncthreads();  // red may be written again after this
  return t;
}

__device__ __forceinline__ bool flagged(int32_t tail) { return (tail & 31) >= 2; }

__global__ void __launch_bounds__(TPB)
pairs(const int32_t* __restrict__ rows, int64_t B, int32_t c1,
      int32_t* __restrict__ out, int32_t* __restrict__ tile_counts) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * TPB + threadIdx.x;
  bool flag = false;
  if (i < B) {
    const int32_t tail = rows[i * c1 + c1 - 1];
    out[2 * i] = tail;
    out[2 * i + 1] = rows[i * c1];
    flag = flagged(tail);
  }
  const int n = __syncthreads_count(flag);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = n;
}

__global__ void __launch_bounds__(TPB)
scatter(const int32_t* __restrict__ rows, int64_t B, int32_t c1, int32_t over_cap,
        const int32_t* __restrict__ tile_counts, int32_t* __restrict__ block) {
  __shared__ int32_t red[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t before = 0, all = 0;
  for (unsigned j = threadIdx.x; j < gridDim.x; j += TPB) {
    const int32_t c = tile_counts[j];
    all += c;
    if (j < blockIdx.x) before += c;
  }
  before = block_sum(before, red);
  all = block_sum(all, red);
  if (blockIdx.x == 0 && threadIdx.x == 0) block[0] = all;

  const int64_t i = static_cast<int64_t>(blockIdx.x) * TPB + threadIdx.x;
  const bool flag = i < B && flagged(rows[i * c1 + c1 - 1]);
  const unsigned ballot = __ballot_sync(FULL, flag);
  if (lane == 0) red[warp] = __popc(ballot);
  __syncthreads();
  const int32_t wc = red[lane];
  int32_t inc = wc;  // inclusive scan of the 32 warp counts, in every warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += y;
  }
  const int32_t warp_before = __shfl_sync(FULL, inc - wc, warp);
  const int32_t pos = before + warp_before + __popc(ballot & ((1u << lane) - 1u));
  if (flag && pos < over_cap) {
    int32_t* dst = block + static_cast<int64_t>(pos + 1) * c1;
    const int32_t* src = rows + i * c1;
    dst[0] = static_cast<int32_t>(i);
    for (int32_t j = 0; j + 1 < c1; ++j) dst[1 + j] = src[j];
  }
}

}  // namespace

// rows (B, cap+1) int32; tile_counts: ceil(B/1024) int32 scratch; out
// (2B + (over_cap+1)*(cap+1),) int32.
extern "C" int utree_hist_compact(const void* rows, int64_t B, int32_t cap,
                                  int32_t over_cap, void* tile_counts, void* out,
                                  void* stream) {
  const int32_t c1 = cap + 1;
  auto st = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<int32_t*>(out);
  int32_t* block = o + 2 * B;
  cudaError_t err = cudaMemsetAsync(
      block, 0, static_cast<size_t>(over_cap + 1) * c1 * sizeof(int32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned tiles = utree_blocks(B, TPB);
  if (tiles == 0) UTREE_LAUNCH_RESULT();
  auto* r = static_cast<const int32_t*>(rows);
  auto* counts = static_cast<int32_t*>(tile_counts);
  pairs<<<tiles, TPB, 0, st>>>(r, B, c1, o, counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter<<<tiles, TPB, 0, st>>>(r, B, c1, over_cap, counts, block);
  UTREE_LAUNCH_RESULT();
}
