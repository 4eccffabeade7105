// K2 histogram: per-window label ids -> compact per-read histograms.
//
// Replaces utree_tpu/lookup.py:621 compact_histogram: per read, up to `cap`
// unique hit ids in ascending order, their counts, the true unique count
// (cap + 1 = overflow: the host replays that read) and the hit total.
//
// Bound: reading the (B, n) ids once (n = 2W = 242 for 150 bp reads with RC,
// ~1 KB a read) plus cap rounds of warp reductions over them.  The ids come
// straight from K1 and are L2-resident at the main path's batch size.
//
// Design: one warp per read.  Each lane holds its strided share of the ids
// in registers (K per lane, chosen at launch so that 32*K >= n; rows longer
// than 32*64 ids are read from memory each round instead).  A round is a
// warp min over the ids above the previous round's minimum, then a warp
// count of that minimum -- the same rounds as the JAX code, with no sort and
// no scatter.  A round whose minimum is "none" ends the loop early; the
// remaining slots keep their (-1, 0) fill, exactly as further JAX rounds
// would write them.

#include "common.cuh"

namespace {

constexpr int32_t BIG = 0x7FFFFFFF;

__device__ __forceinline__ int32_t warp_min(int32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  return v;
}

__device__ __forceinline__ int32_t warp_sum(int32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

// K > 0: ids held in K registers per lane.  K == 0: streamed from memory.
template <int K>
__global__ void histogram_kernel(const int32_t* __restrict__ ids, int64_t B,
                                 int32_t n, int32_t num_labels, int32_t cap,
                                 int32_t* __restrict__ labels,
                                 int32_t* __restrict__ counts,
                                 int32_t* __restrict__ nuniq,
                                 int32_t* __restrict__ found) {
  int64_t read = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (read >= B) return;  // whole warps exit together: B is per warp
  const int32_t* row = ids + read * n;

  // key = id for a hit (id < num_labels), BIG for a miss or past the row end
  auto key_at = [&](int32_t i) -> int32_t {
    if (i >= n) return BIG;
    int32_t v = row[i];
    return v < num_labels ? v : BIG;
  };
  int32_t reg[K > 0 ? K : 1];
  int32_t hits = 0;
  if constexpr (K > 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      reg[k] = key_at(lane + 32 * k);
      hits += reg[k] < BIG;
    }
  } else {
    for (int32_t i = lane; i < n; i += 32) hits += key_at(i) < BIG;
  }
  hits = warp_sum(hits);

  int32_t cur = -1;
  int32_t used = 0;
  for (int r = 0; r < cap; ++r) {
    int32_t lmin = BIG;
    if constexpr (K > 0) {
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (reg[k] > cur && reg[k] < lmin) lmin = reg[k];
    } else {
      for (int32_t i = lane; i < n; i += 32) {
        int32_t v = key_at(i);
        if (v > cur && v < lmin) lmin = v;
      }
    }
    int32_t m = warp_min(lmin);
    if (m == BIG) break;  // no hit id above cur: every later round is empty
    int32_t c = 0;
    if constexpr (K > 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) c += reg[k] == m;
    } else {
      for (int32_t i = lane; i < n; i += 32) c += key_at(i) == m;
    }
    c = warp_sum(c);
    if (lane == 0) {
      labels[read * cap + r] = m;
      counts[read * cap + r] = c;
    }
    cur = m;
    ++used;
  }
  if (lane == 0) {
    for (int r = used; r < cap; ++r) {
      labels[read * cap + r] = -1;
      counts[read * cap + r] = 0;
    }
  }
  // overflow: a hit id above the last extracted one (only possible when all
  // cap rounds found a label)
  int32_t over = 0;
  if (used == cap) {
    if constexpr (K > 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) over |= reg[k] > cur && reg[k] < BIG;
    } else {
      for (int32_t i = lane; i < n; i += 32) {
        int32_t v = key_at(i);
        over |= v > cur && v < BIG;
      }
    }
    over = __any_sync(0xFFFFFFFFu, over);
  }
  if (lane == 0) {
    nuniq[read] = over ? cap + 1 : used;
    found[read] = hits;
  }
}

template <int K>
void launch_histogram(const int32_t* ids, int64_t B, int32_t n, int32_t num_labels,
                      int32_t cap, int32_t* labels, int32_t* counts,
                      int32_t* nuniq, int32_t* found, cudaStream_t stream) {
  const int threads = 256;  // 8 reads per block
  histogram_kernel<K><<<utree_blocks(B * 32, threads), threads, 0, stream>>>(
      ids, B, n, num_labels, cap, labels, counts, nuniq, found);
}

}  // namespace

extern "C" int utree_histogram(const void* ids_v, int64_t B, int32_t n,
                               int32_t num_labels, int32_t cap, void* labels_v,
                               void* counts_v, void* nuniq_v, void* found_v,
                               void* stream_v) {
  auto ids = static_cast<const int32_t*>(ids_v);
  auto labels = static_cast<int32_t*>(labels_v);
  auto counts = static_cast<int32_t*>(counts_v);
  auto nuniq = static_cast<int32_t*>(nuniq_v);
  auto found = static_cast<int32_t*>(found_v);
  auto stream = static_cast<cudaStream_t>(stream_v);
  if (B > 0) {
    if (n <= 32 * 2)
      launch_histogram<2>(ids, B, n, num_labels, cap, labels, counts, nuniq, found, stream);
    else if (n <= 32 * 4)
      launch_histogram<4>(ids, B, n, num_labels, cap, labels, counts, nuniq, found, stream);
    else if (n <= 32 * 8)
      launch_histogram<8>(ids, B, n, num_labels, cap, labels, counts, nuniq, found, stream);
    else if (n <= 32 * 16)
      launch_histogram<16>(ids, B, n, num_labels, cap, labels, counts, nuniq, found, stream);
    else if (n <= 32 * 64)
      launch_histogram<64>(ids, B, n, num_labels, cap, labels, counts, nuniq, found, stream);
    else
      launch_histogram<0>(ids, B, n, num_labels, cap, labels, counts, nuniq, found, stream);
  }
  UTREE_LAUNCH_RESULT();
}
