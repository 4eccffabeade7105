// K2 histogram / histogram_packed / histogram_unpacked: per-window label ids
// -> per-read histograms, in the three layouts the search steps read back.
//
// Replaces (utree_tpu/lookup.py): compact_histogram :621 (four arrays: per
// read up to `cap` unique hit ids in ascending order, their counts, the true
// unique count -- cap + 1 = overflow: the host replays that read -- and the
// hit total); pack_hist :811, the (B, cap+1) layout of
// search_step_hist_packed :711 ((label+1) | count<<16, tail nuniq |
// found<<5); and the (B, 2*cap+2) [labels | counts | nuniq | found] layout of
// search_step_hist_packed_in :820.  The three differ only in the epilogue.
//
// Bound: reading the (B, n) ids once (n = 2W = 242 for 150 bp reads with RC,
// ~1 KB a read) plus cap rounds of warp reductions over them.  The ids come
// straight from the probe kernel and are L2-resident at the main path's
// batch size.  Long-read chunks (up to 2 x 16,384 ids a row) are read from
// memory once per round instead.
//
// Design: one warp per read.  Each lane holds its strided share of the ids
// in registers (K per lane, chosen at launch so that 32*K >= n; rows longer
// than 32*64 ids are read from memory each round instead).  A round is a
// warp min over the ids above the previous round's minimum, then a warp
// count of that minimum -- the same rounds as the JAX code, with no sort and
// no scatter.  A round whose minimum is "none" ends the loop early; the
// remaining slots keep their (-1, 0) fill, exactly as further JAX rounds
// would write them (the packed layout packs that fill to 0).

#include "common.cuh"

namespace {

constexpr int32_t BIG = 0x7FFFFFFF;

enum Layout { COMPACT, PACKED, UNPACKED };

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

// Output of one read.  COMPACT: o0 labels (B, cap), o1 counts (B, cap),
// o2 nuniq (B,), o3 found (B,).  PACKED: o0 (B, cap+1).  UNPACKED: o0
// (B, 2*cap+2).  Every value is written as its int32 bits.
struct Out {
  int32_t *o0, *o1, *o2, *o3;
};

template <Layout L>
__device__ __forceinline__ void put_slot(const Out& o, int64_t read, int32_t cap,
                                         int32_t r, int32_t label, int32_t count) {
  if constexpr (L == COMPACT) {
    o.o0[read * cap + r] = label;
    o.o1[read * cap + r] = count;
  } else if constexpr (L == PACKED) {
    uint32_t v = static_cast<uint32_t>(label + 1) | (static_cast<uint32_t>(count) << 16);
    o.o0[read * (cap + 1) + r] = static_cast<int32_t>(v);
  } else {
    o.o0[read * (2 * cap + 2) + r] = label;
    o.o0[read * (2 * cap + 2) + cap + r] = count;
  }
}

template <Layout L>
__device__ __forceinline__ void put_tail(const Out& o, int64_t read, int32_t cap,
                                         int32_t nuniq, int32_t found) {
  if constexpr (L == COMPACT) {
    o.o2[read] = nuniq;
    o.o3[read] = found;
  } else if constexpr (L == PACKED) {
    uint32_t v = static_cast<uint32_t>(nuniq) | (static_cast<uint32_t>(found) << 5);
    o.o0[read * (cap + 1) + cap] = static_cast<int32_t>(v);
  } else {
    o.o0[read * (2 * cap + 2) + 2 * cap] = nuniq;
    o.o0[read * (2 * cap + 2) + 2 * cap + 1] = found;
  }
}

// K > 0: ids held in K registers per lane.  K == 0: streamed from memory.
template <int K, Layout L>
__global__ void histogram_kernel(const int32_t* __restrict__ ids, int64_t B,
                                 int32_t n, int32_t num_labels, int32_t cap,
                                 Out out) {
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
    if (lane == 0) put_slot<L>(out, read, cap, r, m, c);
    cur = m;
    ++used;
  }
  if (lane == 0) {
    for (int r = used; r < cap; ++r) put_slot<L>(out, read, cap, r, -1, 0);
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
  if (lane == 0) put_tail<L>(out, read, cap, over ? cap + 1 : used, hits);
}

template <int K, Layout L>
void launch_k(const int32_t* ids, int64_t B, int32_t n, int32_t num_labels,
              int32_t cap, Out out, cudaStream_t stream) {
  const int threads = 256;  // 8 reads per block
  histogram_kernel<K, L><<<utree_blocks(B * 32, threads), threads, 0, stream>>>(
      ids, B, n, num_labels, cap, out);
}

template <Layout L>
int launch(const void* ids_v, int64_t B, int32_t n, int32_t num_labels,
           int32_t cap, Out out, void* stream_v) {
  auto ids = static_cast<const int32_t*>(ids_v);
  auto stream = static_cast<cudaStream_t>(stream_v);
  if (B > 0) {
    if (n <= 32 * 2)
      launch_k<2, L>(ids, B, n, num_labels, cap, out, stream);
    else if (n <= 32 * 4)
      launch_k<4, L>(ids, B, n, num_labels, cap, out, stream);
    else if (n <= 32 * 8)
      launch_k<8, L>(ids, B, n, num_labels, cap, out, stream);
    else if (n <= 32 * 16)
      launch_k<16, L>(ids, B, n, num_labels, cap, out, stream);
    else if (n <= 32 * 64)
      launch_k<64, L>(ids, B, n, num_labels, cap, out, stream);
    else
      launch_k<0, L>(ids, B, n, num_labels, cap, out, stream);
  }
  UTREE_LAUNCH_RESULT();
}

}  // namespace

extern "C" int utree_histogram(const void* ids, int64_t B, int32_t n,
                               int32_t num_labels, int32_t cap, void* labels,
                               void* counts, void* nuniq, void* found,
                               void* stream) {
  Out out{static_cast<int32_t*>(labels), static_cast<int32_t*>(counts),
          static_cast<int32_t*>(nuniq), static_cast<int32_t*>(found)};
  return launch<COMPACT>(ids, B, n, num_labels, cap, out, stream);
}

extern "C" int utree_histogram_packed(const void* ids, int64_t B, int32_t n,
                                      int32_t num_labels, int32_t cap, void* rows,
                                      void* stream) {
  Out out{static_cast<int32_t*>(rows), nullptr, nullptr, nullptr};
  return launch<PACKED>(ids, B, n, num_labels, cap, out, stream);
}

extern "C" int utree_histogram_unpacked(const void* ids, int64_t B, int32_t n,
                                        int32_t num_labels, int32_t cap, void* rows,
                                        void* stream) {
  Out out{static_cast<int32_t*>(rows), nullptr, nullptr, nullptr};
  return launch<UNPACKED>(ids, B, n, num_labels, cap, out, stream);
}
