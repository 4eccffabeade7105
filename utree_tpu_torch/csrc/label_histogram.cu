// K16 label_histogram: per-window label ids -> one per-label hit count (the
// sequence-parallel long-read step of parallel/sharded.py).
//
// Replaces (utree_tpu/parallel/sharded.py): long_read_histogram's
// `hist.at[where(ix < num_labels, ix, num_labels)].add(1)[:num_labels]`
// (:215-218), before the psum over the mesh.  The compare is signed, and
// JAX's `.at[]` wraps a negative slot once by num_labels + 1 and drops what
// still lies outside: an id in [-(num_labels+1), -2] counts at id +
// num_labels + 1, the id -1 lands in the dropped slot num_labels, and ids
// below -(num_labels+1) or at or above num_labels count nowhere.
//
// Bound: bytes.  The ids are read once (about 1 MB for one device's chunk
// of a 1 Mbp read with RC) and num_labels counts written once: 0.3 us at
// 3.35 TB/s, below the time of one launch, which is the floor here.
//
// Design: one launch, no memset, and no pass through device memory but the
// ids in and the counts out.  Integer adds commute, so atomics give the
// exact counts in any order.  The kernel is a cooperative launch of at most
// one block an SM, the grid sized from n and num_labels: each block zeroes
// its share of the output, reads its grid-stride share of the ids as 16 B
// loads (issued before anything else waits), and counts them.  Up to
// kSharedLabels labels a block counts in shared memory, waits at a grid
// barrier (every share of the output zeroed) and adds its non-zero counters
// to the output; above that the loaded ids wait at the barrier and then add
// to the output directly.  The barrier's wait overlaps the counting, so the
// output's zeroing costs no round trip of its own.  Consecutive windows of
// a long read carry one label for thousands of windows, so a quad of equal
// ids adds 4 at once and a run of lanes with equal slots adds once, from
// the run's first lane: equal ids do not serialise on one counter.  The
// shared-memory limit is raised once a device.

#include <cooperative_groups.h>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int TPB = 256;
constexpr int UNROLL = 4;                 // 16 B loads a thread issues a pass
constexpr int32_t kSharedLabels = 57344;  // 224 KiB of counters at most
constexpr int64_t IDS_PER_BLOCK = 2048;   // at least, on the shared path
constexpr unsigned FULL = 0xFFFFFFFFu;

__host__ __device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int64_t lmax(int64_t a, int64_t b) { return a > b ? a : b; }

// The slot JAX's scatter adds to, or -1 where it adds nothing.
__device__ __forceinline__ int32_t slot_of(int32_t id, int32_t num_labels) {
  int64_t s = id < num_labels ? id : num_labels;
  if (s < 0) s += static_cast<int64_t>(num_labels) + 1;
  return s >= 0 && s < num_labels ? static_cast<int32_t>(s) : -1;
}

// Each lane of a warp adds `each` at slot s (-1: nothing); a run of lanes
// with equal slots adds once, from its first lane.
template <class Add>
__device__ __forceinline__ void warp_add(int32_t s, int32_t each, Add add) {
  const int lane = threadIdx.x & 31;
  const int32_t prev = __shfl_up_sync(FULL, s, 1);
  const bool head = lane == 0 || prev != s;
  const unsigned heads = __ballot_sync(FULL, head);
  const unsigned after = lane == 31 ? 0u : heads >> (lane + 1);
  if (head && s >= 0) add(s, each * (after ? __ffs(after) : 32 - lane));
}

// One quad of ids a lane: a quad of four equal ids adds 4 at once, the
// others one id at a time.
template <class Add>
__device__ __forceinline__ void quad_add(const int4 q, int32_t L, Add add) {
  const bool same = q.x == q.y && q.x == q.z && q.x == q.w;
  warp_add(same ? slot_of(q.x, L) : -1, 4, add);
  if (__ballot_sync(FULL, !same)) {
    warp_add(same ? -1 : slot_of(q.x, L), 1, add);
    warp_add(same ? -1 : slot_of(q.y, L), 1, add);
    warp_add(same ? -1 : slot_of(q.z, L), 1, add);
    warp_add(same ? -1 : slot_of(q.w, L), 1, add);
  }
}

// The ids as 16 B quads from the first aligned one; the <= 3 before it and
// the <= 3 after the last quad go one id a thread (`leftover`).
struct Quads {
  const int4* q;
  int64_t n, head;
  __device__ Quads(const int32_t* ids, int64_t count) {
    head = lmin(((16 - (reinterpret_cast<uintptr_t>(ids) & 15)) & 15) >> 2, count);
    n = (count - head) >> 2;
    q = reinterpret_cast<const int4*>(ids + head);
  }
  // the id index of leftover k (k < count - 4 * n)
  __device__ int64_t leftover(int64_t k) const { return k < head ? k : 4 * n + k; }
};

// Every thread of the grid walks its share of the quads, UNROLL a pass with
// the next pass's loads in flight; passes are the same for every thread of a
// block, so every lane of a warp takes part in each warp_add.  `ready` runs
// once the first pass's loads are issued.
template <class Ready, class Add>
__device__ __forceinline__ void count_quads(const Quads& in, int32_t L, Ready ready, Add add) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * TPB;
  const int64_t mine = static_cast<int64_t>(blockIdx.x) * TPB;
  const int64_t passes =
      in.n > mine ? (in.n - mine + UNROLL * stride - 1) / (UNROLL * stride) : 0;
  int4 cur[UNROLL], nxt[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int64_t i = mine + threadIdx.x + u * stride;
    cur[u] = i < in.n ? __ldg(in.q + i) : make_int4(L, L, L, L);  // L counts nowhere
  }
  ready();
  for (int64_t p = 0; p < passes; ++p) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t i = mine + threadIdx.x + ((p + 1) * UNROLL + u) * stride;
      nxt[u] = i < in.n ? __ldg(in.q + i) : make_int4(L, L, L, L);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) quad_add(cur[u], L, add);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) cur[u] = nxt[u];
  }
}

template <bool SHARED>
__global__ void __launch_bounds__(TPB)
label_histogram_kernel(const int32_t* __restrict__ ids, int64_t n, int32_t num_labels,
                       int32_t* __restrict__ hist) {
  extern __shared__ __align__(16) int32_t counts[];
  cg::grid_group grid = cg::this_grid();
  const int32_t L = num_labels;
  const Quads in(ids, n);
  {  // this block's share of the output, zeroed before the barrier
    const int64_t share = ((L + gridDim.x - 1) / gridDim.x + 3) & ~int64_t{3};
    const int64_t lo = lmin(blockIdx.x * share, L), hi = lmin(lo + share, L);
    for (int64_t w = lo / 4 + threadIdx.x; w < hi / 4; w += TPB)
      reinterpret_cast<int4*>(hist)[w] = make_int4(0, 0, 0, 0);
    for (int64_t w = hi / 4 * 4 + threadIdx.x; w < hi; w += TPB) hist[w] = 0;
  }
  auto leftover = [&](auto add) {
    if (blockIdx.x == 0 && threadIdx.x < n - 4 * in.n) {
      const int32_t s = slot_of(__ldg(ids + in.leftover(threadIdx.x)), L);
      if (s >= 0) add(s, 1);
    }
  };
  if (SHARED) {
    auto add = [&](int32_t s, int32_t c) { atomicAdd(counts + s, c); };
    count_quads(in, L, [&] {
      int4* c4 = reinterpret_cast<int4*>(counts);
      for (int32_t w = threadIdx.x; w < L / 4; w += TPB) c4[w] = make_int4(0, 0, 0, 0);
      for (int32_t w = L / 4 * 4 + threadIdx.x; w < L; w += TPB) counts[w] = 0;
      __syncthreads();
      leftover(add);
    }, add);
    grid.sync();  // every share of the output zeroed, every block counted
    const int4* c4 = reinterpret_cast<const int4*>(counts);
    for (int32_t w = threadIdx.x; w < L / 4; w += TPB) {
      const int4 c = c4[w];
      if (c.x) atomicAdd(hist + 4 * w, c.x);
      if (c.y) atomicAdd(hist + 4 * w + 1, c.y);
      if (c.z) atomicAdd(hist + 4 * w + 2, c.z);
      if (c.w) atomicAdd(hist + 4 * w + 3, c.w);
    }
    for (int32_t w = L / 4 * 4 + threadIdx.x; w < L; w += TPB)
      if (counts[w]) atomicAdd(hist + w, counts[w]);
  } else {
    auto add = [&](int32_t s, int32_t c) { atomicAdd(hist + s, c); };
    count_quads(in, L, [&] {
      grid.sync();  // every share of the output zeroed; the first loads in flight
      leftover(add);
    }, add);
  }
}

// The current device's multiprocessor count, after raising the shared
// path's shared-memory limit: once a device, not once a call.
cudaError_t sm_count(int& count) {
  static int sms[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!sms[dev]) {
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(label_histogram_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSharedLabels * 4);
    if (err != cudaSuccess) return err;
    sms[dev] = count;
  }
  count = sms[dev];
  return cudaSuccess;
}

}  // namespace

// ids (n,) int32 -> hist (num_labels,) int32, num_labels >= 1; hist starts
// on a 16 B boundary.
extern "C" int utree_label_histogram(const void* ids, int64_t n, int32_t num_labels,
                                     void* hist, void* stream) {
  if (n < 0 || num_labels < 1 || (reinterpret_cast<uintptr_t>(ids) & 3) ||
      (reinterpret_cast<uintptr_t>(hist) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t err = sm_count(sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t L = num_labels;
  const bool shared = n > 0 && L <= kSharedLabels;
  // at most one block an SM, so that every block is resident at the barrier
  const int64_t per = shared ? lmax(IDS_PER_BLOCK, L / 2) : 4096;
  const unsigned blocks = static_cast<unsigned>(lmax(1, lmin((n + per - 1) / per, sms)));
  const size_t bytes = shared ? static_cast<size_t>(L) * 4 : 0;
  const int32_t* in = static_cast<const int32_t*>(ids);
  int32_t* out = static_cast<int32_t*>(hist);
  void* args[] = {&in, &n, &num_labels, &out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = shared ? cudaLaunchCooperativeKernel(label_histogram_kernel<true>, blocks, TPB, args,
                                             bytes, s)
               : cudaLaunchCooperativeKernel(label_histogram_kernel<false>, blocks, TPB, args,
                                             bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  UTREE_LAUNCH_RESULT();
}
