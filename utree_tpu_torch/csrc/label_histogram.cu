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
// Bound: bytes.  The ids are read once (about 8 MB for a 1 Mbp read with
// RC) and num_labels counts written once.
//
// Design: integer adds commute, so atomics give the exact counts in any
// order.  Up to kSharedLabels labels each block keeps its counts in shared
// memory (dynamic, up to 224 KiB of the 227 KiB a block may take), walks
// its grid-stride share of the ids with shared atomics, and adds its non-zero
// counts to the output; above that every id is a global atomic.  The output
// is zeroed on the stream first.

#include "common.cuh"

namespace {

constexpr int32_t kSharedLabels = 57344;

// The slot JAX's scatter adds to, or -1 where it adds nothing.
__device__ __forceinline__ int64_t slot_of(int32_t id, int32_t num_labels) {
  int64_t s = id < num_labels ? id : num_labels;
  if (s < 0) s += static_cast<int64_t>(num_labels) + 1;
  return s >= 0 && s < num_labels ? s : -1;
}

__global__ void label_histogram_shared(const int32_t* __restrict__ ids, int64_t n,
                                       int32_t num_labels, int32_t* __restrict__ hist) {
  extern __shared__ int32_t counts[];
  for (int32_t i = threadIdx.x; i < num_labels; i += blockDim.x) counts[i] = 0;
  __syncthreads();
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int64_t s = slot_of(ids[i], num_labels);
    if (s >= 0) atomicAdd(&counts[s], 1);
  }
  __syncthreads();
  for (int32_t i = threadIdx.x; i < num_labels; i += blockDim.x)
    if (counts[i]) atomicAdd(&hist[i], counts[i]);
}

__global__ void label_histogram_global(const int32_t* __restrict__ ids, int64_t n,
                                       int32_t num_labels, int32_t* __restrict__ hist) {
  int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int64_t s = slot_of(ids[i], num_labels);
    if (s >= 0) atomicAdd(&hist[s], 1);
  }
}

}  // namespace

// ids (n,) int32 -> hist (num_labels,) int32, num_labels >= 1.
extern "C" int utree_label_histogram(const void* ids, int64_t n, int32_t num_labels,
                                     void* hist, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(hist, 0, static_cast<size_t>(num_labels) * 4, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  // a few ids a thread, at most two blocks an SM of the H100's 132
  int64_t want = (n + threads * 16 - 1) / (threads * 16);
  unsigned blocks = static_cast<unsigned>(want < 1 ? 1 : (want > 264 ? 264 : want));
  const int32_t* in = static_cast<const int32_t*>(ids);
  int32_t* out = static_cast<int32_t*>(hist);
  if (n > 0 && num_labels <= kSharedLabels) {
    size_t bytes = static_cast<size_t>(num_labels) * 4;
    err = cudaFuncSetAttribute(label_histogram_shared,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    label_histogram_shared<<<blocks, threads, bytes, s>>>(in, n, num_labels, out);
  } else if (n > 0) {
    label_histogram_global<<<blocks, threads, 0, s>>>(in, n, num_labels, out);
  }
  UTREE_LAUNCH_RESULT();
}
