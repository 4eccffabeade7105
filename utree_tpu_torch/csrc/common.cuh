// Shared helpers of the utree_tpu_torch kernels.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// Launches return cudaGetLastError(): a refused launch never runs and a
// later synchronize would not report it, so the Python wrapper raises on it.
#define UTREE_LAUNCH_RESULT() return static_cast<int>(cudaGetLastError())

static inline unsigned utree_blocks(int64_t n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}
