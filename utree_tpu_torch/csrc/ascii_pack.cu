// K14 ascii_pack: ASCII reads -> the 2-bit packed reads and validity bits that
// K1, K4, K7, K10 and K15 read (the k=32 ASCII search step, search_step and
// the sharded steps of parallel/sharded.py).
//
// Replaces (utree_tpu/lookup.py): base_codes :31 (A/a=0 C/c=1 G/g=2 T/t=3,
// anything else or a position at or past the read's length invalid), and, in
// its rc mode, append_rc :66 (forward, one invalid sentinel at the length,
// then the reverse complement: 2L+1 positions, with JAX's clip-then-gather:
// the forward index is clipped to [0, L-1], the RC index 2*len - t too).
// The output is pack_reads_host's layout (:54): 4 codes a byte MSB-first,
// an invalid code packed as 0, and np.packbits validity bits, over the
// positions rounded up to a multiple of 8 (the pad is invalid).  Unlike
// pack_reads_host, a position at or past the length is invalid here; the
// probes mask by length as well, so their windows are the same.
//
// Bound: bytes.  The (B, L) reads are read once and 3/8 of a byte written
// per position: 9.8 MB in and 3.7 MB out at B = 65,536 reads of 150 bp.
//
// Design: one thread per 8 positions of a read, which writes one validity
// byte and two packed bytes; no shared memory.  Neighbouring threads read
// neighbouring 8-byte runs of the same read (forward mode).

#include "common.cuh"

namespace {

constexpr uint32_t INVALID = 4;

// base_codes of one position q in [0, L): the code, or INVALID.
__device__ __forceinline__ uint32_t code_at(const uint8_t* read, int32_t len, int64_t q) {
  if (q >= len) return INVALID;
  switch (read[q] | 0x20) {  // folds A/C/G/T to a/c/g/t; no other byte lands there
    case 'a': return 0;
    case 'c': return 1;
    case 'g': return 2;
    case 't': return 3;
    default: return INVALID;
  }
}

// The code at position t of the T positions (forward: T = L; rc: T = 2L+1).
__device__ __forceinline__ uint32_t position(const uint8_t* read, int64_t L, int32_t len,
                                             int64_t t, int32_t rc) {
  if (!rc) return t < L ? code_at(read, len, t) : INVALID;
  if (t >= 2 * L + 1) return INVALID;
  int64_t ln = len;
  if (t < ln) return code_at(read, len, t < L - 1 ? t : L - 1);
  if (t > ln && t <= 2 * ln) {
    int64_t q = 2 * ln - t;
    q = q < 0 ? 0 : (q > L - 1 ? L - 1 : q);
    uint32_t src = code_at(read, len, q);
    return src <= 3 ? 3 - src : INVALID;
  }
  return INVALID;
}

__global__ void ascii_pack_kernel(const uint8_t* __restrict__ reads,
                                  const int32_t* __restrict__ lens, int64_t B, int64_t L,
                                  int64_t row8, int32_t rc, uint8_t* __restrict__ packed,
                                  uint8_t* __restrict__ vbits) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= B * row8) return;
  int64_t b = i / row8;
  int64_t j = i - b * row8;
  const uint8_t* read = reads + b * L;
  int32_t len = lens[b];
  uint32_t v = 0, p0 = 0, p1 = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    uint32_t c = position(read, L, len, 8 * j + k, rc);
    bool ok = c <= 3;
    v |= static_cast<uint32_t>(ok) << (7 - k);
    uint32_t bits = (ok ? c : 0u) << (2 * (3 - (k & 3)));
    if (k < 4) p0 |= bits;
    else p1 |= bits;
  }
  vbits[b * row8 + j] = static_cast<uint8_t>(v);
  packed[b * 2 * row8 + 2 * j] = static_cast<uint8_t>(p0);
  packed[b * 2 * row8 + 2 * j + 1] = static_cast<uint8_t>(p1);
}

}  // namespace

// reads (B, L) u8, lens (B,) i32 -> packed (B, 2*row8) u8, vbits (B, row8) u8,
// row8 = ceil(T/8) with T = L (rc = 0) or 2L+1 (rc = 1).
extern "C" int utree_ascii_pack(const void* reads, const void* lens, int64_t B, int64_t L,
                                int64_t row8, int32_t rc, void* packed, void* vbits,
                                void* stream) {
  const int threads = 256;
  int64_t total = B * row8;
  if (total > 0) {
    ascii_pack_kernel<<<utree_blocks(total, threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(reads), static_cast<const int32_t*>(lens), B, L, row8,
        rc, static_cast<uint8_t*>(packed), static_cast<uint8_t*>(vbits));
  }
  UTREE_LAUNCH_RESULT();
}
