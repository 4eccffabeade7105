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
// The work is a few integer operations a byte, so the instructions a byte
// and the width of each access decide how near the bound it comes.
//
// Design: a block takes a tile of output: whole rows where rows are short
// (`rows` mode: up to QMAX validity bytes, e.g. 107 reads = 16,050 input
// bytes at L = 150), else a span of one row's positions (`span` mode, sized
// on the host so that a long read's chunk spreads over every SM).  The
// tile's input bytes are contiguous in `reads` (in span mode with RC, the
// bytes its positions mirror); the block stages them in shared memory with
// a 16 B load for every aligned chunk inside the tensor, a byte at a time
// only at the tensor's own two edges (so an unaligned base such as
// reads[1:] is read right, and no load waits on another).  A thread then
// makes one validity byte and two packed bytes (8 positions) at a time, in
// 32-bit arithmetic, a row's index by a multiply with a reciprocal made on
// the host: in forward mode it takes 8 staged bytes with three aligned 4 B
// shared loads and two funnel shifts and classifies 4 bytes at once (SWAR:
// the code from bits 1 and 2 of each byte, a zero-byte test of the other
// bits against the letter's, the length as a byte mask); the codes and bits
// are packed by two multiplies.  In RC mode a word of 4 positions wholly
// forward or wholly mirrored is one 4-byte read (byte-reversed and flipped
// where mirrored), the rest go a position at a time.  The tile's outputs
// (contiguous in both arrays) are staged in shared memory at the output's
// own alignment and written with 16 B stores.  Tiles of 512 and 1024
// validity bytes, and blocks that took tile after tile with the next
// tile's bytes prefetched into registers, measured slower on an H100.

#include "common.cuh"

namespace {

constexpr int TPB = 256;                  // threads a block at most
constexpr int QMAX = 2048;                // validity bytes (8 positions each) a tile
constexpr int IN_CAP = 8 * QMAX;          // input bytes a tile stages
constexpr int IN_BUF = IN_CAP + 32;       // + the alignment head and the 3-word reads' tail

__host__ __device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int64_t lmax(int64_t a, int64_t b) { return a > b ? a : b; }

struct Args {
  const uint8_t* reads;
  const int32_t* lens;
  int64_t B, L, T, row8;
  uint8_t* packed;
  uint8_t* vbits;
  int32_t rows;          // rows mode: rows a tile
  uint32_t spans;        // span mode: tiles a row
  int32_t span_q;        // span mode: validity bytes a tile
  uint32_t magic;        // rows mode: ceil(2^20 / row8): i / row8 = i * magic >> 20
};

// 4 bytes (position p in byte 0) -> per byte the code (0-3, any value where
// invalid) and 0x01 where the byte is A/C/G/T in either case.
__device__ __forceinline__ void classify4(uint32_t w, uint32_t& code, uint32_t& ok01) {
  // A 0x41, C 0x43, G 0x47, T 0x54 (| 0x20 in lower case): code bit 0 = bit 1
  // ^ bit 2, code bit 1 = bit 2.  Past bits 1, 2 and 5 the byte must be
  // those of 'A' (0x41), or of 'T' (0x50) where bit 2 is set and bit 1 not.
  const uint32_t s1 = w >> 1, s2 = w >> 2;
  code = ((s1 ^ s2) & 0x01010101u) | (s1 & 0x02020202u);
  const uint32_t x = (w & 0xD9D9D9D9u) ^ (0x41414141u + (s2 & ~s1 & 0x01010101u) * 0x0Fu);
  const uint32_t y = (x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu;  // bit 7 set where x's low 7 bits are not 0
  ok01 = (~(y | x) & 0x80808080u) >> 7;
}

// Positions 0..3 of a word's codes (masked) -> one packed byte, in bits 24-31
// (the 2-bit fields land apart: byte i at bits 30 - 2i).
__device__ __forceinline__ uint32_t pack4(uint32_t code) { return code * 0x40100401u; }

// The 0x01 flags of a word -> 4 validity bits, MSB first, in bits 28-31.
__device__ __forceinline__ uint32_t bits4(uint32_t ok01) { return ok01 * 0x80402010u; }

// The low `n` (0..4) bytes of a word as a mask.
__device__ __forceinline__ uint32_t low_bytes(int32_t n) {
  return __funnelshift_lc(0xFFFFFFFFu, 0u, static_cast<uint32_t>(n) * 8u);
}

// 8 staged bytes at any offset: three aligned shared loads, two funnel shifts.
__device__ __forceinline__ void load8(const uint8_t* s, int o, uint32_t& w0, uint32_t& w1) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(s + (o & ~3));
  const uint32_t a = p[0], b = p[1], c = p[2], sh = (o & 3) * 8u;
  w0 = __funnelshift_r(a, b, sh);
  w1 = __funnelshift_r(b, c, sh);
}

// The 8 codes and flags of a byte pair -> (validity byte, packed bytes as
// p0 | p1 << 8).
__device__ __forceinline__ void emit(uint32_t c0, uint32_t k0, uint32_t c1, uint32_t k1,
                                     uint8_t& v, uint16_t& pk) {
  v = static_cast<uint8_t>(((bits4(k0) >> 24) & 0xF0u) | (bits4(k1) >> 28));
  pk = static_cast<uint16_t>(__byte_perm(pack4(c0 & (k0 * 3u)), pack4(c1 & (k1 * 3u)), 0x73));
}

// Copy reads[lo, hi) into s (s[head + g - lo] = reads[g], head = the
// address's offset in its 16 B chunk): a 16 B load for every chunk that lies
// in the tensor (size bytes from reads), also where it reaches past [lo, hi);
// only a chunk at the tensor's own edge goes a byte at a time, its loads
// issued together.
__device__ __forceinline__ int stage(const uint8_t* __restrict__ reads, int64_t size,
                                     int64_t lo, int64_t hi, uint8_t* s) {
  const uint8_t* base = reads + lo;
  const int head = static_cast<int>(reinterpret_cast<uintptr_t>(base) & 15);
  const int n = static_cast<int>(hi - lo);
  const int chunks = (head + n + 15) >> 4;
  const uint8_t* aligned = base - head;
  const int64_t first = -lo, last = size - lo;  // the tensor, relative to lo
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const int a = 16 * c - head;  // the chunk's first byte, relative to lo
    if (a >= first && a + 16 <= last) {
      reinterpret_cast<uint4*>(s)[c] = __ldg(reinterpret_cast<const uint4*>(aligned) + c);
    } else {
      uint8_t b[16];
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (a + k >= 0 && a + k < n) b[k] = __ldg(base + a + k);
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (a + k >= 0 && a + k < n) s[16 * c + k] = b[k];
    }
  }
  return head;
}

// Write s[h .. h + n) to out[0 .. n) (h = out's offset in its 16 B chunk),
// 16 B stores for whole chunks, bytes at the edges (a neighbouring tile
// writes the rest of an edge chunk).
__device__ __forceinline__ void unstage(const uint8_t* s, uint8_t* __restrict__ out, int n) {
  const int head = static_cast<int>(reinterpret_cast<uintptr_t>(out) & 15);
  const int chunks = (head + n + 15) >> 4;
  uint8_t* aligned = out - head;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const int a = 16 * c - head;
    if (a >= 0 && a + 16 <= n) {
      reinterpret_cast<uint4*>(aligned)[c] = reinterpret_cast<const uint4*>(s)[c];
    } else {
#pragma unroll
      for (int k = 0; k < 16; ++k)
        if (a + k >= 0 && a + k < n) aligned[16 * c + k] = s[16 * c + k];
    }
  }
}

// RC mode: the byte position t takes (0 where t is invalid: past T, the
// sentinel at len, or past 2*len) and whether its code flips (the mirrored
// half); get(q) reads the row's byte q.
template <class I, class Get>
__device__ __forceinline__ uint32_t rc_byte(Get get, I t, I len, I L, I T, uint32_t& flip) {
  flip = 0;
  if (t >= T) return 0;
  if (t < len) return get(t < L - 1 ? t : L - 1);
  if (t > len && t <= 2 * len) {
    I q = 2 * len - t;
    q = q < 0 ? 0 : (q > L - 1 ? L - 1 : q);
    flip = 3;
    return get(q);
  }
  return 0;
}

// RC mode, positions t .. t+3 (t % 4 == 0): their bytes as a word (0 where
// invalid) and flips (0x03 where mirrored).  A word wholly forward or wholly
// mirrored, with no clip, is one 4-byte read (get4(q): bytes q .. q+3, byte
// reversed where mirrored); a word wholly past the read is 0; the rest go a
// position at a time.
template <class I, class Get, class Get4>
__device__ __forceinline__ void rc_word(Get get, Get4 get4, I t, I len, I L, I T, uint32_t& w,
                                        uint32_t& flip) {
  if (t + 3 < len && t + 3 < L) {
    w = get4(t);
    flip = 0;
  } else if (t > len && t + 3 <= 2 * len && t + 3 < T && 2 * len - t <= L - 1) {
    w = __byte_perm(get4(2 * len - t - 3), 0u, 0x0123);
    flip = 0x03030303u;
  } else if (t >= T || (t > len && t > 2 * len)) {
    w = flip = 0;
  } else {
    w = flip = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t f;
      w |= rc_byte<I>(get, t + k, len, L, T, f) << (8 * k);
      flip |= f << (8 * k);
    }
  }
}

// RC mode, 8 positions from t0 -> (validity byte, packed bytes).
template <class I, class Get, class Get4>
__device__ __forceinline__ void rc8(Get get, Get4 get4, I t0, I len, I L, I T, uint8_t& v,
                                    uint16_t& pk) {
  uint32_t w0, f0, w1, f1, c0, k0, c1, k1;
  rc_word<I>(get, get4, t0, len, L, T, w0, f0);
  rc_word<I>(get, get4, t0 + 4, len, L, T, w1, f1);
  classify4(w0, c0, k0);
  classify4(w1, c1, k1);
  emit(c0 ^ f0, k0, c1 ^ f1, k1, v, pk);
}

// 4 staged bytes at any offset: two aligned shared loads, a funnel shift.
__device__ __forceinline__ uint32_t load4(const uint8_t* s, int o) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(s + (o & ~3));
  return __funnelshift_r(p[0], p[1], (o & 3) * 8u);
}

// Rows mode: a tile of a.rows whole rows (the last tile fewer).
template <bool RC>
__global__ void __launch_bounds__(TPB) rows_kernel(const Args a) {
  __shared__ __align__(16) uint8_t s_in[IN_BUF];
  __shared__ __align__(16) uint8_t s_v[QMAX + 16];
  __shared__ __align__(16) uint8_t s_p[2 * QMAX + 16];
  __shared__ int32_t s_len[QMAX];

  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * a.rows;
  const int nr = static_cast<int>(lmin(a.rows, a.B - r0));
  const int L = static_cast<int>(a.L), row8 = static_cast<int>(a.row8), nq = nr * row8;
  const int64_t q0 = r0 * row8;
  // the length clipped to [0, L] (forward) or [-1, T] (RC: the same
  // positions valid, and 2 * len fits an int)
  for (int i = threadIdx.x; i < nr; i += blockDim.x) {
    const int32_t ln = __ldg(a.lens + r0 + i);
    s_len[i] = RC ? min(max(ln, -1), static_cast<int>(a.T)) : min(max(ln, 0), L);
  }
  const int head = stage(a.reads, a.B * a.L, r0 * L, (r0 + nr) * L, s_in);
  uint8_t* const v_out = s_v + (reinterpret_cast<uintptr_t>(a.vbits + q0) & 15);
  uint8_t* const p_out = s_p + (reinterpret_cast<uintptr_t>(a.packed + 2 * q0) & 15);
  __syncthreads();

  for (int i = threadIdx.x; i < nq; i += blockDim.x) {
    const int r = static_cast<int>((static_cast<uint32_t>(i) * a.magic) >> 20);
    const int j = i - r * row8;
    const int o = head + r * L;  // the row's first staged byte
    uint8_t v;
    uint16_t pk;
    if (!RC) {  // positions 8j .. 8j+7, valid below min(len, L)
      const int n = min(max(s_len[r] - 8 * j, 0), 8);
      uint32_t w0, w1, c0, k0, c1, k1;
      load8(s_in, o + 8 * j, w0, w1);
      classify4(w0, c0, k0);
      classify4(w1, c1, k1);
      emit(c0, k0 & low_bytes(min(n, 4)), c1, k1 & low_bytes(max(n - 4, 0)), v, pk);
    } else {
      const uint8_t* row = s_in + o;
      rc8<int>([row](int q) { return static_cast<uint32_t>(row[q]); },
               [o](int q) { return load4(s_in, o + q); }, 8 * j, s_len[r], L,
               static_cast<int>(a.T), v, pk);
    }
    v_out[i] = v;
    *reinterpret_cast<uint16_t*>(p_out + 2 * i) = pk;
  }
  __syncthreads();
  unstage(s_v, a.vbits + q0, nq);
  unstage(s_p, a.packed + 2 * q0, 2 * nq);
}

// Span mode: a tile of a.span_q validity bytes of one row.
template <bool RC>
__global__ void __launch_bounds__(TPB) span_kernel(const Args a) {
  __shared__ __align__(16) uint8_t s_in[IN_BUF];
  __shared__ __align__(16) uint8_t s_v[QMAX + 16];
  __shared__ __align__(16) uint8_t s_p[2 * QMAX + 16];

  const int64_t r0 = blockIdx.x / a.spans;
  const int64_t j0 =
      static_cast<int64_t>(blockIdx.x - static_cast<uint32_t>(r0) * a.spans) * a.span_q;
  const int nq = static_cast<int>(lmin(a.span_q, a.row8 - j0));
  const int64_t q0 = r0 * a.row8 + j0, len = __ldg(a.lens + r0);
  const int64_t t0 = 8 * j0, t1 = lmin(8 * (j0 + nq), a.T);
  int64_t lo, hi;  // the row's bytes the tile's positions read
  if (!RC) {
    lo = lmin(t0, a.L);
    hi = lmin(t1, a.L);
  } else {  // forward, then mirrored
    const int64_t top = a.L - 1;
    lo = a.L;
    hi = 0;
    if (t0 < lmin(t1, len)) {
      lo = lmin(t0, top);
      hi = lmin(lmin(t1, len) - 1, top) + 1;
    }
    const int64_t ra = lmax(t0, len + 1), rb = lmin(t1, 2 * len + 1);
    if (ra < rb) {
      lo = lmin(lo, lmax(lmin(2 * len - (rb - 1), top), 0));
      hi = lmax(hi, lmax(lmin(2 * len - ra, top), 0) + 1);
    }
    lo = lmin(lo, hi);
    hi = lmin(hi, lo + IN_CAP);  // past the buffer a byte comes from the row itself
  }
  const int head = stage(a.reads, a.B * a.L, r0 * a.L + lo, r0 * a.L + hi, s_in);
  uint8_t* const v_out = s_v + (reinterpret_cast<uintptr_t>(a.vbits + q0) & 15);
  uint8_t* const p_out = s_p + (reinterpret_cast<uintptr_t>(a.packed + 2 * q0) & 15);
  __syncthreads();

  // forward: positions below lim (relative to the tile's first) are valid
  const int lim = static_cast<int>(lmin(lmax(lmin(lmax(len, 0), a.L) - t0, -8), 8 * QMAX + 8));
  for (int i = threadIdx.x; i < nq; i += blockDim.x) {
    uint8_t v;
    uint16_t pk;
    if (!RC) {
      const int n = min(max(lim - 8 * i, 0), 8);
      uint32_t w0, w1, c0, k0, c1, k1;
      load8(s_in, head + 8 * i, w0, w1);
      classify4(w0, c0, k0);
      classify4(w1, c1, k1);
      emit(c0, k0 & low_bytes(min(n, 4)), c1, k1 & low_bytes(max(n - 4, 0)), v, pk);
    } else {
      const uint8_t* row = a.reads + r0 * a.L;
      const uint8_t* st = s_in + head;
      const int64_t n = hi - lo;
      auto get = [=](int64_t q) {
        return static_cast<uint32_t>(q - lo >= 0 && q - lo < n ? st[q - lo] : __ldg(row + q));
      };
      auto get4 = [=](int64_t q) {
        return get(q) | get(q + 1) << 8 | get(q + 2) << 16 | get(q + 3) << 24;
      };
      rc8<int64_t>(get, get4, t0 + 8 * i, len, a.L, a.T, v, pk);
    }
    v_out[i] = v;
    *reinterpret_cast<uint16_t*>(p_out + 2 * i) = pk;
  }
  __syncthreads();
  unstage(s_v, a.vbits + q0, nq);
  unstage(s_p, a.packed + 2 * q0, 2 * nq);
}

}  // namespace

// reads (B, L) u8, lens (B,) i32 -> packed (B, 2*row8) u8, vbits (B, row8) u8,
// row8 = ceil(T/8) with T = L (rc = 0) or 2L+1 (rc = 1).  packed must start
// on an even address (the wrapper's own allocations do).
extern "C" int utree_ascii_pack(const void* reads, const void* lens, int64_t B, int64_t L,
                                int64_t row8, int32_t rc, void* packed, void* vbits,
                                void* stream) {
  const int64_t T = rc ? 2 * L + 1 : L;
  if (B < 0 || L < (rc ? 1 : 0) || row8 != (T + 7) / 8 ||
      (reinterpret_cast<uintptr_t>(packed) & 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || row8 == 0) UTREE_LAUNCH_RESULT();
  Args a{static_cast<const uint8_t*>(reads), static_cast<const int32_t*>(lens), B, L, T,
         row8, static_cast<uint8_t*>(packed), static_cast<uint8_t*>(vbits), 0, 0, 0, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (4 * row8 <= QMAX) {  // rows mode: at least 4 rows a tile
    a.rows = static_cast<int32_t>(QMAX / row8);
    a.magic = static_cast<uint32_t>(((1 << 20) + row8 - 1) / row8);  // i * row8 < 2^20
    const unsigned blocks = static_cast<unsigned>((B + a.rows - 1) / a.rows);
    if (rc) rows_kernel<true><<<blocks, TPB, 0, s>>>(a);
    else rows_kernel<false><<<blocks, TPB, 0, s>>>(a);
  } else {  // span mode: two tiles an SM of the H100's 132 where the batch allows
    int64_t q = (B * row8 + 263) / 264;
    q = lmin(lmax((q + 31) / 32 * 32, 64), QMAX);
    a.span_q = static_cast<int32_t>(q);
    a.spans = static_cast<uint32_t>((row8 + q - 1) / q);
    const int64_t blocks = B * a.spans;
    if (blocks >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
    const int threads = static_cast<int>(lmin(q, TPB));
    if (rc) span_kernel<true><<<static_cast<unsigned>(blocks), threads, 0, s>>>(a);
    else span_kernel<false><<<static_cast<unsigned>(blocks), threads, 0, s>>>(a);
  }
  UTREE_LAUNCH_RESULT();
}
