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
// Design: one launch.  The order of the block rows must be read order,
// which a slot taken with atomicAdd would not give, so each row's place is
// an exclusive prefix sum of the flags: one pass with a decoupled look-back
// (Merrill and Garland) over tiles of 1024 reads, as K11 routes its lanes.
// A block of 256 threads takes its tile from an atomic ticket, so every
// tile before it has started; a thread takes four reads, 256 apart.  It
// reads each read's tail and first slot (both in the row's sector, which
// the first load brings into L1), writes the pair as one 8 B store and
// counts the flagged reads from warp ballots.  Warp 0 scans the 32
// (read slab, warp) counts, publishes the tile's count, looks back over
// the 32 tiles before it at a time until one holds an inclusive prefix,
// and publishes its own.  The tile then writes its flagged rows below
// over_cap, which are consecutive rows of the block, as one run of
// coalesced stores.  ZERO more blocks take the tickets after the last
// tile's: each sums every tile's count (published before any look-back)
// to n_over and zeroes its share of the rows no read fills (block 0 also
// writes row 0), so no word is written twice.  The flags, the counts and
// the ticket are scratch the wrapper keeps across calls: a flag or count
// word is (epoch << 32 | status << 30 | value), valid only under this
// call's epoch, so no memset clears them, and the block that takes the
// last ticket sets the ticket back to 0.

#include "common.cuh"

namespace {

constexpr int TPB = 256;                // threads a block
constexpr int ITEMS = 4;                // reads a thread: tile*TILE + j*TPB + thread
constexpr int TILE = TPB * ITEMS;       // reads a tile
constexpr int NWARPS = TPB / 32;
constexpr int ZERO_WORDS = 4096;        // words of the block a zeroing block clears
constexpr int MAX_ZERO = 64;            // zeroing blocks at most
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint32_t VALUE = (1u << 30) - 1;  // a flag's count; B < 2^30
constexpr uint32_t AGGREGATE = 1u << 30, PREFIX = 2u << 30;

static_assert(ITEMS * NWARPS == 32, "one warp scans the tile's 32 (slab, warp) counts");

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

__device__ __forceinline__ unsigned long long ld_flag(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_flag(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ int32_t warp_sum(int32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// This call's word of a tile, once written: spin until its epoch is ours.
__device__ __forceinline__ uint32_t wait_flag(const unsigned long long* p, uint32_t epoch) {
  unsigned long long f;
  do {
    f = ld_flag(p);
  } while (static_cast<uint32_t>(f >> 32) != epoch);
  return static_cast<uint32_t>(f);
}

// Zero words [lo, hi) of p with the block's threads, 16 B stores where
// aligned.
__device__ __forceinline__ void zero_words(int32_t* p, int64_t lo, int64_t hi) {
  int64_t head = lo;
  while (head < hi && (reinterpret_cast<uintptr_t>(p + head) & 15)) ++head;
  for (int64_t w = lo + threadIdx.x; w < head; w += TPB) p[w] = 0;
  const int64_t nv = (hi - head) >> 2;
  int4* v = reinterpret_cast<int4*>(p + head);
  for (int64_t i = threadIdx.x; i < nv; i += TPB) v[i] = make_int4(0, 0, 0, 0);
  for (int64_t w = head + 4 * nv + threadIdx.x; w < hi; w += TPB) p[w] = 0;
}

// flags: the look-back's word a tile; counts: each tile's count alone.
__global__ void __launch_bounds__(TPB)
compact(const int32_t* __restrict__ rows, int64_t B, int32_t c1, int32_t over_cap,
        int64_t tiles, int32_t nzero, uint32_t epoch, unsigned long long* __restrict__ flags,
        unsigned long long* __restrict__ counts, unsigned* __restrict__ ticket,
        int32_t* __restrict__ out) {
  __shared__ int32_t wcount[32], queue[TILE], red[NWARPS];
  __shared__ int64_t tile_s;
  __shared__ int32_t before_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned long long tag = static_cast<unsigned long long>(epoch) << 32;
  int32_t* block = out + 2 * B;
  if (threadIdx.x == 0) {
    const unsigned t = atomicAdd(ticket, 1u);
    if (t == tiles + nzero - 1) atomicExch(ticket, 0u);  // the last: ready for the next call
    tile_s = t;
  }
  __syncthreads();
  const int64_t tile = tile_s;

  if (tile >= tiles) {  // a zeroing block: every tile has started
    int32_t n = 0;
    for (int64_t k = threadIdx.x; k < tiles; k += TPB)
      n += static_cast<int32_t>(wait_flag(counts + k, epoch) & VALUE);
    n = warp_sum(n);
    if (lane == 0) red[warp] = n;
    __syncthreads();
    int32_t n_over = 0;
    for (int w = 0; w < NWARPS; ++w) n_over += red[w];
    const int64_t lo = (static_cast<int64_t>(min(n_over, over_cap)) + 1) * c1,
                  hi = (static_cast<int64_t>(over_cap) + 1) * c1;
    const int64_t z = tile - tiles, share = (hi - lo + nzero - 1) / nzero;
    const int64_t a = lo + z * share;
    zero_words(block, min64(a, hi), min64(a + share, hi));
    if (z == 0 && static_cast<int>(threadIdx.x) < c1)
      block[threadIdx.x] = threadIdx.x == 0 ? n_over : 0;
    return;
  }

  const int64_t r0 = tile * TILE;
  const bool pair8 = (reinterpret_cast<uintptr_t>(out) & 7) == 0;
  unsigned ballot[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int64_t i = r0 + j * TPB + threadIdx.x;
    bool flag = false;
    if (i < B) {
      const int32_t* row = rows + i * c1;
      const int32_t tail = __ldg(row + c1 - 1);
      const int2 pair = make_int2(tail, __ldg(row));
      if (pair8) {
        reinterpret_cast<int2*>(out)[i] = pair;
      } else {
        out[2 * i] = pair.x;
        out[2 * i + 1] = pair.y;
      }
      flag = (tail & 31) >= 2;  // includes the cap+1 overflow sentinel
    }
    ballot[j] = __ballot_sync(FULL, flag);
    if (lane == 0) wcount[j * NWARPS + warp] = __popc(ballot[j]);
  }
  __syncthreads();

  if (warp == 0) {  // scan the 32 counts, then the look-back
    const int32_t c = wcount[lane];
    int32_t inc = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(FULL, inc, d);
      if (lane >= d) inc += y;
    }
    const int32_t agg = __shfl_sync(FULL, inc, 31);
    wcount[lane] = inc - c;
    unsigned long long* own = flags + tile;
    if (lane == 0) {
      st_flag(counts + tile, tag | AGGREGATE | static_cast<uint32_t>(agg));
      st_flag(own, tag | (tile == 0 ? PREFIX : AGGREGATE) | static_cast<uint32_t>(agg));
    }
    int32_t before = 0;
    for (int64_t pred = tile - 1 - lane; tile > 0; pred -= 32) {
      const uint32_t f = pred >= 0 ? wait_flag(flags + pred, epoch) : PREFIX;
      const unsigned pre = __ballot_sync(FULL, (f & ~VALUE) == PREFIX);
      const int32_t v = static_cast<int32_t>(f & VALUE);
      if (pre) {  // sum down to the nearest inclusive prefix
        before += warp_sum(lane <= __ffs(pre) - 1 ? v : 0);
        break;
      }
      before += warp_sum(v);
    }
    if (lane == 0) {
      if (tile > 0) st_flag(own, tag | PREFIX | static_cast<uint32_t>(before + agg));
      before_s = before;
      red[0] = agg;
    }
  }
  __syncthreads();
  // the tile's flagged reads in read order, then its rows below over_cap:
  // block rows before+1 .., one contiguous run of words
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    if ((ballot[j] >> lane) & 1u)
      queue[wcount[j * NWARPS + warp] + __popc(ballot[j] & ((1u << lane) - 1u))] =
          j * TPB + threadIdx.x;
  __syncthreads();
  const int32_t before = before_s;
  const int rows_out = max(0, min(red[0], over_cap - before));
  int32_t* dst = block + (static_cast<int64_t>(before) + 1) * c1;
  for (int w = threadIdx.x; w < rows_out * c1; w += TPB) {
    const int r = w / c1, c = w - r * c1;
    const int64_t i = r0 + queue[r];
    dst[w] = c == 0 ? static_cast<int32_t>(i) : __ldg(rows + i * c1 + c - 1);
  }
}

}  // namespace

// rows (B, cap+1) int32; scratch: the ticket, then a flag and a count a
// tile (2 * ceil(B / 1024) + 1 int64), zeroed when the wrapper made it and
// kept across calls on one stream; epoch: this call's, never 0 and never
// the last call's on this scratch; out (2B + (over_cap+1)*(cap+1),) int32.
extern "C" int utree_hist_compact(const void* rows, int64_t B, int32_t cap,
                                  int32_t over_cap, void* scratch, uint32_t epoch, void* out,
                                  void* stream) {
  if (B < 0 || B > VALUE || cap < 1 || over_cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int32_t c1 = cap + 1;
  const int64_t tiles = (B + TILE - 1) / TILE;
  const int64_t words = (static_cast<int64_t>(over_cap) + 1) * c1;
  const int32_t nzero =
      static_cast<int32_t>(min64(MAX_ZERO, (words + ZERO_WORDS - 1) / ZERO_WORDS));
  auto* s = static_cast<unsigned long long*>(scratch);
  compact<<<static_cast<unsigned>(tiles + nzero), TPB, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rows), B, c1, over_cap, tiles, nzero, epoch, s + 1,
      s + 1 + tiles, reinterpret_cast<unsigned*>(s), static_cast<int32_t*>(out));
  UTREE_LAUNCH_RESULT();
}
