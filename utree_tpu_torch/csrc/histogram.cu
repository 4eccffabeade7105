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
// ~1 KB a read) and writing the rows; a few integer operations an id.
//
// Design, rows of at most 32*64 ids (the 150 bp main path, every
// PACKSIZE=64 and wide-label read): one warp per read.  A warp a read
// spends its time on instructions, not waiting on the ~1 KB it reads, so
// the design cuts the instructions a read takes.  Each lane holds its
// strided share of the ids in K registers, K fitted to the row at launch
// (ceil(n/32), or at most a third more: 258 ids take 9, where a power of
// two took 16).  The same rounds as the JAX code, with no sort and no
// scatter, each one pass over the registers: the pass after label m
// counts the ids equal to m and finds the least hit id above m (an
// unsigned min of id - (m + 1), in which a negative id and every id up to
// m lie above BIG), and the warp reduces both in hardware (redux.sync: one
// instruction each, where a shuffle tree takes five dependent ones).  A
// read of u labels takes min(u, cap) + 1 passes; the last one's minimum is
// the overflow test.  Lane r keeps slot r's label and count, so the row
// goes out in one or two warp-wide stores, not a word at a time from one
// lane; slots past the distinct count keep their (-1, 0) fill, exactly as
// further JAX rounds would write them (the packed layout packs that fill
// to 0).
//
// Longer rows (long-read chunks, up to 2 x 16,385 ids; reads of 1-16 kbp):
// one block of 1024 threads per row, so a launch of 2-64 chunk rows keeps
// 2-64 SMs busy, where one warp a row left each row's whole length to one
// warp's latency.  A row of at most STAGE_IDS ids is staged in shared
// memory by NCHUNK bulk copies (cp.async.bulk, each completing on its own
// mbarrier: pass 1 starts on the first chunk while the rest arrive); a
// longer row is read from memory in each pass.  Pass 1 counts the hits and
// sets bit id of a label bitmap in shared memory for each hit id >= 0; the
// cap smallest set bits (a block scan of the words' popcounts) are the
// slots' labels and the popcount is the distinct count; pass 2 counts those
// labels, a label's slot read from its bitmap word's rank (set bits before
// it) and each thread adding a run of one slot to its warp's counter.  Two
// reads of the staged row in place of 2 * cap + 2 reads from memory.  A
// num_labels above the bitmap's limit (32 * BITMAP_WORDS) takes the JAX
// rounds as block-wide min and count reductions over the same staged row.

#include <utility>

#include "common.cuh"

namespace {

constexpr int32_t BIG = 0x7FFFFFFF;
constexpr uint32_t UBIG = 0x7FFFFFFFu;  // BIG, for the register branch's unsigned keys

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

// ---- the register branch: one warp a read ---------------------------------

constexpr int RTHREADS = 256;  // threads of a register-branch block: 8 reads

// Ids held in K registers a lane, rows of at most 32*K ids.
template <int K, Layout L>
__global__ void __launch_bounds__(RTHREADS)
histogram_kernel(const int32_t* __restrict__ ids, int64_t B, int32_t n,
                 int32_t num_labels, int32_t cap, Out out) {
  const int64_t read = (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (read >= B) return;  // whole warps exit together: B is per warp
  const int32_t* row = ids + read * n;

  // key = the id of a hit (id < num_labels, signed), BIG for a miss or
  // past the row's end; as unsigned, a negative hit id lies above BIG
  uint32_t key[K];
  int32_t hits = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int32_t i = lane + 32 * k;
    const int32_t v = i < n ? row[i] : BIG;
    const bool hit = v < num_labels;
    key[k] = static_cast<uint32_t>(hit ? v : BIG);
    hits += hit;
  }
  uint32_t lmin = UBIG;
#pragma unroll
  for (int k = 0; k < K; ++k) lmin = min(lmin, key[k]);
  uint32_t m = __reduce_min_sync(0xFFFFFFFFu, lmin);  // the least hit id >= 0, or BIG
  hits = __reduce_add_sync(0xFFFFFFFFu, hits);

  // Lane r keeps slot r: (-1, 0) unless a round fills it.  The pass after
  // label m counts m and finds the next label: the least id - (m + 1) as
  // unsigned, which puts every id up to m (and each negative id) above
  // BIG - (m + 1), where the start value stands for "none".
  int32_t label = -1, count = 0, used = 0;
  while (m != UBIG && used < cap) {
    if (lane == used) label = static_cast<int32_t>(m);
    const uint32_t base = m + 1;
    uint32_t next = UBIG - base;
    int32_t c = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      next = min(next, key[k] - base);
      c += key[k] == m;
    }
    c = __reduce_add_sync(0xFFFFFFFFu, c);
    if (lane == used) count = c;
    m = __reduce_min_sync(0xFFFFFFFFu, next) + base;
    ++used;
  }
  // a hit id above the cap-th label: overflow
  const int32_t nuniq = m != UBIG ? cap + 1 : used;

  if constexpr (L == COMPACT) {
    if (lane < cap) {
      out.o0[read * cap + lane] = label;
      out.o1[read * cap + lane] = count;
    }
    if (lane < 2) (lane ? out.o3 : out.o2)[read] = lane ? hits : nuniq;
  } else if constexpr (L == PACKED) {
    const uint32_t v = lane < cap
        ? static_cast<uint32_t>(label + 1) | (static_cast<uint32_t>(count) << 16)
        : static_cast<uint32_t>(nuniq) | (static_cast<uint32_t>(hits) << 5);
    if (lane <= cap) out.o0[read * (cap + 1) + lane] = static_cast<int32_t>(v);
  } else {
    // [labels | counts | nuniq | found]: position p < cap is lane p's
    // label, cap <= p < 2cap lane p - cap's count; 2cap + 2 > 32 positions
    // (cap > 15) take a second store
    const int32_t w = 2 * cap + 2;
    int32_t* o = out.o0 + read * w;
    const int32_t c0 = __shfl_sync(0xFFFFFFFFu, count, (lane - cap) & 31);
    if (lane < w)
      o[lane] = lane < cap ? label : lane < 2 * cap ? c0 : lane == 2 * cap ? nuniq : hits;
    if (w > 32) {
      const int32_t c1 = __shfl_sync(0xFFFFFFFFu, count, (lane + 32 - cap) & 31);
      const int32_t p = lane + 32;
      if (p < w) o[p] = p < 2 * cap ? c1 : p == 2 * cap ? nuniq : hits;
    }
  }
}

// ---- the streamed branch: one block a row ----------------------------------

constexpr int BLK = 1024;                 // threads of a streamed block
constexpr int NWARPS = BLK / 32;
constexpr int STAGE_IDS = 33792;          // the longest row staged (132 KB)
constexpr int NCHUNK = 2;                 // bulk copies (and mbarriers) a row
constexpr int CHUNK_IDS = STAGE_IDS / NCHUNK;  // 16,896 ids, a multiple of 4
constexpr int BITMAP_WORDS = 16384;       // the bitmap's limit: 524,288 labels
constexpr int MAX_CAP = 32;

static_assert(CHUNK_IDS % 4 == 0, "a bulk copy moves whole 16 B units");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// Block-wide reductions over BLK threads; `red` holds NWARPS words, and
// every thread gets the result.
__device__ __forceinline__ int32_t block_sum(int32_t v, int32_t* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = warp_sum(red[threadIdx.x & 31]);
  __syncthreads();
  return v;
}

__device__ __forceinline__ int32_t block_min(int32_t v, int32_t* red) {
  v = warp_min(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = warp_min(red[threadIdx.x & 31]);
  __syncthreads();
  return v;
}

// Exclusive scan over the block; `total` gets the sum.
__device__ __forceinline__ int32_t block_excl(int32_t v, int32_t* red, int32_t& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(0xFFFFFFFFu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) red[warp] = inc;
  __syncthreads();
  const int32_t ws = red[lane];
  int32_t wi = ws;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(0xFFFFFFFFu, wi, o);
    if (lane >= o) wi += y;
  }
  const int32_t before = __shfl_sync(0xFFFFFFFFu, wi - ws, warp);
  total = __shfl_sync(0xFFFFFFFFu, wi, 31);
  __syncthreads();
  return before + inc - v;
}

// Dynamic shared memory: the staged row (rows of at most STAGE_IDS ids,
// rounded up to 16 B with 3 words of slack for the alignment shift), the
// label bitmap (num_labels <= 32 * BITMAP_WORDS), then the bitmap words'
// ranks (`smem_words`).
__host__ __device__ __forceinline__ int32_t stage_words(int32_t n) {
  return n <= STAGE_IDS ? (n + 3 + 3) & ~3 : 0;
}

__host__ __device__ __forceinline__ int32_t bitmap_words(int32_t num_labels) {
  return num_labels <= 32 * BITMAP_WORDS ? (max(num_labels, 0) + 31) >> 5 : 0;
}

// Words of dynamic shared memory: the staged row, the bitmap, and a byte a
// bitmap word (its set bits before it) rounded up to words.
__host__ __device__ __forceinline__ int32_t smem_words(int32_t n, int32_t num_labels) {
  const int32_t bmw = bitmap_words(num_labels);
  return stage_words(n) + bmw + (bmw + 3) / 4;
}

template <Layout L>
__global__ void __launch_bounds__(BLK)
histogram_rows(const int32_t* __restrict__ ids, int32_t n, int32_t num_labels,
               int32_t cap, Out out) {
  extern __shared__ __align__(16) int32_t dyn[];
  __shared__ __align__(8) uint64_t bars[NCHUNK];
  __shared__ int32_t red[NWARPS];
  __shared__ int32_t sel[MAX_CAP];
  __shared__ int32_t cnt[NWARPS][MAX_CAP];  // per-warp counts of the slots

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t read = blockIdx.x;
  const int32_t* row = ids + read * n;
  const bool staged = n <= STAGE_IDS;
  const bool bitmap = num_labels <= 32 * BITMAP_WORDS;
  const int32_t bmw = bitmap_words(num_labels);
  uint32_t* bm = reinterpret_cast<uint32_t*>(dyn + stage_words(n));

  // Stage the row: `h` leading ids up to a 16 B boundary and `t` trailing
  // ids by plain loads, the m ids between by NCHUNK bulk copies, each
  // completing on its mbarrier.  s[h] is 16 B aligned.
  const int32_t h = staged ? static_cast<int32_t>(
      ((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) >> 2) : 0;
  const int32_t m = staged ? ((n - h) & ~3) : 0;
  const int32_t t = staged ? n - h - m : 0;
  int32_t* s = dyn + ((4 - h) & 3);
  if (staged && tid == 0) {
    for (int c = 0; c < NCHUNK; ++c)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(&bars[c])),
                   "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < NCHUNK; ++c) {
      const int32_t lo = c * CHUNK_IDS, len = min(CHUNK_IDS, m - lo);
      if (len <= 0) break;
      const uint32_t bar = smem_addr(&bars[c]), bytes = 4u * len;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                   "r"(bytes) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(s + h + lo)),
          "l"(row + h + lo), "r"(bytes), "r"(bar) : "memory");
    }
  }
  if (tid < h) s[tid] = row[tid];
  if (tid < t) s[h + m + tid] = row[h + m + tid];
  for (int32_t i = tid; i < bmw; i += BLK) bm[i] = 0;
  cnt[warp][lane] = 0;
  __syncthreads();  // the barriers' init, the plain loads, the zeroed bitmap

  // Pass 1: the hits (id < num_labels, signed: a negative id is a hit) and,
  // in the bitmap branch, bit id of the bitmap for each hit 0 <= id.  The
  // plain read first: a long read hits few labels, so nearly every bit is
  // already set and the atomics do not queue on one word.
  int32_t hits = 0;
  auto visit = [&](int32_t v) {
    if (v < num_labels) {
      ++hits;
      if (bitmap && v >= 0) {
        const uint32_t bit = 1u << (v & 31);
        if (!(bm[v >> 5] & bit)) atomicOr(&bm[v >> 5], bit);
      }
    }
  };
  const int32_t* src = staged ? s : row;
  if (staged) {
    if (tid < h) visit(s[tid]);
    if (tid < t) visit(s[h + m + tid]);
    for (int c = 0; c < NCHUNK; ++c) {
      const int32_t lo = c * CHUNK_IDS, len = min(CHUNK_IDS, m - lo);
      if (len <= 0) break;
      mbar_wait(smem_addr(&bars[c]), 0);
      const int4* q = reinterpret_cast<const int4*>(s + h + lo);
      for (int32_t i = tid; i < len / 4; i += BLK) {
        const int4 v = q[i];
        visit(v.x);
        visit(v.y);
        visit(v.z);
        visit(v.w);
      }
    }
  } else {
    for (int32_t i = tid; i < n; i += BLK) visit(row[i]);
  }
  hits = block_sum(hits, red);  // its barrier also completes the bitmap

  int32_t used, nuniq;
  if (bitmap) {
    // The cap smallest set bits: each thread's run of words, its popcount,
    // a block scan; the threads whose run starts below cap write theirs.
    const int32_t per = (bmw + BLK - 1) / BLK;
    const int32_t w0 = min(tid * per, bmw), w1 = min(w0 + per, bmw);
    int32_t c = 0;
    for (int32_t w = w0; w < w1; ++w) c += __popc(bm[w]);
    int32_t total;
    const int32_t before = block_excl(c, red, total);
    int32_t j = before;
    for (int32_t w = w0; w < w1 && j < cap; ++w) {
      for (uint32_t x = bm[w]; x && j < cap; x &= x - 1) sel[j++] = 32 * w + __ffs(x) - 1;
    }
    // Each word's count of set bits before it, clamped to a byte (a slot
    // is below cap <= 30): a selected label's slot is its word's count
    // plus the set bits below it in the word, with no search.
    uint8_t* rank8 = reinterpret_cast<uint8_t*>(bm + bmw);
    for (int32_t w = w0, r = before; w < w1; r += __popc(bm[w]), ++w)
      rank8[w] = static_cast<uint8_t>(min(r, 255));
    used = min(total, cap);
    nuniq = total > cap ? cap + 1 : total;
    __syncthreads();  // sel, rank8
    // Pass 2: count the selected labels (id <= the largest, its bit set),
    // four ids a load.  A thread adds a run of one slot to its warp's
    // counter when the slot changes: a long read's ids come in runs of a
    // label, so the adds are few.
    const int32_t last = used > 0 ? sel[used - 1] : -1;
    int32_t run_slot = 0, run_n = 0;
    auto count = [&](int32_t v) {
      if (v < 0 || v > last) return;
      const uint32_t word = bm[v >> 5], bit = 1u << (v & 31);
      if (!(word & bit)) return;
      const int32_t slot = rank8[v >> 5] + __popc(word & (bit - 1u));
      if (slot != run_slot) {
        if (run_n) atomicAdd(&cnt[warp][run_slot], run_n);
        run_slot = slot;
        run_n = 0;
      }
      ++run_n;
    };
    if (used > 0 && staged) {
      if (tid < h) count(s[tid]);
      if (tid < t) count(s[h + m + tid]);
      const int4* q = reinterpret_cast<const int4*>(s + h);
      for (int32_t i = tid; i < m / 4; i += BLK) {
        const int4 v = q[i];
        count(v.x);
        count(v.y);
        count(v.z);
        count(v.w);
      }
    } else if (used > 0) {
      for (int32_t i = tid; i < n; i += BLK) count(row[i]);
    }
    if (run_n) atomicAdd(&cnt[warp][run_slot], run_n);
    __syncthreads();  // cnt
    if (tid < cap) {
      int32_t total_c = 0;
      for (int w = 0; w < NWARPS; ++w) total_c += cnt[w][tid];
      put_slot<L>(out, read, cap, tid, tid < used ? sel[tid] : -1, tid < used ? total_c : 0);
    }
  } else {
    // More labels than the bitmap holds: the JAX rounds, a block min of the
    // hit ids above the last label, then a block count of that minimum.
    auto key_at = [&](int32_t i) -> int32_t {
      const int32_t v = src[i];
      return v < num_labels ? v : BIG;
    };
    int32_t cur = -1;
    used = 0;
    for (int r = 0; r < cap; ++r) {
      int32_t lmin = BIG;
      for (int32_t i = tid; i < n; i += BLK) {
        const int32_t v = key_at(i);
        if (v > cur && v < lmin) lmin = v;
      }
      const int32_t mn = block_min(lmin, red);
      if (mn == BIG) break;
      int32_t c = 0;
      for (int32_t i = tid; i < n; i += BLK) c += key_at(i) == mn;
      c = block_sum(c, red);
      if (tid == 0) put_slot<L>(out, read, cap, r, mn, c);
      cur = mn;
      ++used;
    }
    if (tid == 0) {
      for (int r = used; r < cap; ++r) put_slot<L>(out, read, cap, r, -1, 0);
    }
    int32_t over = 0;
    if (used == cap) {
      for (int32_t i = tid; i < n; i += BLK) {
        const int32_t v = key_at(i);
        over |= v > cur && v < BIG;
      }
      over = block_sum(over, red);
    }
    nuniq = over ? cap + 1 : used;
  }
  if (tid == 0) put_tail<L>(out, read, cap, nuniq, hits);
}

template <int K, Layout L>
void launch_k(const int32_t* ids, int64_t B, int32_t n, int32_t num_labels,
              int32_t cap, Out out, cudaStream_t stream) {
  histogram_kernel<K, L><<<utree_blocks(B * 32, RTHREADS), RTHREADS, 0, stream>>>(
      ids, B, n, num_labels, cap, out);
}

// The register-branch instances: a row of n ids takes the least K >= n/32,
// at most a third more registers than it fills.
template <Layout L, int... Ks>
void launch_regs(std::integer_sequence<int, Ks...>, const int32_t* ids, int64_t B,
                 int32_t n, int32_t num_labels, int32_t cap, Out out,
                 cudaStream_t stream) {
  (void)((32 * Ks >= n ? (launch_k<Ks, L>(ids, B, n, num_labels, cap, out, stream), true)
                       : false) || ...);
}

using RegInstances =
    std::integer_sequence<int, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 16, 20, 24, 32, 40, 48, 64>;
constexpr int MAX_REGS = 64;

template <Layout L>
int launch_rows(const int32_t* ids, int64_t B, int32_t n, int32_t num_labels,
                int32_t cap, Out out, cudaStream_t stream) {
  // Above 48 KB of dynamic shared memory the kernel needs the attribute,
  // set once a device (to the most it takes) and remembered in `ready`
  // (a race sets it twice, which is harmless).
  static unsigned long long ready = 0;
  const size_t smem = 4u * smem_words(n, num_labels);
  if (smem > 48 * 1024) {
    int dev = -1;
    const bool known = cudaGetDevice(&dev) == cudaSuccess && dev >= 0 && dev < 64;
    if (!known || !((ready >> dev) & 1)) {
      const cudaError_t err = cudaFuncSetAttribute(
          histogram_rows<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          4 * smem_words(STAGE_IDS, 32 * BITMAP_WORDS));
      if (err != cudaSuccess) return static_cast<int>(err);
      if (known) ready |= 1ull << dev;
    }
  }
  histogram_rows<L><<<static_cast<unsigned>(B), BLK, smem, stream>>>(ids, n, num_labels,
                                                                      cap, out);
  UTREE_LAUNCH_RESULT();
}

template <Layout L>
int launch(const void* ids_v, int64_t B, int32_t n, int32_t num_labels,
           int32_t cap, Out out, void* stream_v) {
  auto ids = static_cast<const int32_t*>(ids_v);
  auto stream = static_cast<cudaStream_t>(stream_v);
  if (B > 0) {
    if (n > 32 * MAX_REGS) return launch_rows<L>(ids, B, n, num_labels, cap, out, stream);
    launch_regs<L>(RegInstances{}, ids, B, n, num_labels, cap, out, stream);
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
