// K11 route_displaced: one data shard's 2-bit packed reads -> the routed
// displaced probe's send buffer, one record a window lane, and the count of
// valid lanes for each owner shard.
//
// Replaces (utree_tpu/parallel/routed.py): the data side of
// _routed_probe_displaced :422-441 and the lane set-up of
// routed_displaced_search_step :492-500 (windows, canonical keys,
// displaced_bucket_jnp, owner and local bucket, each lane's rank among the
// valid lanes of its owner, the (S, C, 3) scatter with mode="drop", the
// overflow test), with kmer.cuh's canonical and fold_hash.
// The routed canonical steps call it with nseed = b1: the same fold, masked
// to a power of two, is the canonical t1 bucket (canonical_buckets,
// utree_tpu/lookup.py:262-279), so it also replaces the data side of
// _routed_probe_t1 :121-150 and the lane set-up of
// routed_canonical_search_step :185-198.
// Output, for P = B*W lanes p = b*W + w:
//   send   (S, C, 3) int32: (local bucket, key_lo, key_hi) of the lane of
//          rank r in block (owner, r); unwritten slots stay 0;
//   rec    (P, 4) int32: (slot = owner*C + rank, or -1 for a lane not
//          routed; key_lo; key_hi; valid | fwd_le<<1), (-1, 0, 0, 0) for
//          an invalid window;
//   counts (S+1,) int32: valid lanes per owner, then 1 if any exceeds C.
//
// Bound: bytes.  The packed reads are read once (about 0.8 MB for 16,384
// reads of 192 bases), the records (16 B a lane, 42 MB at 2.6M lanes) and
// the send buffer (12 B a slot) written once: about 0.025 ms at 3.35 TB/s.
// The arithmetic is K1's front half, some 60 integer operations a lane.
//
// Design: a lane's rank is its place among its owner's valid lanes in lane
// order, as the cumsum of routed.py:430-434 gives it, so that a batch that
// overflows drops the same lanes as JAX.  A slot taken with atomicAdd would
// not keep that order, so `route` is one pass of a prefix scan with a
// decoupled look-back (Merrill and Garland) over tiles of 1024 lanes, S <=
// 64 sums at once; a block of 256 threads takes four lanes a thread, so that
// more tiles are in flight to hide each one's chain of global round trips. A
// block takes its tile from an atomic ticket, so every tile before it has
// started; stages the tile's packed bytes and validity bits in shared memory
// as aligned words (at most 8 KB + 4 KB: a lane adds at most 8 and 4 bytes)
// and cuts each lane's 32 bases from them (kmer.cuh's staged windows, which
// K1 and K4 share); counts its lanes per owner from warp ballots; warp w
// takes owners w, w + 8, ... in turn: it publishes the owner's tile count as
// an aggregate, looks back over the flags of the 32 tiles before it at a
// time until one holds an inclusive prefix, and publishes its own (a tile's
// later owners wait on its earlier owners' look-backs, which wait only on
// earlier tiles, so none waits for ever).  The per-owner sums take 136 B of
// dynamic shared memory an owner.  Each lane then writes its record once,
// with its final slot, and the payload of rank < C to `send`.  A flag word
// is (status << 32 | value), status 0 until written, 1 an aggregate, 2 an
// inclusive prefix: one 64-bit store publishes both, so no fence orders
// them.  The last tile writes the counts; `zero_tail` then zeroes each
// owner's unwritten slots [count, C).

#include "kmer.cuh"

namespace {

constexpr int TILE = 1024;  // lanes a tile
constexpr int ITEMS = 4;    // lanes a thread: lane tile*TILE + j*TPB + thread
constexpr int TPB = TILE / ITEMS;
constexpr int NWARPS = TPB / 32;
constexpr int MAX_SHARDS = 64;
constexpr unsigned FULL = 0xFFFFFFFFu;
// Staged words of a tile (see the note above), with 3 words of slack for
// the alignment and the reads past the last byte.
constexpr int PK_WORDS = 2056;
constexpr int VB_WORDS = 1032;
constexpr unsigned long long AGGREGATE = 1ull << 32, PREFIX = 2ull << 32;

static_assert(ITEMS * NWARPS == 32, "one warp scans an owner's 32 (slab, warp) counts");

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

// One lane: its owner (-1 for an invalid window), local bucket and key.
struct Lane {
  int owner, fwd_le;
  uint32_t local;
  kmer::Key k;
};

__global__ void __launch_bounds__(TPB)
route(const uint8_t* __restrict__ packed, const uint8_t* __restrict__ vbits,
      const int32_t* __restrict__ lens, int64_t P, int64_t row4, int64_t row8,
      int32_t W, int64_t nseed, int32_t S, int32_t C, int64_t tiles,
      unsigned long long* __restrict__ flags, unsigned* __restrict__ ticket,
      int4* __restrict__ rec, int32_t* __restrict__ send, int32_t* __restrict__ counts) {
  __shared__ uint32_t spk[PK_WORDS], svb[VB_WORDS];
  // S x 32 (an owner's lanes in each (slab, warp) of the tile, then those
  // before it), then S (its lanes before the tile), then S (through it)
  extern __shared__ int32_t sums[];
  int32_t(*wbefore)[32] = reinterpret_cast<int32_t(*)[32]>(sums);
  int32_t* tbefore = sums + 32 * S;
  int32_t* ttotal = tbefore + S;
  // the tile, and the bytes its lanes need
  __shared__ int64_t tile_s;
  __shared__ kmer::Span span;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) {
    const int64_t tile = atomicAdd(ticket, 1u);
    const int64_t p0 = tile * TILE, p1 = (p0 + TILE < P ? p0 + TILE : P) - 1;
    tile_s = tile;
    span = kmer::span_of(p0, p1, W, row4, row8);
  }
  __syncthreads();
  const int64_t tile = tile_s, b0 = span.b0;
  const int64_t pbase = kmer::stage<TPB>(packed, span.pk0, span.pk1, spk);
  const int64_t vbase = kmer::stage<TPB>(vbits, span.vb0, span.vb1, svb);
  __syncthreads();

  Lane ln[ITEMS];
  unsigned mine[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    Lane& l = ln[j];
    l.owner = -1;
    l.fwd_le = 0;
    l.local = 0;
    l.k = kmer::Key{0, 0, 0, 0, 0};
    const int64_t p = tile * TILE + j * TPB + threadIdx.x;
    if (p < P) {
      const int32_t q = static_cast<int32_t>(p - b0 * W);  // < TILE + W
      const int32_t bl = q / W, w = q - bl * W;
      const int64_t b = b0 + bl;
      uint32_t hi32, lo32;
      if (kmer::staged_window(spk, svb, static_cast<int>(b * row4 + (w >> 2) - pbase),
                              static_cast<int>(b * row8 + (w >> 3) - vbase), w, lens[b],
                              hi32, lo32)) {
        l.fwd_le = kmer::canonical(hi32, lo32, l.k) ? 1 : 0;
        const uint32_t per_seed = static_cast<uint32_t>(nseed / S);
        const uint32_t g = kmer::fold_hash(l.k) & static_cast<uint32_t>(nseed - 1);
        l.owner = static_cast<int>(g / per_seed);
        l.local = g - l.owner * per_seed;
      }
    }
    mine[j] = 0;
    for (int o = 0; o < S; ++o) {
      const unsigned bal = __ballot_sync(FULL, l.owner == o);
      if (lane == 0) wbefore[o][j * NWARPS + warp] = __popc(bal);
      if (l.owner == o) mine[j] = bal;
    }
  }
  __syncthreads();

  for (int o = warp; o < S; o += NWARPS) {  // warp w: owners w, w + NWARPS, ...
    const int32_t c = wbefore[o][lane];
    int32_t inc = c;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(FULL, inc, d);
      if (lane >= d) inc += y;
    }
    const int32_t agg = __shfl_sync(FULL, inc, 31);
    wbefore[o][lane] = inc - c;
    unsigned long long* own = flags + tile * S + o;
    if (lane == 0)
      st_flag(own, (tile == 0 ? PREFIX : AGGREGATE) | static_cast<uint32_t>(agg));
    int32_t before = 0;
    for (int64_t pred = tile - 1 - lane; tile > 0; pred -= 32) {
      unsigned long long f = PREFIX;  // before tile 0: a prefix of 0
      if (pred >= 0) {
        do {
          f = ld_flag(flags + pred * S + o);
        } while ((f >> 32) == 0);
      }
      const unsigned pre = __ballot_sync(FULL, (f >> 32) == 2);
      const int32_t v = static_cast<int32_t>(static_cast<uint32_t>(f));
      if (pre) {  // sum down to the nearest inclusive prefix
        before += warp_sum(lane <= __ffs(pre) - 1 ? v : 0);
        break;
      }
      before += warp_sum(v);
    }
    if (lane == 0) {
      if (tile > 0) st_flag(own, PREFIX | static_cast<uint32_t>(before + agg));
      tbefore[o] = before;
      ttotal[o] = before + agg;
    }
  }
  __syncthreads();

  if (tile == tiles - 1 && threadIdx.x == 0) {
    int32_t over = 0;
    for (int o = 0; o < S; ++o) {
      counts[o] = ttotal[o];
      over |= ttotal[o] > C;
    }
    counts[S] = over;
  }
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const Lane& l = ln[j];
    const int64_t p = tile * TILE + j * TPB + threadIdx.x;
    if (p >= P) break;
    int32_t slot = -1;
    if (l.owner >= 0) {
      const int32_t rank = tbefore[l.owner] + wbefore[l.owner][j * NWARPS + warp] +
                           __popc(mine[j] & ((1u << lane) - 1u));
      if (rank < C) {
        slot = l.owner * C + rank;
        int32_t* d = send + static_cast<int64_t>(slot) * 3;
        d[0] = static_cast<int32_t>(l.local);
        d[1] = l.k.klo;
        d[2] = l.k.khi;
      }
    }
    rec[p] = make_int4(slot, l.k.klo, l.k.khi, l.owner >= 0 ? 1 | (l.fwd_le << 1) : 0);
  }
}

// Zero each owner's send slots from its count up to C: the slots no lane
// took.
__global__ void zero_tail(int32_t* __restrict__ send, const int32_t* __restrict__ counts,
                          int32_t S, int32_t C) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t start = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int o = 0; o < S; ++o) {
    int32_t* d = send + static_cast<int64_t>(o) * C * 3;
    const int64_t end = 3 * static_cast<int64_t>(C);
    for (int64_t i = 3 * static_cast<int64_t>(min(counts[o], C)) + start; i < end; i += stride)
      d[i] = 0;
  }
}

}  // namespace

// packed (B, row4) u8, vbits (B, row8) u8, lens (B,) i32; W windows a read;
// nseed the global seed count (S divides it); S shards (1..64); C slots an
// owner; scratch: ceil(B*W/1024)*S + 1 int64 (the flags, then the ticket),
// zeroed here; send (S, C, 3), rec (B*W, 4), counts (S+1,) int32.
extern "C" int utree_route_displaced(
    const void* packed, const void* vbits, const void* lens, int64_t B, int64_t row4,
    int64_t row8, int32_t W, int64_t nseed, int32_t S, int32_t C, void* scratch,
    void* send, void* rec, void* counts, void* stream) {
  if (S < 1 || S > MAX_SHARDS) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  const int64_t P = B * W;
  const int64_t tiles = (P + TILE - 1) / TILE;
  auto* sd = static_cast<int32_t*>(send);
  auto* cn = static_cast<int32_t*>(counts);
  cudaError_t err;
  if (tiles == 0) {  // no lane: every count 0, every slot unwritten
    err = cudaMemsetAsync(cn, 0, sizeof(int32_t) * (S + 1), st);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(sd, 0, sizeof(int32_t) * 3 * static_cast<size_t>(S) * C, st);
    return static_cast<int>(err);
  }
  auto* flags = static_cast<unsigned long long*>(scratch);
  err = cudaMemsetAsync(flags, 0, sizeof(unsigned long long) * (tiles * S + 1), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t sums = sizeof(int32_t) * 34 * static_cast<size_t>(S);
  route<<<static_cast<unsigned>(tiles), TPB, sums, st>>>(
      static_cast<const uint8_t*>(packed), static_cast<const uint8_t*>(vbits),
      static_cast<const int32_t*>(lens), P, row4, row8, W, nseed, S, C, tiles, flags,
      reinterpret_cast<unsigned*>(flags + tiles * S), static_cast<int4*>(rec), sd, cn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tail = 3 * static_cast<int64_t>(S) * C;
  const int64_t blocks = (tail + 255) / 256;
  zero_tail<<<static_cast<unsigned>(blocks < 2048 ? blocks : 2048), 256, 0, st>>>(sd, cn, S,
                                                                                C);
  UTREE_LAUNCH_RESULT();
}
