// K10 hash_probe: 2-bit packed reads -> per-window label ids through the
// legacy two-table hash (PACKSIZE=32, --lookup-mode hash).
//
// Replaces (utree_tpu/lookup.py): lookup_kmers_hash :205 with _mix_jnp :188
// (kmer::mix32), reached from _packed_window_ix's non-canonical branch
// :698-708, which appends the arithmetic RC words (rc_word_lanes :123) and
// probes each word on its own; windows come from kmer.cuh's window_at
// (base_codes_packed :39, extract_windows :83), the true_len trim included.
// The tables are utree_tpu/hash_index.py:476 build_hash_index's t1 and t2:
// rows of 8 slots of (key_lo, key_hi, ix) int32, 96 B a row.
//
// Bound: bytes.  Each valid word reads one random 96 B t1 row (three 32 B
// sectors; t1 is 805 MB at 20M k-mers, so every row is a trip to device
// memory), and each word that t1 does not hold one t2 row as well, which L2
// serves (786 KB at 20M); the integer work is two mixes and 16 slot
// compares a word.  With RC two thirds of the words miss t1 (a read's RC
// words are mostly absent from a DB of forward k-mers).  The t1 rows alone
// take as long as the kernel: on an H100 it reads random sectors at about
// 53G/s, faster than K1 and K7, and its time follows the sectors a word
// reads (PERF.md §6), so only a layout of fewer sectors a word moves it.
//
// Design: one thread per (read, window), doing the forward word and, with
// RC, its RC word, as K7 does, so every row gather of the batch is in
// flight at once.  A thread a word, both words' rows loaded before either
// compare, a word's t2 row loaded with its t1 row, K1's staged windows and
// a register cap were each no faster (PERF.md §6): they change the trips
// and the threads, not the sectors.  A row is read as six 16 B vector loads
// (a row starts at a multiple of 96 B, so each load is aligned).  The match
// rule is JAX's: a slot matches on both key words and ix >= 0, and a later
// matching slot wins, so all 8 slots are compared (a stored ix may be
// negative: under IXTYPE=u32 the bad_ix 2^32-1 is stored as -1, and such a
// slot never matches, nor ends the row).  t2 is read only where t1 matched
// nothing, which is where JAX's where(f1, ix1, ...) takes t2's answer.
// Invalid windows write bad_ix without a probe (JAX probes bucket 0 and
// masks it).

#include "kmer.cuh"

namespace {

constexpr int kSlots = 8;

struct HashTables {
  const int32_t* t1;  // (b1, 24) rows of 8 (key_lo, key_hi, ix) slots
  int64_t b1;         // power of two
  const int32_t* t2;  // (b2, 24)
  int64_t b2;         // power of two
};

// The slot compare over one row: the last slot whose keys equal (klo, khi)
// and whose ix is >= 0; returns whether one did.
__device__ __forceinline__ bool probe_row(const int32_t* row, int32_t klo,
                                          int32_t khi, int32_t& ix) {
  int32_t e[3 * kSlots];
  const int4* r4 = reinterpret_cast<const int4*>(row);
#pragma unroll
  for (int q = 0; q < 3 * kSlots / 4; ++q) {
    int4 v = __ldg(r4 + q);
    e[4 * q] = v.x;
    e[4 * q + 1] = v.y;
    e[4 * q + 2] = v.z;
    e[4 * q + 3] = v.w;
  }
  bool found = false;
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    if (e[3 * s] == klo && e[3 * s + 1] == khi && e[3 * s + 2] >= 0) {
      ix = e[3 * s + 2];
      found = true;
    }
  }
  return found;
}

// One word (hi32 = prefix24 << 8 | hi8, lo32): t1's answer, else t2's, else
// bad_ix.  The keys are the word's own int32 bits.
__device__ __forceinline__ int32_t lookup(const HashTables& t, bool valid,
                                          uint32_t hi32, uint32_t lo32,
                                          int32_t bad_ix) {
  if (!valid) return bad_ix;
  uint32_t pre = hi32 >> 8, hi8 = hi32 & 0xFFu;
  int32_t klo = static_cast<int32_t>(lo32), khi = static_cast<int32_t>(hi32);
  int32_t ix;
  uint32_t r1 = kmer::mix32(pre, hi8, lo32) & static_cast<uint32_t>(t.b1 - 1);
  if (probe_row(t.t1 + static_cast<int64_t>(r1) * 3 * kSlots, klo, khi, ix)) return ix;
  uint32_t r2 = kmer::mix32(pre, hi8, lo32 ^ 0x5BD1E995u) & static_cast<uint32_t>(t.b2 - 1);
  if (probe_row(t.t2 + static_cast<int64_t>(r2) * 3 * kSlots, klo, khi, ix)) return ix;
  return bad_ix;
}

__global__ void hash_probe_kernel(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ vbits,
    const int32_t* __restrict__ lens, int64_t B, int64_t row4, int64_t row8,
    int32_t W, HashTables t, int32_t do_rc, int32_t bad_ix,
    int32_t* __restrict__ out) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= B * W) return;
  int64_t b = i / W;
  int32_t w = static_cast<int32_t>(i - b * W);
  uint32_t hi32, lo32;
  bool valid = kmer::window_at(packed + b * row4, vbits + b * row8, lens[b], w,
                               hi32, lo32);
  int32_t fwd = lookup(t, valid, hi32, lo32, bad_ix);
  if (!do_rc) {
    out[b * W + w] = fwd;
    return;
  }
  // rc_word_lanes: rc(hi32:lo32) = rev2(~lo32):rev2(~hi32)
  out[b * 2 * W + w] = fwd;
  out[b * 2 * W + W + w] = lookup(t, valid, kmer::rev2(~lo32), kmer::rev2(~hi32), bad_ix);
}

}  // namespace

extern "C" int utree_hash_probe(
    const void* packed, const void* vbits, const void* lens, int64_t B,
    int64_t row4, int64_t row8, int32_t W, const void* t1, int64_t b1,
    const void* t2, int64_t b2, int32_t do_rc, int32_t bad_ix, void* out,
    void* stream) {
  const int threads = 256;
  int64_t total = B * W;
  if (total > 0) {
    HashTables t{static_cast<const int32_t*>(t1), b1, static_cast<const int32_t*>(t2), b2};
    hash_probe_kernel<<<utree_blocks(total, threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed), static_cast<const uint8_t*>(vbits),
        static_cast<const int32_t*>(lens), B, row4, row8, W, t, do_rc, bad_ix,
        static_cast<int32_t*>(out));
  }
  UTREE_LAUNCH_RESULT();
}
