// K9 xtree_probe: ASCII queries -> per-window LBS_k pod index and prefix bin
// of both strands, over the xtree canonical displaced table (wide, 4-column
// slots: key_lo, key_hi, seed_fwd+1, seed_rc+1).
//
// Replaces (utree_tpu/xtree/device.py): xtree_device_step :178 with
// _extract_windows_k :120, _rc_lanes_k :145 and _prefix_of :167, and from
// utree_tpu/lookup.py base_codes :31 and displaced_probe_raw(wide=True) :887.
// Shares kmer64::base_code, kmer::Key, fold_hash, mix32, probe_row<4> and
// kmer::displaced_probe (the seed and slot hashing of K1) with K1 and K5.
//
// Layout: a k-mer (14 <= k <= 31) is 2k bits, MSB-first.  JAX holds it in
// two u32 lanes, hi = the first k-16 bases and lo = the last 16, and takes
// its RC as rev2(~lo):rev2(~hi) shifted right by s = 64-2k across the lanes,
// in three branches (s < 32, s == 32, s > 32) because a u32 shift by 32 is
// not defined.  Here the word is one uint64_t x whose (hi, lo) halves are
// exactly those lanes; its RC is rev2_64(~x) >> s, with s in [2, 62], which
// equals all three branches, and the prefix bin (x >> 2*sl) as u32 equals
// _prefix_of's (hi << (32-b)) | (lo >> b) and its b == 32 case.  The
// canonical compare (hi first, then lo, unsigned) is x <= rc.
//
// Bound: each window is one chain of dependent loads -- the u8 seed word,
// then one random 32 B d1 row (one sector; d1 is far larger than the 50 MB
// L2 at real database sizes), then on a miss the small cached d3 tail --
// plus the four int32 outputs, 16 B a window, which at 164 windows a
// 150 bp query outweigh the query bytes 13 to 1.  The arithmetic (two
// 32-bit mixes per hash) is negligible beside the random row read.
//
// Design: one thread per (query, window), as K1: all B*W row reads are in
// flight at once and occupancy hides their latency.  Each thread reads its
// k bytes straight from the ASCII row (neighbours share them through L1), so
// no lane arrays reach device memory; the four outputs are written
// coalesced, output m of (b, w) at m*B*W + b*W + w.  Invalid windows (an N,
// a byte past the length, the padding) skip the table: JAX probes bucket 0
// for them and discards the value with where(valid, ..., -1).  Their prefix
// bins are still computed from the masked codes, as JAX does.

#include "kmer64.cuh"

namespace {

// Reverse the 2-bit groups of a 64-bit word (base order reversal).
__device__ __forceinline__ uint64_t rev2_64(uint64_t x) {
  uint64_t r = __brevll(x);
  return ((r >> 1) & 0x5555555555555555ull) | ((r & 0x5555555555555555ull) << 1);
}

__global__ void xtree_probe_kernel(
    const uint8_t* __restrict__ reads, const int32_t* __restrict__ lens,
    int64_t B, int64_t T, int32_t W, int32_t k, int32_t sl,
    const int32_t* __restrict__ d1, int64_t nslots, const int32_t* __restrict__ ds,
    int64_t nseed, const int32_t* __restrict__ d3, int64_t n3, int32_t s3,
    int32_t* __restrict__ out) {
  int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t n = B * W;
  if (t >= n) return;
  int64_t b = t / W;
  int32_t w = static_cast<int32_t>(t - b * W);
  const uint8_t* row = reads + b * T;
  int32_t len = lens[b];
  uint64_t x = 0;
  bool valid = true;
  for (int j = 0; j < k; ++j) {
    int p = w + j;
    uint32_t code = kmer64::base_code(row[p]);
    bool ok = code < 4u && p < len;
    valid &= ok;
    x = (x << 2) | (ok ? code : 0u);
  }
  uint64_t rc = rev2_64(~x) >> (64 - 2 * k);
  int32_t seed_f = -1, seed_r = -1;
  if (valid) {
    bool fwd_le = x <= rc;
    uint64_t c = fwd_le ? x : rc;
    kmer::Key key;
    uint32_t chi = static_cast<uint32_t>(c >> 32), clo = static_cast<uint32_t>(c);
    key.pre = chi >> 8;
    key.hi8 = chi & 0xFFu;
    key.lo = clo;
    key.klo = static_cast<int32_t>(clo);
    key.khi = static_cast<int32_t>(chi);
    kmer::Raw r = kmer::displaced_probe<4>(key, d1, nslots, ds, nseed, d3, n3, s3);
    // r.a is the canonical word's pod + 1, r.b its RC's; 0 = that
    // orientation misses, so the seed is -1
    seed_f = fwd_le ? r.a - 1 : r.b - 1;
    seed_r = fwd_le ? r.b - 1 : r.a - 1;
  }
  out[t] = seed_f;
  out[n + t] = seed_r;
  out[2 * n + t] = static_cast<int32_t>(static_cast<uint32_t>(x >> (2 * sl)));
  out[3 * n + t] = static_cast<int32_t>(static_cast<uint32_t>(rc >> (2 * sl)));
}

}  // namespace

extern "C" int utree_xtree_probe(
    const void* reads, const void* lens, int64_t B, int64_t T, int32_t W, int32_t k,
    int32_t sl, const void* d1, int64_t nslots, const void* ds, int64_t nseed,
    const void* d3, int64_t n3, int32_t s3, void* out, void* stream) {
  const int threads = 256;
  int64_t n = B * W;
  if (n > 0) {
    xtree_probe_kernel<<<utree_blocks(n, threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(reads), static_cast<const int32_t*>(lens), B, T,
        W, k, sl, static_cast<const int32_t*>(d1), nslots,
        static_cast<const int32_t*>(ds), nseed, static_cast<const int32_t*>(d3), n3,
        s3, static_cast<int32_t*>(out));
  }
  UTREE_LAUNCH_RESULT();
}
