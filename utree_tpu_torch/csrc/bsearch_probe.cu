// K7 bsearch_probe: 2-bit packed reads -> per-window label ids by the literal
// xtSuffixBS replay over the sorted CTR records (PACKSIZE=32, --lookup-mode
// bsearch, and `auto` below 80M records when neither device table builds).
//
// Replaces (utree_tpu/lookup.py): lookup_kmers :149 with _suffix_le :140, and
// _packed_window_ix's non-canonical branch :698-708, which appends the
// arithmetic RC words (rc_word_lanes :123) and probes each word on its own;
// windows come from kmer.cuh's window_at (base_codes_packed :39,
// extract_windows :83), the true_len trim included.
//
// Bound: each word is a chain of dependent loads -- bin_ix[pre] and
// bin_ix[pre+1] (64 MB, one random sector), then one random (suf_hi, suf_lo)
// pair per halving of the bin, then ix[p].  At 20M records in 2^24 bins a bin
// holds about 1.2 records, so a word costs about three dependent HBM round
// trips; the replay is latency-bound, not bandwidth-bound.
//
// Design: one thread per (read, window), doing the forward word and, with
// RC, its RC word, so the B*W chains are all in flight and occupancy hides
// their latency.  The loop runs while the range is non-empty.  JAX runs a
// fixed `probe_iters` = ceil(log2(max bin + 1)) trips instead, but a lane
// whose size reached 0 is frozen there (no branch moves p or size), and
// `probe_iters` trips always empty the largest bin, so both end on the same
// p, on the quirky merged bins too.  The clamp `min(p + w + 1, n)` and the
// final `min(p, n)` keep every read inside the N+1 records; record n is the
// sentinel (suffix 0, id bad_ix), read exactly where JAX reads it.  Invalid
// windows search bin 0 as JAX does (pre = 0) and write bad_ix.

#include "kmer.cuh"

namespace {

struct Records {
  const int32_t* bin_ix;  // (2^24 + 1,) bin starts
  const int32_t* suf_hi;  // (n + 1,) suffix bits 39..32
  const uint32_t* suf_lo; // (n + 1,) suffix bits 31..0
  const int32_t* ix;      // (n + 1,) label ids
  int64_t n;              // records; index n is the sentinel
};

// One word's replay: the label id of the record the probe sequence ends on,
// or bad_ix.  The suffix compare is (hi, lo) with lo unsigned.
__device__ __forceinline__ int32_t replay(const Records& t, bool valid,
                                          uint32_t qpre, int32_t qhi,
                                          uint32_t qlo, int32_t bad_ix) {
  uint32_t pre = valid ? qpre : 0u;
  int64_t start = t.bin_ix[pre], end = t.bin_ix[pre + 1];
  bool empty = start >= end;
  int64_t p = empty ? 0 : start;
  int64_t size = empty ? 0 : end - start - 1;
  while (size > 0) {
    int64_t w = size >> 1;
    int64_t probe = p + w + 1 < t.n ? p + w + 1 : t.n;
    int32_t h = t.suf_hi[probe];
    bool le = h < qhi || (h == qhi && t.suf_lo[probe] <= qlo);
    if (le) {
      p += w + 1;
      size -= w + 1;
    } else {
      size = w;
    }
  }
  p = p < t.n ? p : t.n;
  bool found = !empty && valid && t.suf_hi[p] == qhi && t.suf_lo[p] == qlo;
  return found ? t.ix[p] : bad_ix;
}

__global__ void bsearch_probe_kernel(
    const uint8_t* __restrict__ packed, const uint8_t* __restrict__ vbits,
    const int32_t* __restrict__ lens, int64_t B, int64_t row4, int64_t row8,
    int32_t W, Records t, int32_t do_rc, int32_t bad_ix,
    int32_t* __restrict__ out) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= B * W) return;
  int64_t b = i / W;
  int32_t w = static_cast<int32_t>(i - b * W);
  uint32_t hi32, lo32;
  bool valid = kmer::window_at(packed + b * row4, vbits + b * row8, lens[b], w,
                               hi32, lo32);
  int32_t fwd = replay(t, valid, hi32 >> 8, static_cast<int32_t>(hi32 & 0xFFu),
                       lo32, bad_ix);
  if (!do_rc) {
    out[b * W + w] = fwd;
    return;
  }
  // rc_word_lanes: rc(hi32:lo32) = rev2(~lo32):rev2(~hi32)
  uint32_t rhi = kmer::rev2(~lo32), rlo = kmer::rev2(~hi32);
  out[b * 2 * W + w] = fwd;
  out[b * 2 * W + W + w] = replay(t, valid, rhi >> 8,
                                  static_cast<int32_t>(rhi & 0xFFu), rlo, bad_ix);
}

}  // namespace

extern "C" int utree_bsearch_probe(
    const void* packed, const void* vbits, const void* lens, int64_t B,
    int64_t row4, int64_t row8, int32_t W, const void* bin_ix,
    const void* suf_hi, const void* suf_lo, const void* ix, int64_t n,
    int32_t do_rc, int32_t bad_ix, void* out, void* stream) {
  const int threads = 256;
  int64_t total = B * W;
  if (total > 0) {
    Records t{static_cast<const int32_t*>(bin_ix), static_cast<const int32_t*>(suf_hi),
              static_cast<const uint32_t*>(suf_lo), static_cast<const int32_t*>(ix), n};
    bsearch_probe_kernel<<<utree_blocks(total, threads), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed), static_cast<const uint8_t*>(vbits),
        static_cast<const int32_t*>(lens), B, row4, row8, W, t, do_rc, bad_ix,
        static_cast<int32_t*>(out));
  }
  UTREE_LAUNCH_RESULT();
}
