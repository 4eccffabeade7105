// K13 routed_finish / routed_finish_wide: one data shard's lane records and
// the values routed back to it -> per-window label ids, the input of K2
// histogram_packed.
//
// Replaces (utree_tpu/parallel/routed.py): the reply gather of
// _routed_probe_displaced :444-459, _displaced_t3_tail :462-474 and the
// decode of routed_displaced_search_step :507-518 (and of the fallback
// :558-574), with kmer.cuh's t3_tail and write_ids.
//
// K18 routed_canonical_finish / routed_canonical_finish_wide: the same over
// the canonical hash table, K13 with the ladder's c2 probe ahead of the t3
// tail.  Replaces the reply gather of _routed_probe_t1 :153-167,
// _tail_probe / _tail_probe_wide :95-118 and the decode of
// routed_canonical_search_step :196-212 (and of routed_fallback_step
// :254-268), with kmer.cuh's c2_tail (shared with K4), t3_tail and
// write_ids.
//
// Per lane p = b*W + w of the (P, 4) records K11 wrote: the value at
// reply[slot] (narrow: one int32 a slot; wide: a pair), or 0 for slot -1;
// then, for a valid window, on a miss the replicated tail (K18: the c2 row
// at the key's c2 bucket, then on a miss the c3 row; K13: the d3 row),
// each skipped when its table is the 8-row sentinel; then the decode into
// ids, rows of 2W with RC ([ix_a | ix_b]) or W.  The fallback passes the
// sum of the shards' values as `reply`, indexed by the records of a
// one-shard K11 pass.  An invalid window writes bad_ix without a probe;
// JAX probes it and discards the value, so the ids are the same.
//
// Bound: bytes.  Per lane a 16 B record and a 4 or 8 B reply read, one or
// two 4 B ids written, and a tail row on a miss from tails that stay in
// L2: at 2.6M lanes about 0.024 ms at 3.35 TB/s.
//
// Design: one thread per lane; the reply gather reads the slot the lane's
// own record names, so no lane depends on another.

#include "kmer.cuh"

namespace {

struct Tail {
  const int32_t* rows;
  int64_t nrows;  // a power of two; 8 rows is the "absent" sentinel
  int32_t slots;
};

// C2 = true: K18 (c2 then t3); false: K13 (t3 only).
template <int CPS, bool C2>
__global__ void routed_finish_kernel(const int4* __restrict__ rec,
                                     const int32_t* __restrict__ reply, int64_t B,
                                     int32_t W, Tail t2, Tail t3, int32_t do_rc,
                                     int32_t bad_ix, int32_t* __restrict__ out) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= B * W) return;
  const int4 r = rec[p];
  const bool valid = r.w & 1;
  const bool fwd_le = (r.w >> 1) & 1;
  kmer::Raw v{0, 0};
  if (r.x >= 0) {
    const int64_t s = r.x;
    v = CPS == 4 ? kmer::Raw{reply[2 * s], reply[2 * s + 1]} : kmer::Raw{reply[s], 0};
  }
  if (valid) {
    const kmer::Key k = kmer::key_of(r.y, r.z);
    if (C2) kmer::c2_tail<CPS>(v, k, t2.rows, t2.nrows, t2.slots);
    kmer::t3_tail<CPS>(v, k, t3.rows, t3.nrows, t3.slots);
  }
  const int64_t b = p / W;
  kmer::write_ids<CPS>(out, b, W, static_cast<int32_t>(p - b * W), valid, fwd_le, v,
                       do_rc, bad_ix);
}

template <int CPS, bool C2>
int launch(const void* rec, const void* reply, int64_t B, int32_t W, Tail t2, Tail t3,
           int32_t do_rc, int32_t bad_ix, void* out, void* stream) {
  const int threads = 256;
  const int64_t n = B * W;
  if (n > 0) {
    routed_finish_kernel<CPS, C2><<<utree_blocks(n, threads), threads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int4*>(rec), static_cast<const int32_t*>(reply), B, W, t2, t3,
        do_rc, bad_ix, static_cast<int32_t*>(out));
  }
  UTREE_LAUNCH_RESULT();
}

Tail tail(const void* rows, int64_t n, int32_t s) {
  return Tail{static_cast<const int32_t*>(rows), n, s};
}

}  // namespace

// rec (B*W, 4) int32 from K11; reply int32, one (narrow) or two (wide)
// values a slot; d3 (n3, CPS*s3); out (B, 2W) with RC, else (B, W).
extern "C" int utree_routed_finish(const void* rec, const void* reply, int64_t B,
                                   int32_t W, const void* d3, int64_t n3, int32_t s3,
                                   int32_t do_rc, int32_t bad_ix, void* out,
                                   void* stream) {
  return launch<3, false>(rec, reply, B, W, Tail{nullptr, 0, 0}, tail(d3, n3, s3), do_rc,
                          bad_ix, out, stream);
}

extern "C" int utree_routed_finish_wide(const void* rec, const void* reply, int64_t B,
                                        int32_t W, const void* d3, int64_t n3, int32_t s3,
                                        int32_t do_rc, int32_t bad_ix, void* out,
                                        void* stream) {
  return launch<4, false>(rec, reply, B, W, Tail{nullptr, 0, 0}, tail(d3, n3, s3), do_rc,
                          bad_ix, out, stream);
}

// As K13, with c2 (n2, CPS*s2) and c3 (n3, CPS*s3) the replicated tails.
extern "C" int utree_routed_canonical_finish(const void* rec, const void* reply, int64_t B,
                                             int32_t W, const void* c2, int64_t n2,
                                             int32_t s2, const void* c3, int64_t n3,
                                             int32_t s3, int32_t do_rc, int32_t bad_ix,
                                             void* out, void* stream) {
  return launch<3, true>(rec, reply, B, W, tail(c2, n2, s2), tail(c3, n3, s3), do_rc,
                         bad_ix, out, stream);
}

extern "C" int utree_routed_canonical_finish_wide(const void* rec, const void* reply,
                                                  int64_t B, int32_t W, const void* c2,
                                                  int64_t n2, int32_t s2, const void* c3,
                                                  int64_t n3, int32_t s3, int32_t do_rc,
                                                  int32_t bad_ix, void* out,
                                                  void* stream) {
  return launch<4, true>(rec, reply, B, W, tail(c2, n2, s2), tail(c3, n3, s3), do_rc,
                         bad_ix, out, stream);
}
