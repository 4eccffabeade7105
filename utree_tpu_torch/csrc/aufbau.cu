// K3 aufbau_vote: compact histograms -> the GG aufbau vote, packed 12 B/read.
//
// Replaces utree_tpu/classify_device.py:113 aufbau_walk_device (the walk of
// itree.c:1044-1096 over per-label integer tables) and its epilogue in
// utree_tpu/lookup.py:769 search_step_vote_compact (:798-808): the
// field-range flags and the w0/w1/w2 pack.
//
// Bound: bytes in principle (labels, nuniq and found read once, the counts
// rows of the reads of two or more labels only, the label tables at most
// once, 12 B a read written: about 4 MB on a batch of 65,536 reads at cap 8
// where 2% hit two or more labels), latency in practice: a tile waits for
// its staged rows, and a read that hits two or more labels then for a chain of
// dependent gathers into the label tables (ranks, the LCP sparse table,
// ';'/'_' bitmasks, sorted ';' positions, KB to MB, in L1/L2) before and
// during a walk of a dozen or more steps.  Most reads hit one label and
// finish without a step.
//
// Design: a block takes a tile of TPB reads.  It stages the tile's labels
// rows, which are contiguous, with coalesced 16 B loads into shared memory,
// entry c of read r at c * TPB + r.  A read of at most one label needs only
// labels[:, 0]: its thread packs it at once, unsorted, and its counts row
// is never read.  Every other read goes to the tile's queue, and the queue
// is walked with every lane busy: thread j takes queued read j, loads that
// read's counts row (one 32 B sector at cap 8) into shared memory beside
// its labels, and sorts the read's
// entries by string rank in place in shared memory (a stable insertion
// sort, the order of jnp.argsort(stable=True)), and a read that walks
// replaces each entry's rank by the LCP of its adjacent pair, the one value
// of a step that depends on the entries alone.  Nothing is indexed in local
// memory, so L1 keeps the label tables, which every step reads through the
// read-only path.  The walk runs until that read is done or max_iters is
// reached.  JAX runs the same body batch-wide under a while_loop, but a
// finished lane is frozen there (every update is masked by ~done), so a
// per-thread loop with the same iteration cap computes the same values.
// Counters are uint32 and wrap as the reference's do.  Every table gather
// reproduces JAX's index semantics (negative indices wrap once, then
// clamp), so a lane computes the same values JAX does even where it reads
// padding.  The 12 B rows gather in shared memory and leave as one
// coalesced run of 16 B stores a tile.

#include "common.cuh"

namespace {

constexpr int TPB = 128;  // reads a tile = threads a block
constexpr int MAXC = 30;  // the pipeline's hist_cap range is 1..30
constexpr int32_t BIG = 0x3FFFFFFF;  // AufbauTables.BIG
constexpr uint32_t M1 = 0xFFFFFFFFu;
constexpr uint32_t M2 = 0xFFFFFFFEu;
constexpr int32_t DV_INTERP = 0, DV_EMPTY = 1, DV_FULL = 2;

// JAX gather index: wrap a negative index once, then clamp to [0, n-1]
__device__ __forceinline__ int64_t jix(int64_t i, int64_t n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

}  // namespace

// The vote tables, as the C entry takes them from ctypes
// (kernels.build.VoteTablesArg) and the kernel as its argument.
struct UtreeVoteTables {
  const int32_t* rank;
  const int32_t* st;  // (nlev, L)
  int32_t nlev, L;
  const int32_t* slen;
  const uint32_t* semi;  // (L, wm)
  const uint32_t* und;
  int32_t wm;
  const int32_t* spos;  // (L, R)
  int32_t R;
};

namespace {

// A label's row index l = jix(lab, L) and its length, loaded once a step.
struct Lab {
  int64_t l;
  uint32_t len;
};

struct Tables : UtreeVoteTables {
  __device__ Lab lab(int32_t label) const {
    const int64_t l = jix(label, L);
    return {l, static_cast<uint32_t>(__ldg(slen + l))};
  }
  // the mask bit at p of a label that has a character at p
  __device__ bool bit_at(const uint32_t* mask, Lab a, uint32_t p) const {
    int32_t pi = static_cast<int32_t>(p);
    int32_t col = pi >> 5;  // arithmetic, as jnp int32
    col = col < 0 ? 0 : (col > wm - 1 ? wm - 1 : col);
    uint32_t w = __ldg(mask + a.l * wm + col);
    return p < a.len && ((w >> static_cast<uint32_t>(pi & 31)) & 1u);
  }
  __device__ uint32_t next_semi(int64_t l, uint32_t p) const {
    const int32_t* ps = spos + l * R;
    int32_t pi = static_cast<int32_t>(p);
    int32_t best = BIG;
    for (int r = 0; r < R; ++r) {
      int32_t v = __ldg(ps + r);
      best = min(best, v >= pi ? v : BIG);
    }
    return static_cast<uint32_t>(best);
  }
  // range-min over adjacent LCPs in (ra, rb]
  __device__ uint32_t lcp(int32_t ra, int32_t rb) const {
    int32_t n = rb - ra;
    int32_t m = 31 - __clz(max(n, 1));
    int32_t mi = m < 0 ? 0 : (m > nlev - 1 ? nlev - 1 : m);
    int32_t lo = __ldg(st + static_cast<int64_t>(mi) * L + jix(static_cast<int64_t>(ra) + 1, L));
    int32_t hi = __ldg(st + static_cast<int64_t>(mi) * L + jix(max(rb - (1 << m) + 1, 0), L));
    return static_cast<uint32_t>(min(lo, hi));
  }
};

__device__ __forceinline__ uint32_t cut(uint32_t x, uint32_t taxacut) {
  uint32_t c = x - x / taxacut;
  return c + ((x >> 1) >= c ? 1u : 0u);
}

// The 12 B row (lookup.py:798-808): w0 = (rep+1) | min(nuniq,31)<<17 |
// dvcode<<22 | flag<<24, w1 = found | dv<<20 (dv only for DV_INTERP),
// w2 = sl | ol<<16; fields too wide for their lanes flag the read for the
// exact host replay (lookup.py:801-803).
__device__ __forceinline__ void pack_row(int32_t* dst, int32_t rep, int32_t dvcode, uint32_t dv,
                                         uint32_t sl, uint32_t ol, int32_t flag, int32_t nuniq,
                                         int32_t found) {
  int32_t dv_i = static_cast<int32_t>(dv), sl_i = static_cast<int32_t>(sl),
          ol_i = static_cast<int32_t>(ol);
  bool unfit = found >= (1 << 20) || sl_i >= (1 << 16) || ol_i >= (1 << 16) ||
               (dvcode == DV_INTERP && dv_i >= (1 << 11));
  flag |= unfit ? 1 : 0;
  dst[0] = static_cast<int32_t>(static_cast<uint32_t>(rep + 1) |
                                (static_cast<uint32_t>(min(nuniq, 31)) << 17) |
                                (static_cast<uint32_t>(dvcode) << 22) |
                                (static_cast<uint32_t>(flag) << 24));
  dst[1] = static_cast<int32_t>(static_cast<uint32_t>(found) |
                                ((dvcode == DV_INTERP ? dv : 0u) << 20));
  dst[2] = static_cast<int32_t>(sl | (ol << 16));
}

// Copy the tile's nw words of (read, entry) rows into shared memory, entry
// c of read r at c * TPB + r; 16 B loads where src is 16 B aligned.
__device__ __forceinline__ void stage_rows(const int32_t* __restrict__ src, int nw, int C,
                                           int32_t* dst) {
  auto put = [&](int w, int32_t v) {
    const int r = w / C;
    dst[(w - r * C) * TPB + r] = v;
  };
  int w0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = nw >> 2;
    for (int v = threadIdx.x; v < nv; v += TPB) {
      const int4 x = __ldg(reinterpret_cast<const int4*>(src) + v);
      put(4 * v, x.x);
      put(4 * v + 1, x.y);
      put(4 * v + 2, x.z);
      put(4 * v + 3, x.w);
    }
    w0 = 4 * nv;
  }
  for (int w = w0 + threadIdx.x; w < nw; w += TPB) put(w, __ldg(src + w));
}

// One queued read of nuniq >= 2: sort, walk, pack.  lab, cnt, rk: the
// read's entries in shared memory, entry i at [i * TPB]; lab is staged,
// cnt is loaded here from the read's counts row src.
__device__ __forceinline__ void vote_one(int32_t* lab, int32_t* cnt, int32_t* rk,
                                         const int32_t* __restrict__ src, int C,
                                         int32_t nuniq, int32_t found, const Tables& tab,
                                         uint32_t taxacut, int32_t max_iters, int32_t* dst) {
  // sort the entries by string rank (tax_cnt qsort, itree.c:1041); stable,
  // as jnp.argsort is
  for (int i = 0; i < C; ++i) {
    const int32_t l = lab[i * TPB];
    cnt[i * TPB] = __ldg(src + i);
    rk[i * TPB] = l >= 0 ? __ldg(tab.rank + jix(l, tab.L)) : BIG;
  }
  for (int i = 1; i < C; ++i) {
    const int32_t l = lab[i * TPB], r = rk[i * TPB], c = cnt[i * TPB];
    int j = i;
    for (; j > 0 && rk[(j - 1) * TPB] > r; --j) {
      lab[j * TPB] = lab[(j - 1) * TPB];
      rk[j * TPB] = rk[(j - 1) * TPB];
      cnt[j * TPB] = cnt[(j - 1) * TPB];
    }
    lab[j * TPB] = l;
    rk[j * TPB] = r;
    cnt[j * TPB] = c;
  }
  auto ent = [&](int32_t i) { return (i < 0 ? 0 : (i > C - 1 ? C - 1 : i)) * TPB; };

  uint32_t found_u = static_cast<uint32_t>(found);
  int32_t uix = min(nuniq, C);
  bool walk = nuniq <= C && found >= 2;  // nuniq >= 2 on the queue
  bool over = nuniq > C;

  int32_t st = 0, ed = uix, z = 1;
  uint32_t dv = M1, td = M1, run = static_cast<uint32_t>(cnt[0]), orun = found_u;
  uint32_t cutoff = cut(found_u, taxacut);
  uint32_t sl = 0, ol = 0;
  bool done = !walk;
  if (walk) {
    // an inner step takes entries z-1 and z, 1 <= z < ed <= uix: the LCP
    // of each such pair replaces the rank of its second entry
    for (int32_t y = uix - 1; y >= 1; --y)
      rk[y * TPB] = static_cast<int32_t>(tab.lcp(rk[(y - 1) * TPB], rk[y * TPB]));
  }
  for (int32_t it = 0; !done && it < max_iters; ++it) {
    if (z < ed) {  // ---- inner step (itree.c:1048-1079) ----
      const Lab a = tab.lab(lab[(z - 1) * TPB]), b = tab.lab(lab[z * TPB]);
      uint32_t cnt1 = static_cast<uint32_t>(cnt[(z - 1) * TPB]),
               cnt2 = static_cast<uint32_t>(cnt[z * TPB]);
      uint32_t l12 = static_cast<uint32_t>(rk[z * TPB]);
      uint32_t probe = dv == M1 ? 0u : dv;
      bool case0 = probe >= a.len;  // s1 exhausted at this depth: drop it
      uint32_t stop = min(a.len, l12);
      uint32_t tdn = min(tab.next_semi(a.l, dv + 1u), stop);
      bool c_eq = tdn < l12;
      bool c1_0 = tdn >= a.len;
      bool c1_semi = tab.bit_at(tab.semi, a, tdn);
      bool c2_semi = tab.bit_at(tab.semi, b, tdn);
      bool c1_und = tdn >= 1 && tab.bit_at(tab.und, a, tdn - 1u);
      bool promo = (c1_0 && c2_semi) || ((c1_semi || c1_0) && c1_und);
      bool case1 = !case0 && c_eq;
      bool case2 = !case0 && !c_eq && promo;
      bool case3 = !case0 && !c_eq && !promo && run >= cutoff;
      bool case4 = !case0 && !c_eq && !promo && run < cutoff;
      bool drop = case0 || case2;
      uint32_t n_run = case1 ? run + cnt2 : (case0 || case2 || case4) ? cnt2 : run;
      if (drop) {
        orun = orun - cnt1;
        cutoff = cut(orun, taxacut);
      }
      run = n_run;
      if (case0 || case2 || case4) st = z;
      if (!case0) td = tdn;
      if (case3) ed = z;
      else ++z;
    }
    if (z >= ed) {  // ---- after the inner loop (itree.c:1080-1096) ----
      sl = run;
      ol = orun;
      bool exit1 = run < cutoff;
      bool single = !exit1 && st + 1 >= ed;
      if (single && static_cast<uint32_t>(cnt[ent(ed - 1)]) >= cutoff) dv = M2;
      if (!exit1 && !single) {  // descend: outer re-init
        orun = run;
        dv = td;
        cutoff = cut(run, taxacut);
        run = static_cast<uint32_t>(cnt[ent(st)]);
        z = st + 1;
      }
      done = exit1 || single;
    }
  }

  bool hit_cap = walk && !done;  // defensive: never expected, host replays
  int32_t dvcode = dv == M1 ? DV_EMPTY : (dv == M2 ? DV_FULL : DV_INTERP);
  pack_row(dst, lab[ent(ed - 1)], dvcode, dv, sl, ol, (over || hit_cap) ? 1 : 0, nuniq, found);
}

template <int KC>  // KC: the cap where it is known when compiled, else 0
__global__ void __launch_bounds__(TPB)
aufbau_vote_kernel(const int32_t* __restrict__ labels, const int32_t* __restrict__ counts,
                   const int32_t* __restrict__ nuniq_p, const int32_t* __restrict__ found_p,
                   int64_t B, int32_t C_arg, Tables tab, uint32_t taxacut, int32_t max_iters,
                   int32_t* __restrict__ out) {
  const int C = KC ? KC : C_arg;
  extern __shared__ int32_t sm[];
  int32_t* s_lab = sm;               // [C][TPB]
  int32_t* s_cnt = s_lab + C * TPB;  // [C][TPB]: queued reads' counts
  int32_t* s_rk = s_cnt + C * TPB;   // [C][TPB]: ranks, then adjacent LCPs
  int32_t* s_out = s_rk + C * TPB;   // [TPB][3]
  __shared__ int32_t s_queue[TPB];
  __shared__ int s_qn;

  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * TPB;
  const int n = static_cast<int>(B - r0 < TPB ? B - r0 : TPB);
  const int t = threadIdx.x;
  if (t == 0) s_qn = 0;
  stage_rows(labels + r0 * C, n * C, C, s_lab);
  int32_t nuniq = 0, found = 0;
  if (t < n) {
    nuniq = __ldg(nuniq_p + r0 + t);
    found = __ldg(found_p + r0 + t);
  }
  __syncthreads();
  if (t < n) {
    if (nuniq <= 1)  // short circuit: the single label, full string
      pack_row(s_out + 3 * t, s_lab[t], DV_FULL, M1, 0u, 0u, 0, nuniq, found);
    else
      s_queue[atomicAdd(&s_qn, 1)] = t;
  }
  __syncthreads();
  if (t < s_qn) {
    const int q = s_queue[t];
    vote_one(s_lab + q, s_cnt + q, s_rk + q, counts + (r0 + q) * C, C, __ldg(nuniq_p + r0 + q),
             __ldg(found_p + r0 + q), tab, taxacut, max_iters, s_out + 3 * q);
  }
  __syncthreads();
  // the tile's rows: 3n words from out + 3 r0, 16 B aligned where out is
  int32_t* dst = out + 3 * r0;
  const int nw = 3 * n;
  int w0 = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int nv = nw >> 2;
    for (int v = t; v < nv; v += TPB)
      reinterpret_cast<int4*>(dst)[v] =
          make_int4(s_out[4 * v], s_out[4 * v + 1], s_out[4 * v + 2], s_out[4 * v + 3]);
    w0 = 4 * nv;
  }
  for (int w = w0 + t; w < nw; w += TPB) dst[w] = s_out[w];
}

}  // namespace

// labels, counts (B, C) int32, nuniq, found (B,) int32; tab: the vote
// tables' pointers and shapes; out (B, 3) int32.
extern "C" int utree_aufbau_vote(const void* labels, const void* counts, const void* nuniq,
                                 const void* found, int64_t B, int32_t C,
                                 const UtreeVoteTables* tab, int32_t taxacut,
                                 int32_t max_iters, void* out, void* stream) {
  if (C < 1 || C > MAXC) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  Tables t;
  static_cast<UtreeVoteTables&>(t) = *tab;
  const size_t smem = sizeof(int32_t) * (3 * static_cast<size_t>(C) + 3) * TPB;
  auto st = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const int32_t*>(labels);
  auto* c = static_cast<const int32_t*>(counts);
  auto* nu = static_cast<const int32_t*>(nuniq);
  auto* fo = static_cast<const int32_t*>(found);
  auto* o = static_cast<int32_t*>(out);
  const unsigned blocks = utree_blocks(B, TPB);
  if (C == 8)  // the pipeline's default cap
    aufbau_vote_kernel<8><<<blocks, TPB, smem, st>>>(l, c, nu, fo, B, C, t, taxacut,
                                                     max_iters, o);
  else
    aufbau_vote_kernel<0><<<blocks, TPB, smem, st>>>(l, c, nu, fo, B, C, t, taxacut,
                                                     max_iters, o);
  UTREE_LAUNCH_RESULT();
}
