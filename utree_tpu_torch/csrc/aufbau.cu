// K3 aufbau_vote: compact histograms -> the GG aufbau vote, packed 12 B/read.
//
// Replaces utree_tpu/classify_device.py:113 aufbau_walk_device (the walk of
// itree.c:1044-1096 over per-label integer tables) and its epilogue in
// utree_tpu/lookup.py:769 search_step_vote_compact (:798-808): the
// field-range flags and the w0/w1/w2 pack.
//
// Bound: latency of the per-read walk.  A read that hits two or more labels
// walks a few dozen dependent steps, each a handful of small gathers into
// the label tables (ranks, the LCP sparse table, ';'/'_' bitmasks, sorted
// ';' positions), which are KB to MB in size and stay in L1/L2.  Most reads
// hit one label and finish without a step.
//
// Design: one thread per read.  The read's <= cap entries are sorted by
// string rank with a stable insertion sort in local memory, then the walk
// runs until that read is done or max_iters is reached.  JAX runs the same
// body batch-wide under a while_loop, but a finished lane is frozen there
// (every update is masked by ~done), so a per-thread loop with the same
// iteration cap computes the same values.  Counters are uint32 and wrap as
// the reference's do.  Every table gather reproduces JAX's index semantics
// (negative indices wrap once, then clamp), so a lane computes the same
// values JAX does even where it reads padding.

#include "common.cuh"

namespace {

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

struct Tables {
  const int32_t* rank;
  const int32_t* st;  // (nlev, L)
  int32_t nlev, L;
  const int32_t* slen;
  const uint32_t* semi;  // (L, wm)
  const uint32_t* und;
  int32_t wm;
  const int32_t* spos;  // (L, R)
  int32_t R;

  __device__ bool char0(int32_t lab, uint32_t p) const {
    return p >= static_cast<uint32_t>(slen[jix(lab, L)]);
  }
  __device__ bool bit_at(const uint32_t* mask, int32_t lab, uint32_t p) const {
    int32_t pi = static_cast<int32_t>(p);
    int32_t col = pi >> 5;  // arithmetic, as jnp int32
    col = col < 0 ? 0 : (col > wm - 1 ? wm - 1 : col);
    uint32_t w = mask[jix(lab, L) * wm + col];
    return !char0(lab, p) && ((w >> static_cast<uint32_t>(pi & 31)) & 1u);
  }
  __device__ uint32_t next_semi(int32_t lab, uint32_t p) const {
    const int32_t* ps = spos + jix(lab, L) * R;
    int32_t pi = static_cast<int32_t>(p);
    int32_t best = BIG;
    for (int r = 0; r < R; ++r) {
      int32_t v = ps[r] >= pi ? ps[r] : BIG;
      best = min(best, v);
    }
    return static_cast<uint32_t>(best);
  }
  // range-min over adjacent LCPs in (ra, rb]
  __device__ uint32_t lcp(int32_t ra, int32_t rb) const {
    int32_t n = rb - ra;
    int32_t m = 31 - __clz(max(n, 1));
    int32_t mi = m < 0 ? 0 : (m > nlev - 1 ? nlev - 1 : m);
    int32_t lo = st[static_cast<int64_t>(mi) * L + jix(static_cast<int64_t>(ra) + 1, L)];
    int32_t hi = st[static_cast<int64_t>(mi) * L +
                    jix(max(rb - (1 << m) + 1, 0), L)];
    return static_cast<uint32_t>(min(lo, hi));
  }
};

__device__ __forceinline__ uint32_t cut(uint32_t x, uint32_t taxacut) {
  uint32_t c = x - x / taxacut;
  return c + ((x >> 1) >= c ? 1u : 0u);
}

__global__ void aufbau_vote_kernel(const int32_t* __restrict__ labels,
                                   const int32_t* __restrict__ counts,
                                   const int32_t* __restrict__ nuniq_p,
                                   const int32_t* __restrict__ found_p, int64_t B,
                                   int32_t C, Tables tab, uint32_t taxacut,
                                   int32_t max_iters, int32_t* __restrict__ out) {
  int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int32_t* lrow = labels + b * C;
  const int32_t* crow = counts + b * C;
  int32_t nuniq = nuniq_p[b], found = found_p[b];

  // sort the entries by string rank (tax_cnt qsort, itree.c:1041); stable,
  // as jnp.argsort is
  int32_t lab[MAXC], rk[MAXC];
  uint32_t cnt[MAXC];
  for (int i = 0; i < C; ++i) {
    int32_t l = lrow[i];
    int32_t r = l >= 0 ? tab.rank[jix(l, tab.L)] : BIG;
    uint32_t c = static_cast<uint32_t>(crow[i]);
    int j = i;
    while (j > 0 && rk[j - 1] > r) {
      lab[j] = lab[j - 1];
      rk[j] = rk[j - 1];
      cnt[j] = cnt[j - 1];
      --j;
    }
    lab[j] = l;
    rk[j] = r;
    cnt[j] = c;
  }
  auto ent = [&](int32_t i) { return i < 0 ? 0 : (i > C - 1 ? C - 1 : i); };

  uint32_t found_u = static_cast<uint32_t>(found);
  int32_t uix = min(nuniq, C);
  bool walk = nuniq >= 2 && nuniq <= C && found >= 2;
  bool over = nuniq > C;

  int32_t st = 0, ed = uix, z = 1;
  uint32_t dv = M1, td = M1, run = cnt[0], orun = found_u;
  uint32_t cutoff = cut(found_u, taxacut);
  uint32_t sl = 0, ol = 0;
  bool done = !walk;
  for (int32_t it = 0; !done && it < max_iters; ++it) {
    if (z < ed) {  // ---- inner step (itree.c:1048-1079) ----
      int32_t lab1 = lab[ent(z - 1)], lab2 = lab[ent(z)];
      uint32_t cnt1 = cnt[ent(z - 1)], cnt2 = cnt[ent(z)];
      int32_t r1 = rk[ent(z - 1)], r2 = rk[ent(z)];
      uint32_t probe = dv == M1 ? 0u : dv;
      bool case0 = tab.char0(lab1, probe);  // s1 exhausted at this depth: drop it
      uint32_t l12 = tab.lcp(r1, r2);
      uint32_t stop = min(static_cast<uint32_t>(tab.slen[jix(lab1, tab.L)]), l12);
      uint32_t tdn = min(tab.next_semi(lab1, dv + 1u), stop);
      bool c_eq = tdn < l12;
      bool c1_0 = tab.char0(lab1, tdn);
      bool c1_semi = tab.bit_at(tab.semi, lab1, tdn);
      bool c2_semi = tab.bit_at(tab.semi, lab2, tdn);
      bool c1_und = tdn >= 1 && tab.bit_at(tab.und, lab1, tdn - 1u);
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
      if (single && cnt[ent(ed - 1)] >= cutoff) dv = M2;
      if (!exit1 && !single) {  // descend: outer re-init
        orun = run;
        dv = td;
        cutoff = cut(run, taxacut);
        run = cnt[ent(st)];
        z = st + 1;
      }
      done = exit1 || single;
    }
  }

  bool hit_cap = walk && !done;  // defensive: never expected, host replays
  int32_t rep = lab[ent(ed - 1)];
  int32_t dvcode = dv == M1 ? DV_EMPTY : (dv == M2 ? DV_FULL : DV_INTERP);
  if (nuniq <= 1) {  // short circuit: the single label, full string
    rep = lrow[0];
    dvcode = DV_FULL;
  }
  int32_t flag = (over || hit_cap) ? 1 : 0;
  // value-range insurance (lookup.py:801-803): fields too wide for their
  // packed lanes flag the read for the exact host replay
  int32_t dv_i = static_cast<int32_t>(dv), sl_i = static_cast<int32_t>(sl),
          ol_i = static_cast<int32_t>(ol);
  bool unfit = found >= (1 << 20) || sl_i >= (1 << 16) || ol_i >= (1 << 16) ||
               (dvcode == DV_INTERP && dv_i >= (1 << 11));
  flag |= unfit ? 1 : 0;
  uint32_t w0 = static_cast<uint32_t>(rep + 1) |
                (static_cast<uint32_t>(min(nuniq, 31)) << 17) |
                (static_cast<uint32_t>(dvcode) << 22) |
                (static_cast<uint32_t>(flag) << 24);
  uint32_t w1 = found_u | ((dvcode == DV_INTERP ? dv : 0u) << 20);
  uint32_t w2 = sl | (ol << 16);
  out[3 * b] = static_cast<int32_t>(w0);
  out[3 * b + 1] = static_cast<int32_t>(w1);
  out[3 * b + 2] = static_cast<int32_t>(w2);
}

}  // namespace

extern "C" int utree_aufbau_vote(
    const void* labels, const void* counts, const void* nuniq, const void* found,
    int64_t B, int32_t C, const void* rank, const void* st, int32_t nlev,
    int32_t L, const void* slen, const void* semi, const void* und, int32_t wm,
    const void* spos, int32_t R, int32_t taxacut, int32_t max_iters, void* out,
    void* stream) {
  if (C < 1 || C > MAXC) return static_cast<int>(cudaErrorInvalidValue);
  Tables tab{static_cast<const int32_t*>(rank), static_cast<const int32_t*>(st),
             nlev, L, static_cast<const int32_t*>(slen),
             static_cast<const uint32_t*>(semi), static_cast<const uint32_t*>(und),
             wm, static_cast<const int32_t*>(spos), R};
  const int threads = 128;
  if (B > 0) {
    aufbau_vote_kernel<<<utree_blocks(B, threads), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(labels), static_cast<const int32_t*>(counts),
        static_cast<const int32_t*>(nuniq), static_cast<const int32_t*>(found), B,
        C, tab, static_cast<uint32_t>(taxacut), max_iters,
        static_cast<int32_t*>(out));
  }
  UTREE_LAUNCH_RESULT();
}
