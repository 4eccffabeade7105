// Native xtree ALIGN scan: rolling fwd+RC encode + per-bin lower-bound probe,
// emitting (prefix, seed) hit pairs per query in scan order (position
// ascending, forward before RC) — the data-parallel redesign of the
// reference's ALIGN hot loop (xtree.c:1024-1081), exactness-matched to
// utree_tpu/xtree/align.py:_batch_hits (the NumPy spec twin, itself golden-
// tested against the reference binary).
//
// Single pass: each query writes into its own pre-sized span
// [qoff[q], qoff[q] + 2*windows(q)) and reports how many hits it produced;
// the caller compacts (so OpenMP threads never contend on an output cursor).

#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// strict ACGT table (encode.py _CODE_TABLE / C2Xb, itree.c:110-121); the
// align query path treats every other byte as a window-invalidating base
int8_t CODE[256];
struct InitCode {
    InitCode() {
        for (int i = 0; i < 256; i++) CODE[i] = -1;
        CODE['A'] = CODE['a'] = 0;
        CODE['C'] = CODE['c'] = 1;
        CODE['G'] = CODE['g'] = 2;
        CODE['T'] = CODE['t'] = 3;
    }
} init_code;

// LBS_k lower bound within [lo, hi) + sentinel-tolerant hit test
// (align.py:_lookup; the C checks KP[L] even when L == bin end)
static inline int64_t probe(const int64_t* sfx, int64_t lo, int64_t hi,
                            int64_t suf) {
    if (lo >= hi) return -1;
    int64_t l = lo, r = hi;
    while (l < r) {
        int64_t m = (l + r) >> 1;
        if (sfx[m] < suf) l = m + 1; else r = m;
    }
    return sfx[l] == suf ? l : -1;
}

}  // namespace

extern "C" {

// Scan the query buffer (FASTA or FASTQ, already decompressed) into record
// quads: [hstart (after '>'/'@'), hend (excl '\n', '\r' kept), sstart, send]
// — the byte-exact twin of xtree/io.iter_queries (name = full header minus
// its first character, NOT cut at spaces; FASTQ detected per record by '@'
// and its '+'/quality lines skipped; a record at EOF missing its sequence
// or FASTQ tail lines is dropped, like the Python reader's early returns).
// Returns the record count, or -1 if max_recs is too small.
int64_t xt_scan_queries(const char* data, int64_t size, int64_t* recs,
                        int64_t max_recs) {
    int64_t pos = 0, n = 0;
    while (pos < size) {
        const char* nl = (const char*)memchr(data + pos, '\n', size - pos);
        const int64_t hend = nl ? nl - data : size;
        const bool fastq = hend > pos && data[pos] == '@';
        const int64_t hstart = hend > pos ? pos + 1 : pos;
        if (!nl) break;  // header without newline: seq readline -> EOF
        const int64_t spos = hend + 1;
        if (spos >= size) break;  // no sequence line
        const char* nl2 = (const char*)memchr(data + spos, '\n', size - spos);
        const int64_t send = nl2 ? nl2 - data : size;
        int64_t next = nl2 ? send + 1 : size;
        if (fastq) {  // skip '+' and quality lines; EOF on either drops
            if (next >= size) break;
            const char* nl3 =
                (const char*)memchr(data + next, '\n', size - next);
            next = nl3 ? (nl3 - data) + 1 : size;
            if (next >= size) break;
            const char* nl4 =
                (const char*)memchr(data + next, '\n', size - next);
            next = nl4 ? (nl4 - data) + 1 : size;
        }
        if (n >= max_recs) return -1;
        recs[n * 4] = hstart;
        recs[n * 4 + 1] = hend;
        recs[n * 4 + 2] = spos;
        recs[n * 4 + 3] = send;
        n++;
        pos = next;
    }
    return n;
}

// Scan nq queries (byte pool + per-query [qs, qe) spans — for the file
// fast path these point straight into the mmap'd/read file buffer, no
// per-query copies) against the (bins, sfx) k-mer grid.  k = pl + sl <= 29
// (2-bit words fit u64).  For query q, hits are written at
// pre_out/seed_out[qoff[q] ..]; counts[q] reports how many.  sfx must carry
// the one-past sentinel pod (align.py:100-104), so probe() may read index
// bins[last].
namespace {

// One query's rolling fwd+RC scan: hits appended to pq/sq, count returned.
static inline int64_t scan_one(const uint8_t* s, int64_t n, int32_t k,
                               int32_t sl, uint64_t mask_k, uint64_t mask_sl,
                               const int64_t* bins, const int64_t* sfx,
                               int64_t* pq, int64_t* sq) {
    int64_t c = 0;
    if (n < k) return 0;
    uint64_t w = 0, r = 0;
    int64_t last_bad = -1;
    for (int64_t i = 0; i < n; i++) {
        const int8_t cd = CODE[s[i]];
        const uint64_t cc = cd < 0 ? 0 : (uint64_t)cd;
        if (cd < 0) last_bad = i;
        w = ((w << 2) | cc) & mask_k;
        r = (r >> 2) | ((3ull - cc) << (2 * (k - 1)));
        const int64_t x = i - k + 1;
        if (x < 0 || last_bad >= x) continue;
        const int64_t pre_f = (int64_t)(w >> (2 * sl));
        const int64_t pre_r = (int64_t)(r >> (2 * sl));
        int64_t sd = probe(sfx, bins[pre_f], bins[pre_f + 1],
                           (int64_t)(w & mask_sl));
        if (sd >= 0) { pq[c] = pre_f; sq[c] = sd; c++; }
        sd = probe(sfx, bins[pre_r], bins[pre_r + 1],
                   (int64_t)(r & mask_sl));
        if (sd >= 0) { pq[c] = pre_r; sq[c] = sd; c++; }
    }
    return c;
}

}  // namespace

void xt_scan_hits(int64_t nq, const uint8_t* pool, const int64_t* qs,
                  const int64_t* qe, int32_t k, int32_t pl,
                  const int64_t* bins, const int64_t* sfx,
                  const int64_t* qoff,
                  int64_t* pre_out, int64_t* seed_out, int64_t* counts) {
    const int32_t sl = k - pl;
    const uint64_t mask_k = (2 * k == 64) ? ~0ull : ((1ull << (2 * k)) - 1);
    const uint64_t mask_sl = (1ull << (2 * sl)) - 1;
#pragma omp parallel for schedule(dynamic, 16)
    for (int64_t q = 0; q < nq; q++) {
        counts[q] = scan_one(pool + qs[q], qe[q] - qs[q], k, sl, mask_k,
                             mask_sl, bins, sfx, pre_out + qoff[q],
                             seed_out + qoff[q]);
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Tally kernels: C++ twins of align.py:_batch_ref_tally / _batch_h_tally
// (expansion per xtree.c:1104-1120 with the probed-bin hardstop; per-run
// consecutive-rix dedupe; insertion-order keys = expanded-space flat index).
// Outputs are per-query spans at caller-provided upper-bound offsets; the
// caller compacts.  Scratch is epoch-stamped direct-index arrays so each
// (query, ref/taxon) op is O(1).
// ---------------------------------------------------------------------------

#include <algorithm>
#include <cstddef>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// Fused scan + ref vote for the fast path (no cov/redist): per query, scan
// windows into its pre-sized hit span, then IMMEDIATELY run the distinct-ref
// tally over the still-cache-hot hits (expansion + consecutive-rix dedupe +
// the probed-bin hardstop, xtree.c:1104-1138) and reduce to tix/max/max2/
// argmax (smaller-rix tie-break via the unsigned -1 initial,
// xtree.c:1131-1138).  Saves the separate xt_ref_tally walk, its ebase
// pass, and the xt_tally_bounds re-walk — the CSR nobody reads on this
// path is simply never built.  Hit spans are still written (the deep
// taxonomy call re-reads them for ambiguous queries).
void xt_scan_hits_tally(int64_t nq, const uint8_t* pool, const int64_t* qs,
                        const int64_t* qe, int32_t k, int32_t pl,
                        const int64_t* bins, const int64_t* sfx,
                        const int64_t* run_end_ext, const int64_t* rix,
                        int64_t R, const int64_t* qoff,
                        int64_t* pre_out, int64_t* seed_out, int64_t* counts,
                        int64_t* mx, int64_t* mx2, int64_t* mixv) {
    const int32_t sl = k - pl;
    const uint64_t mask_k = (2 * k == 64) ? ~0ull : ((1ull << (2 * k)) - 1);
    const uint64_t mask_sl = (1ull << (2 * sl)) - 1;
#pragma omp parallel
    {
        std::vector<int64_t> cnt(R, 0), stamp(R, -1);
        std::vector<int64_t> touched;
#pragma omp for schedule(dynamic, 16)
        for (int64_t q = 0; q < nq; q++) {
            int64_t* pq = pre_out + qoff[q];
            int64_t* sq = seed_out + qoff[q];
            const int64_t c = scan_one(pool + qs[q], qe[q] - qs[q], k, sl,
                                       mask_k, mask_sl, bins, sfx, pq, sq);
            counts[q] = c;
            touched.clear();
            for (int64_t i = 0; i < c; i++) {
                const int64_t s = sq[i];
                int64_t e = run_end_ext[s];
                const int64_t hard = bins[pq[i] + 1];
                if (hard < e) e = hard;
                int64_t prev = -1;
                for (int64_t j = s; j < e; j++) {
                    const int64_t rx = rix[j];
                    if (rx == prev) continue;
                    prev = rx;
                    if (stamp[rx] != q) {
                        stamp[rx] = q;
                        cnt[rx] = 1;
                        touched.push_back(rx);
                    } else {
                        cnt[rx]++;
                    }
                }
            }
            int64_t m1 = 0, m2 = 0;
            uint64_t mi = ~0ull;  // (rix_t)-1: unsigned compare initial
            for (size_t t = 0; t < touched.size(); t++) {
                const int64_t rx = touched[t];
                const int64_t cc = cnt[rx];
                if (cc > m1) {
                    m2 = m1;
                    m1 = cc;
                    mi = (uint64_t)rx;
                } else if (cc == m1) {  // equal max: mx2 gains multiplicity
                    m2 = cc;
                    if ((uint64_t)rx < mi) mi = (uint64_t)rx;
                } else if (cc > m2) {
                    m2 = cc;
                }
            }
            mx[q] = m1;
            mx2[q] = m2;
            mixv[q] = mi == ~0ull ? -1 : (int64_t)mi;
        }
    }
}

// Per-query distinct-ref counts + max/max2/argmax.  Hits arrive qid-ascending
// (scan order); qstart[q]..qstart[q+1] bounds query q's hits; out arrays are
// written at qoff[q] (caller-computed upper bound >= distinct refs of q).
// Emits per query, sorted by ref id: out_r, out_c, out_first (expanded-space
// flat index of the ref's first kept occurrence — the dict-insertion key);
// nd[q] = number of distinct refs.  mx/mx2/mix per align.py:_group_minmax
// (mx2 = second-largest count WITH multiplicity; mix = min ref id among
// count == mx, -1 if the query has no entries).
void xt_ref_tally(const int64_t* qid, const int64_t* pre, const int64_t* seed,
                  const int64_t* bins, const int64_t* run_end_ext,
                  const int64_t* rix,
                  int64_t Q, int64_t R,
                  const int64_t* qstart, const int64_t* qoff,
                  int64_t* mx, int64_t* mx2, int64_t* mixv,
                  int64_t* out_r, int64_t* out_c, int64_t* out_first,
                  int64_t* nd) {
    // expanded-space flat offset of each hit's run start (global across the
    // chunk, matching numpy's kidx over np.repeat order)
    std::vector<int64_t> ebase(qstart[Q] + 1, 0);
    for (int64_t i = 0; i < qstart[Q]; i++) {
        int64_t L = run_end_ext[seed[i]];
        int64_t hard = bins[pre[i] + 1];
        if (hard < L) L = hard;
        L -= seed[i];
        if (L < 0) L = 0;
        ebase[i + 1] = ebase[i] + L;
    }
#pragma omp parallel
    {
        std::vector<int64_t> cnt(R, 0), stamp(R, -1), first(R, 0);
        std::vector<int64_t> touched;
#pragma omp for schedule(dynamic, 64)
        for (int64_t q = 0; q < Q; q++) {
            touched.clear();
            for (int64_t i = qstart[q]; i < qstart[q + 1]; i++) {
                int64_t s = seed[i];
                int64_t e = run_end_ext[s];
                int64_t hard = bins[pre[i] + 1];
                if (hard < e) e = hard;
                int64_t prev = -1;
                for (int64_t j = s; j < e; j++) {
                    int64_t rx = rix[j];
                    if (rx == prev) continue;   // consecutive in-run dedupe
                    prev = rx;
                    if (stamp[rx] != q) {
                        stamp[rx] = q;
                        cnt[rx] = 1;
                        first[rx] = ebase[i] + (j - s);
                        touched.push_back(rx);
                    } else {
                        cnt[rx]++;
                    }
                }
            }
            // sorted-by-ref CSR (numpy np.unique(key) order)
            std::sort(touched.begin(), touched.end());
            int64_t o = qoff[q];
            int64_t m1 = 0, m2 = 0, mi = -1;
            for (size_t t = 0; t < touched.size(); t++) {
                int64_t rx = touched[t];
                int64_t c = cnt[rx];
                out_r[o + t] = rx;
                out_c[o + t] = c;
                out_first[o + t] = first[rx];
                if (c > m1) { m2 = m1; m1 = c; mi = rx; }
                else if (c == m1 && rx < mi) { m2 = m1; mi = rx; }
                else if (c > m2) { m2 = c; }
            }
            // mx2 carries multiplicity (two count==mx entries -> mx2 == mx):
            // a later equal-max entry lands in one of the two else branches,
            // both of which set m2 = m1
            nd[q] = (int64_t)touched.size();
            mx[q] = m1;
            mx2[q] = m2;
            mixv[q] = touched.empty() ? -1 : mi;
        }
    }
}

// Per-query output upper bounds for the tally kernels: bound[q] =
// min(total expanded pods of q's hits, cap) — the C twin of the glue's
// gather+segment-sum (the NumPy version measured ~as costly as the tally).
void xt_tally_bounds(const int64_t* pre, const int64_t* seed,
                     const int64_t* bins, const int64_t* run_end_ext,
                     int64_t Q, const int64_t* qstart, int64_t cap,
                     int64_t* bound) {
#pragma omp parallel for schedule(static)
    for (int64_t q = 0; q < Q; q++) {
        int64_t tot = 0;
        for (int64_t i = qstart[q]; i < qstart[q + 1]; i++) {
            int64_t L = run_end_ext[seed[i]];
            int64_t hard = bins[pre[i] + 1];
            if (hard < L) L = hard;
            L -= seed[i];
            if (L > 0) tot += L;
        }
        bound[q] = tot < cap ? tot : cap;
    }
}

// Per-(query, taxon) counts with per-seed-entry dedupe (each entry adds at
// most 1 per taxon, the sign trick xtree.c:1200-1215), optional lbin ancestor
// fold (-1 = drop).  Same span/offset scheme as xt_ref_tally; out_ins is the
// expanded-space flat index of the (query, taxon)'s global first encounter
// (align.py:_batch_h_tally's ins2).
void xt_h_tally(const int64_t* pre, const int64_t* seed,
                const int64_t* bins, const int64_t* run_end_ext,
                const int64_t* rix, const int64_t* hmap, const int64_t* lbin,
                int64_t Q, int64_t Hn,
                const int64_t* qstart, const int64_t* qoff,
                int64_t* out_h, int64_t* out_c, int64_t* out_ins,
                int64_t* nd) {
    std::vector<int64_t> ebase(qstart[Q] + 1, 0);
    for (int64_t i = 0; i < qstart[Q]; i++) {
        int64_t L = run_end_ext[seed[i]];
        int64_t hard = bins[pre[i] + 1];
        if (hard < L) L = hard;
        L -= seed[i];
        if (L < 0) L = 0;
        ebase[i + 1] = ebase[i] + L;
    }
#pragma omp parallel
    {
        std::vector<int64_t> cnt(Hn, 0), qstamp(Hn, -1), ins(Hn, 0);
        std::vector<int64_t> estamp(Hn, -1);  // per-entry dedupe epoch
        std::vector<int64_t> touched;
#pragma omp for schedule(dynamic, 64)
        for (int64_t q = 0; q < Q; q++) {
            touched.clear();
            for (int64_t i = qstart[q]; i < qstart[q + 1]; i++) {
                int64_t s = seed[i];
                int64_t e = run_end_ext[s];
                int64_t hard = bins[pre[i] + 1];
                if (hard < e) e = hard;
                for (int64_t j = s; j < e; j++) {
                    int64_t h = hmap[rix[j]];
                    if (lbin) {
                        h = lbin[h];
                        if (h == -1) continue;
                    }
                    if (estamp[h] == i) continue;  // this entry already voted h
                    estamp[h] = i;
                    if (qstamp[h] != q) {
                        qstamp[h] = q;
                        cnt[h] = 1;
                        ins[h] = ebase[i] + (j - s);
                        touched.push_back(h);
                    } else {
                        cnt[h]++;
                    }
                }
            }
            std::sort(touched.begin(), touched.end());
            int64_t o = qoff[q];
            for (size_t t = 0; t < touched.size(); t++) {
                int64_t h = touched[t];
                out_h[o + t] = h;
                out_c[o + t] = cnt[h];
                out_ins[o + t] = ins[h];
            }
            nd[q] = (int64_t)touched.size();
        }
    }
}

// Fused deep taxonomy call (one call per chunk): for each ambiguous query
// (matched but not early-called, xtree.c:1196-1301), run the full-string
// tally and — when still ambiguous — the per-level LBins aufbau walk,
// entirely in C.  Replaces the per-level xt_h_tally round trips (each of
// which re-subset the hit arrays and re-walked the pod grid through
// NumPy glue).  Semantics are the literal twin of align.py's
// _align_chunk deep block + _batch_aufbau (themselves golden-tested
// against the reference binary):
//   - per-seed-entry dedupe (the sign trick, xtree.c:1200-1215);
//   - full-level argmax tie-break = smallest taxon id (h_maxIx1 unsigned
//     -1 compare, xtree.c:1221); mx2 carries multiplicity;
//   - shallow accept if mx2==0 or (!full_lca && mx>mx2 && mx/tix>=conf);
//   - level walk: ag_thres = (int64)(conf*tix); per level only counts
//     >= ag_thres compete; strict > keeps the FIRST-inserted taxon;
//     winner accepted while lmax > lmax2 && lmax >= ag_thres
//     (xtree.c:1241-1301); ft_lv = winning level, and under tax_out
//     mb[q][1+h] = winner + win_lv * Hn (xtree.c:1300).
// The pod expansion (rix per pod, entry boundaries) is materialized once
// per query and reused across both hierarchies and all levels.
// lbins[h] is row-major (L, Hn); ft_ix/ft_lv are (Q,2), mb is (Q,3).
void xt_deep_call(const int64_t* deepq, int64_t ndq, const int64_t* qstart,
                  const int64_t* pre, const int64_t* seed,
                  const int64_t* bins, const int64_t* run_end_ext,
                  const int64_t* rix,
                  const int64_t* hmap0, int64_t Hn0, const int64_t* lbins0,
                  int64_t L0,
                  const int64_t* hmap1, int64_t Hn1, const int64_t* lbins1,
                  int64_t L1,
                  int64_t has_h0, int64_t has_h1,
                  const int64_t* tix, double conf, int64_t do_full_lca,
                  int64_t tax_out,
                  int64_t* ft_ix, int64_t* ft_lv, int64_t* mb) {
    const int64_t HnMax = (Hn0 > Hn1 ? Hn0 : Hn1) + 1;
#pragma omp parallel
    {
        std::vector<int64_t> cnt(HnMax, 0), qstamp(HnMax, -1),
            estamp(HnMax, -1), ins(HnMax, 0);
        std::vector<int64_t> prx, pent;  // per-pod rix + entry id, one query
        std::vector<int64_t> touched;    // taxa in first-encounter order
        int64_t etok = 0, qtok = 0;
#pragma omp for schedule(dynamic, 32)
        for (int64_t d = 0; d < ndq; d++) {
            const int64_t q = deepq[d];
            prx.clear();
            pent.clear();
            for (int64_t i = qstart[q]; i < qstart[q + 1]; i++) {
                const int64_t s = seed[i];
                int64_t e = run_end_ext[s];
                const int64_t hard = bins[pre[i] + 1];
                if (hard < e) e = hard;
                for (int64_t j = s; j < e; j++) {
                    prx.push_back(rix[j]);
                    pent.push_back(i);
                }
            }
            const int64_t np = (int64_t)prx.size();
            for (int h = 0; h < 2; h++) {
                if (h == 0 ? !has_h0 : !has_h1) break;  // break, not continue
                const int64_t* hmap = h ? hmap1 : hmap0;
                const int64_t Hn = h ? Hn1 : Hn0;
                const int64_t* lbins = h ? lbins1 : lbins0;
                const int64_t L = h ? L1 : L0;
                // full-string tally (xtree.c:1196-1239)
                touched.clear();
                ++qtok;
                int64_t cur_e = -1;
                for (int64_t p = 0; p < np; p++) {
                    if (pent[p] != cur_e) {
                        cur_e = pent[p];
                        ++etok;
                    }
                    const int64_t f = hmap[prx[p]];
                    if (estamp[f] == etok) continue;
                    estamp[f] = etok;
                    if (qstamp[f] != qtok) {
                        qstamp[f] = qtok;
                        cnt[f] = 1;
                        touched.push_back(f);
                    } else {
                        cnt[f]++;
                    }
                }
                int64_t m1 = 0, m2 = 0;
                int64_t mi = INT64_MAX;  // (rix_t)-1 initial, unsigned compare
                for (size_t t = 0; t < touched.size(); t++) {
                    const int64_t tx = touched[t];
                    const int64_t c = cnt[tx];
                    if (c > m1 || (c == m1 && tx < mi)) {
                        m2 = m1;
                        m1 = c;
                        mi = tx;
                    } else if (c > m2) {
                        m2 = c;
                    }
                }
                const double txq = tix[q] > 1 ? (double)tix[q] : 1.0;
                if (m2 == 0 || (!do_full_lca && m1 > m2 &&
                                (double)m1 / txq >= conf)) {
                    ft_ix[2 * q + h] = mi;  // shallow accept; ft_lv stays 0
                    continue;
                }
                // LBins level walk (xtree.c:1241-1301)
                const int64_t ag_thres = (int64_t)(conf * (double)tix[q]);
                int64_t agreed = tix[q], winner = -1, win_lv = -1;
                int64_t semi = 1;
                while (agreed >= ag_thres && semi - 1 < L) {
                    const int64_t* lb = lbins + (semi - 1) * Hn;
                    touched.clear();
                    ++qtok;
                    cur_e = -1;
                    for (int64_t p = 0; p < np; p++) {
                        if (pent[p] != cur_e) {
                            cur_e = pent[p];
                            ++etok;
                        }
                        int64_t f = lb[hmap[prx[p]]];
                        if (f == -1) continue;
                        if (estamp[f] == etok) continue;
                        estamp[f] = etok;
                        if (qstamp[f] != qtok) {
                            qstamp[f] = qtok;
                            cnt[f] = 1;
                            touched.push_back(f);
                        } else {
                            cnt[f]++;
                        }
                    }
                    // insertion-order iteration + strict '>' keeps the
                    // first-inserted taxon among equals (dict-order contract)
                    int64_t lmax = 0, lmax2 = 0, lwin = 0;
                    for (size_t t = 0; t < touched.size(); t++) {
                        const int64_t c = cnt[touched[t]];
                        if (c < ag_thres) continue;
                        if (c > lmax) {
                            lmax2 = lmax;
                            lmax = c;
                            lwin = touched[t];
                        } else if (c > lmax2) {
                            lmax2 = c;
                        }
                    }
                    if (lmax > lmax2 && lmax >= ag_thres) {
                        agreed = lmax;
                        winner = lwin;
                        win_lv = semi;
                    } else {
                        agreed = 0;
                    }
                    semi++;
                }
                if (winner != -1) {
                    ft_ix[2 * q + h] = winner;
                    ft_lv[2 * q + h] = win_lv;
                    if (tax_out) mb[3 * q + 1 + h] = winner + win_lv * Hn;
                }
            }
        }
    }
}

// Per-query perq output formatting (xtree.c:1344-1396's per-query print,
// batch form of align.py:_align_chunk's Python tail — the cProfile'd ~25%
// of host-mode ALIGN).  Lines are joined by '\n' with NO trailing newline,
// so the caller's `write(blob + "\n")` is byte-identical to writing each
// line + "\n".  Returns bytes written, or -1 if cap is too small (caller
// retries with a bigger buffer, the vote.cpp protocol).
int64_t xt_format_perq(int64_t Q,
                       const uint8_t* head_pool, const int64_t* head_s,
                       const int64_t* head_e,
                       const uint8_t* rn_pool, const int64_t* rn_off,
                       const uint8_t* h0_pool, const int64_t* h0_off,
                       const uint8_t* h1_pool, const int64_t* h1_off,
                       const uint8_t* matched,
                       const int64_t* mixv, const int64_t* mx,
                       const int64_t* mx2, const int64_t* tix,
                       const int64_t* ft_ix, const int64_t* ft_lv,
                       uint8_t* out, int64_t cap) {
    static const char NOMATCH[] = "\tNo matches found";
    int64_t o = 0;
    for (int64_t q = 0; q < Q; q++) {
        if (q) {
            if (o + 1 > cap) return -1;
            out[o++] = '\n';
        }
        const int64_t hl = head_e[q] - head_s[q];
        if (o + hl > cap) return -1;
        std::copy(head_pool + head_s[q], head_pool + head_e[q], out + o);
        o += hl;
        if (!matched[q]) {
            if (o + (int64_t)sizeof(NOMATCH) > cap) return -1;
            std::copy(NOMATCH, NOMATCH + sizeof(NOMATCH) - 1, out + o);
            o += sizeof(NOMATCH) - 1;
            continue;
        }
        const int64_t r = mixv[q];
        const int64_t rl = rn_off[r + 1] - rn_off[r];
        if (o + rl + 49 > cap) return -1;
        out[o++] = '\t';
        std::copy(rn_pool + rn_off[r], rn_pool + rn_off[r + 1], out + o);
        o += rl;
        o += snprintf((char*)out + o, 48, "\t[%lld,%lld]\t",
                      (long long)mx[q], (long long)mx2[q]);
        for (int h = 0; h < 2; h++) {
            const uint8_t* pool = h ? h1_pool : h0_pool;
            const int64_t* off = h ? h1_off : h0_off;
            const int64_t ix = ft_ix[2 * q + h];
            if (ix >= 0) {
                const uint8_t* s = pool + off[ix];
                int64_t sl = off[ix + 1] - off[ix];
                const int64_t lv = ft_lv[2 * q + h];
                if (lv > 0) {
                    // exact twin of the Python `p = s.find(b";", p + 1)`
                    // loop: a failed find restarts the next scan at offset 0
                    int64_t p = -1;
                    for (int64_t t = 0; t < lv; t++) {
                        const uint8_t* hit = (const uint8_t*)memchr(
                            s + (p + 1), ';', (size_t)(sl - (p + 1)));
                        p = hit ? (int64_t)(hit - s) : -1;
                    }
                    if (p >= 0) sl = p;
                }
                if (o + sl + 1 > cap) return -1;
                std::copy(s, s + sl, out + o);
                o += sl;
            } else if (o + 1 > cap) {
                return -1;
            }
            out[o++] = '\t';
        }
        if (o + 24 > cap) return -1;
        o += snprintf((char*)out + o, 24, "%lld", (long long)tix[q]);
    }
    return o;
}

}  // extern "C"
