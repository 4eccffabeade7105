// Native vote + line formatting for the utree-tpu search pipeline.
//
// The device returns per-read sparse label histograms; this module turns them
// into classification lines with the reference's "optimal aufbau" semantics
// (itree.c:1028-1098, reimplemented — see utree_tpu/classify.py for the
// annotated Python reference implementation; both are property-tested for
// equality).  C++ because at >100K reads/s the per-read string walk dominates
// a Python host loop.
//
// Build: g++ -O3 -shared -fPIC -o libutreevote.so vote.cpp
// ABI: plain C, driven via ctypes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <algorithm>
#include <string>
#include <vector>

namespace {

constexpr uint32_t DV_M1 = 0xFFFFFFFFu;  // (uint32_t)-1
constexpr uint32_t DV_M2 = 0xFFFFFFFEu;  // (uint32_t)-2

struct TaxCnt {
  const char* s;
  uint32_t n;
};

// One read's aufbau walk over string-sorted (label, count) entries.
// Returns via out params: toPrint span (ptr,len), sl, ol.
void aufbau_walk(TaxCnt* tc, uint32_t uix, uint32_t found_uniq, uint32_t taxacut,
                 const char** print_s, uint32_t* print_len, int* print_full,
                 uint32_t* sl_out, uint32_t* ol_out) {
  uint32_t cutoff = found_uniq - found_uniq / taxacut;
  cutoff += (found_uniq >> 1) >= cutoff;
  uint32_t st = 0, ed = uix, dv = DV_M1, orun = found_uniq, sl = 0, ol = 0;
  for (;;) {
    uint32_t run = tc[st].n, td = dv;
    for (uint32_t z = st + 1; z < ed; ++z) {
      const char* s1 = tc[z - 1].s;
      const char* s2 = tc[z].s;
      uint32_t probe = (dv == DV_M1) ? 0u : dv;
      if (!s1[probe]) {
        run = tc[z].n;
        st = z;
        orun -= tc[z - 1].n;
        cutoff = orun - orun / taxacut;
        cutoff += (orun >> 1) >= cutoff;
        continue;
      }
      td = dv + 1;  // wraps to 0 when dv == DV_M1
      while (s1[td] && s1[td] == s2[td]) {
        if (s1[td] == ';') break;
        ++td;
      }
      if (s1[td] == s2[td]) {
        run += tc[z].n;
      } else if ((!s1[td] && s2[td] == ';') ||
                 ((s1[td] == ';' || !s1[td]) && td >= 1 && s1[td - 1] == '_')) {
        run = tc[z].n;
        st = z;
        orun -= tc[z - 1].n;
        cutoff = orun - orun / taxacut;
        cutoff += (orun >> 1) >= cutoff;
      } else if (run >= cutoff) {
        ed = z;
        break;
      } else {
        run = tc[z].n;
        st = z;
      }
    }
    sl = run;
    ol = orun;
    if (run < cutoff) break;
    if (st + 1 >= ed) {
      if (tc[ed - 1].n >= cutoff) dv = DV_M2;
      break;
    }
    if (!tc[ed - 1].s[td] || tc[ed - 1].s[td] == ';') {
      sl = run;
      ol = orun;
    }
    orun = run;
    dv = td;
    cutoff = run - run / taxacut;
    cutoff += (run >> 1) >= cutoff;
  }
  if (dv == DV_M1) {
    *print_s = "";
    *print_len = 0;
    *print_full = 0;
  } else if (dv == DV_M2) {
    *print_s = tc[ed - 1].s;
    *print_full = 1;
  } else {
    *print_s = tc[ed - 1].s;
    *print_len = dv;
    *print_full = 0;
  }
  *sl_out = sl;
  *ol_out = ol;
}

// Stack-resident histogram size for the common case; wider histograms (e.g. a
// 16Mb query hitting thousands of labels) grow onto the heap instead of
// failing — the reference sizes its Tax_Cnt to the full label count
// (itree.c:1012-1015), so no width may be a hard error here.
constexpr int MAX_U = 4096;

// Returns a TaxCnt span of at least `nu` entries: the caller's fixed buffer
// when it fits, else heap storage owned by `big`.
TaxCnt* tc_span(TaxCnt* fixed, std::vector<TaxCnt>& big, int64_t nu) {
  if (nu <= MAX_U) return fixed;
  if ((int64_t)big.size() < nu) big.resize((size_t)nu);
  return big.data();
}

// Format one read's line from its (string, count) histogram entries (tc, in
// device emission order — the fast paths depend on the FIRST entry).  Returns
// bytes written, or -1 if fewer than 65536+256 bytes remain.
int64_t emit_read(TaxCnt* tc, int64_t nu, const char* name, int32_t taxacut,
                  char* out, char* out_end) {
  if (out_end - out < 65536 + 256) return -1;
  uint32_t found = 0;
  for (int64_t i = 0; i < nu; ++i) found += tc[i].n;
  if (found == 1)
    return snprintf(out, out_end - out, "%s\t%s\t1\t1\t*\n", name, tc[0].s);
  if (nu == 1)
    return snprintf(out, out_end - out, "%s\t%s\t%u\t1\t*\n", name, tc[0].s, found);
  std::sort(tc, tc + nu,
            [](const TaxCnt& a, const TaxCnt& b) { return strcmp(a.s, b.s) < 0; });
  const char* ps = "";
  uint32_t plen = 0, sl = 0, ol = 0;
  int pfull = 0;
  aufbau_walk(tc, (uint32_t)nu, found, (uint32_t)taxacut, &ps, &plen, &pfull,
              &sl, &ol);
  if (pfull)
    return snprintf(out, out_end - out, "%s\t%s\t%u\t%u\t%u;%u\n", name, ps,
                    found, (uint32_t)nu, sl, ol);
  return snprintf(out, out_end - out, "%s\t%.*s\t%u\t%u\t%u;%u\n", name,
                  (int)plen, ps, found, (uint32_t)nu, sl, ol);
}

}  // namespace

extern "C" {

// Vote a batch of reads.  Histograms arrive CSR: read r owns
// labels/counts[hist_offsets[r] .. hist_offsets[r+1]).  Strings and names are
// '\0'-terminated in pools addressed by offset arrays.  Writes "name\t...\n"
// lines (reads with empty histograms are skipped) into out_buf.
// Returns bytes written, or -1 if out_cap would overflow.
int64_t utree_vote_batch(
    int64_t n_reads,
    const int64_t* hist_offsets,
    const int32_t* labels,
    const int32_t* counts,
    const char* string_pool,
    const int64_t* string_offsets,
    const char* name_pool,
    const int64_t* name_offsets,
    int32_t taxacut,
    char* out_buf,
    int64_t out_cap) {
  TaxCnt tc_fixed[MAX_U];
  std::vector<TaxCnt> tc_big;
  char* out = out_buf;
  char* out_end = out_buf + out_cap;

  for (int64_t r = 0; r < n_reads; ++r) {
    int64_t lo = hist_offsets[r], hi = hist_offsets[r + 1];
    int64_t nu = hi - lo;
    if (nu == 0) continue;
    TaxCnt* tc = tc_span(tc_fixed, tc_big, nu);
    for (int64_t i = lo; i < hi; ++i) {
      tc[i - lo] = {string_pool + string_offsets[labels[i]], (uint32_t)counts[i]};
    }
    int64_t w = emit_read(tc, nu, name_pool + name_offsets[r], taxacut, out, out_end);
    if (w < 0) return -1;
    out += w;
  }
  return out - out_buf;
}

// Vote straight off the device's packed histogram output: row r of `packed`
// is cap u32 lanes of (count<<16 | label+1) followed by a tail lane
// (found<<5 | nuniq) — the layout search_step_hist_packed emits
// (utree_tpu/lookup.py).  This replaces the host-side unpack (4 full-matrix
// ops) + boolean-mask CSR flatten with one streaming pass, OpenMP across
// read chunks.  Rows whose nuniq exceeds cap must arrive as override CSR
// entries (over_rows ascending) — the caller recomputes those exactly on
// host (device cap overflow, same contract as the Python path).
// Returns bytes written, -1 if out_cap is too small (caller grows + retries),
// -3 on an unprovided overflow.  Override histograms of any width are
// accepted (heap growth past MAX_U entries).
int64_t utree_vote_packed(
    int64_t n_reads,
    const uint32_t* packed,
    int64_t cap,
    int64_t n_over,
    const int64_t* over_rows,
    const int64_t* over_offsets,
    const int32_t* over_labels,
    const int32_t* over_counts,
    const char* string_pool,
    const int64_t* string_offsets,
    const char* name_pool,
    const int64_t* name_offsets,
    int32_t taxacut,
    char* out_buf,
    int64_t out_cap) {
  const int64_t stride = cap + 1;
  constexpr int64_t CHUNK = 8192;
  const int64_t n_chunks = n_reads > 0 ? (n_reads + CHUNK - 1) / CHUNK : 0;
  std::vector<std::string> parts((size_t)n_chunks);
  int err = 0;
#pragma omp parallel for schedule(dynamic, 1)
  for (int64_t c = 0; c < n_chunks; ++c) {
    TaxCnt tc_fixed[MAX_U];
    std::vector<TaxCnt> tc_big;
    char line[1 << 17];
    std::string& part = parts[(size_t)c];
    const int64_t lo_r = c * CHUNK;
    const int64_t hi_r = std::min(n_reads, lo_r + CHUNK);
    int64_t oi = 0;
    while (oi < n_over && over_rows[oi] < lo_r) ++oi;
    for (int64_t r = lo_r; r < hi_r; ++r) {
      const uint32_t* row = packed + r * stride;
      int64_t nu;
      TaxCnt* tc = tc_fixed;
      if (oi < n_over && over_rows[oi] == r) {
        const int64_t a = over_offsets[oi], b = over_offsets[oi + 1];
        ++oi;
        nu = b - a;
        tc = tc_span(tc_fixed, tc_big, nu);
        for (int64_t i = a; i < b; ++i)
          tc[i - a] = {string_pool + string_offsets[over_labels[i]],
                       (uint32_t)over_counts[i]};
      } else {
        nu = row[cap] & 31u;
        if (nu == 0) continue;
        if (nu > cap) { err = 3; break; }
        for (int64_t i = 0; i < nu; ++i) {
          const uint32_t lc = row[i];
          tc[i] = {string_pool + string_offsets[(int64_t)(lc & 0xFFFFu) - 1],
                   lc >> 16};
        }
      }
      if (nu == 0) continue;
      const int64_t w = emit_read(tc, nu, name_pool + name_offsets[r], taxacut,
                                  line, line + sizeof line);
      if (w < 0) { err = 2; break; }  // cannot happen: line >> max guard
      part.append(line, (size_t)w);
    }
  }
  if (err) return -err;
  int64_t total = 0;
  for (const auto& p : parts) total += (int64_t)p.size();
  if (total > out_cap) return -1;
  char* out = out_buf;
  for (const auto& p : parts) {
    memcpy(out, p.data(), p.size());
    out += p.size();
  }
  return total;
}

// Format lines for the DEVICE-VOTED layout (lookup.search_step_vote_compact):
// row r of `main` is 3 u32 lanes
//   w0 = (rep_label+1) | nuniq<<17 | dvcode<<22 | flag<<24
//   w1 = foundUniq | dv<<20
//   w2 = sl | ol<<16
// where dvcode 1 = empty toprint ((uint32)-1), 2 = full string ((uint32)-2),
// 0 = cut at dv chars (itree.c:1087-1096).  The aufbau already ran ON DEVICE
// (classify_device.aufbau_walk_device); this pass only prints.  Rows with
// flag set (nuniq > device cap, or the defensive iteration cap) arrive as
// override CSR histograms and take the full host walk — the same contract
// as utree_vote_packed.  Returns bytes written, -1 if out_cap is too small.
int64_t utree_format_device_vote(
    int64_t n_reads,
    const uint32_t* main_rows,
    int64_t n_over,
    const int64_t* over_rows,
    const int64_t* over_offsets,
    const int32_t* over_labels,
    const int32_t* over_counts,
    const char* string_pool,
    const int64_t* string_offsets,
    const char* name_pool,
    const int64_t* name_offsets,
    int32_t taxacut,
    char* out_buf,
    int64_t out_cap) {
  constexpr int64_t CHUNK = 8192;
  const int64_t n_chunks = n_reads > 0 ? (n_reads + CHUNK - 1) / CHUNK : 0;
  std::vector<std::string> parts((size_t)n_chunks);
  int err = 0;
#pragma omp parallel for schedule(dynamic, 1)
  for (int64_t c = 0; c < n_chunks; ++c) {
    TaxCnt tc_fixed[MAX_U];
    std::vector<TaxCnt> tc_big;
    char line[1 << 17];
    std::string& part = parts[(size_t)c];
    const int64_t lo_r = c * CHUNK;
    const int64_t hi_r = std::min(n_reads, lo_r + CHUNK);
    int64_t oi = 0;
    while (oi < n_over && over_rows[oi] < lo_r) ++oi;
    for (int64_t r = lo_r; r < hi_r; ++r) {
      const char* name = name_pool + name_offsets[r];
      if (oi < n_over && over_rows[oi] == r) {
        const int64_t a = over_offsets[oi], b = over_offsets[oi + 1];
        ++oi;
        const int64_t nu = b - a;
        TaxCnt* tc = tc_span(tc_fixed, tc_big, nu);
        for (int64_t i = a; i < b; ++i)
          tc[i - a] = {string_pool + string_offsets[over_labels[i]],
                       (uint32_t)over_counts[i]};
        if (nu == 0) continue;
        const int64_t w = emit_read(tc, nu, name, taxacut, line,
                                    line + sizeof line);
        if (w < 0) { err = 2; break; }
        part.append(line, (size_t)w);
        continue;
      }
      const uint32_t w0 = main_rows[r * 3];
      const uint32_t nuniq = (w0 >> 17) & 31u;
      if (nuniq == 0) continue;
      if (w0 & (1u << 24)) { err = 3; break; }  // flag without an override
      const uint32_t w1 = main_rows[r * 3 + 1];
      const uint32_t w2 = main_rows[r * 3 + 2];
      const char* rep = string_pool + string_offsets[(int64_t)(w0 & 0x1FFFFu) - 1];
      const uint32_t found = w1 & 0xFFFFFu;
      int64_t w;
      if (nuniq == 1) {
        w = snprintf(line, sizeof line, "%s\t%s\t%u\t1\t*\n", name, rep, found);
      } else {
        const uint32_t dvcode = (w0 >> 22) & 3u;
        const uint32_t dv = (w1 >> 20) & 0x7FFu;
        const uint32_t sl = w2 & 0xFFFFu, ol = w2 >> 16;
        if (dvcode == 2u) {
          w = snprintf(line, sizeof line, "%s\t%s\t%u\t%u\t%u;%u\n", name, rep,
                       found, nuniq, sl, ol);
        } else {
          const int cut = dvcode == 1u ? 0 : (int)dv;
          w = snprintf(line, sizeof line, "%s\t%.*s\t%u\t%u\t%u;%u\n", name,
                       cut, rep, found, nuniq, sl, ol);
        }
      }
      if (w < 0 || w >= (int64_t)sizeof line) { err = 2; break; }
      part.append(line, (size_t)w);
    }
  }
  if (err) return -err;
  int64_t total = 0;
  for (const auto& p : parts) total += (int64_t)p.size();
  if (total > out_cap) return -1;
  char* out = out_buf;
  for (const auto& p : parts) {
    memcpy(out, p.data(), p.size());
    out += p.size();
  }
  return total;
}

}  // extern "C"
