// Native shallow (non-GG) scan: the literal XT_WORD_SEARCH + XT_SHALLOWVOTE
// word state machine (itree.c:903-951) at C speed, hits only.
//
// The machine must be replayed literally because the skip-after-hit re-entry
// over-shifts the rolling word (itree.c:920-924) and the reference then looks
// up CORRUPTED k-mers until the corruption rolls out of the mask — so hit
// sequences depend on the exact word evolution, not just on clean windows.
// This is the Python scan_shallow_literal translated to the flat CTR arrays;
// exactness is asserted against it (and the compiled reference binary) in
// tests/test_nongg.py.
//
// Scope: PACKSIZE <= 32 (word fits u64, suffix lanes s_hi are all zero).
// The PACKSIZE=64 path stays in Python (rare, and host-bound anyway).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr uint8_t kInvalid = 255;  // encode.INVALID

struct Ctr {
  const int64_t* bin_ix;
  const uint64_t* s_lo;
  const int64_t* ixs;
  int64_t suffix_bits;
  uint64_t suffix_mask;
  int64_t bad_ix;
};

// XT_getIX32 + xtSuffixBS replay (itree.c:699-730), u64 word.
inline int64_t lookup_one(const Ctr& c, uint64_t word) {
  const int64_t qpre = (int64_t)(word >> c.suffix_bits);
  const uint64_t q = word & c.suffix_mask;
  int64_t p = c.bin_ix[qpre];
  const int64_t end = c.bin_ix[qpre + 1];
  if (p >= end) return c.bad_ix;
  int64_t size = end - p - 1;
  while (size) {
    const int64_t w = size >> 1;
    if (c.s_lo[p + w + 1] <= q) {
      p += w + 1;
      size -= w + 1;
    } else {
      size = w;
    }
  }
  return c.s_lo[p] == q ? c.ixs[p] : c.bad_ix;
}

}  // namespace

extern "C" {

// One extended read (seq [+ N + revcomp]) of pre-encoded base codes ->
// shallow hit list.  Returns the number of hits written to `hits_out`
// (capacity must be >= number of windows; the caller sizes it).
int64_t utree_shallow_scan(
    const int64_t* bin_ix, const uint64_t* s_lo, const int64_t* ixs,
    int64_t suffix_bits, uint64_t suffix_mask, int64_t bad_ix,
    int64_t packsize, int64_t sparsity, int64_t word_bits, int64_t max_ix,
    const uint8_t* codes, int64_t length, int64_t* hits_out) {
  const Ctr ctr{bin_ix, s_lo, ixs, suffix_bits, suffix_mask, bad_ix};
  const int64_t k1 = packsize - 1;
  const int64_t kv = k1;
  const int64_t step = packsize / sparsity - 1;
  const uint64_t mask =
      word_bits >= 64 ? ~0ULL : ((1ULL << word_bits) - 1ULL);
  int64_t nhits = 0;
  uint64_t w = 0;
  int64_t i = kv;
  int64_t z = -4;
  while (i < length) {
    int64_t j;
    if (i < z + kv) {
      w = (w << ((i - z - 1) << 1)) & mask;
      j = z + 1;
    } else {
      w = 0;
      j = i - k1;
    }
    const int64_t p = j;
    bool broke = false;
    for (; j <= i; ++j) {
      const uint8_t c = codes[j];
      if (c > 3) {  // INVALID or any non-base code
        i += j - p;
        z = 0;
        broke = true;
        break;
      }
      w = ((w << 2) | c) & mask;
    }
    if (broke) {
      ++i;
      continue;
    }
    z = i;
    const int64_t ix = lookup_one(ctr, w);
    if (ix < max_ix) {
      hits_out[nhits++] = ix;
      i += step;
    }
    ++i;
  }
  return nhits;
}

// Batch: concatenated extended-read codes + offsets (R+1).  hits_out is
// sized sum(window counts); counts_out[r] = hits for read r, laid out
// back-to-back in read order.
void utree_shallow_scan_batch(
    const int64_t* bin_ix, const uint64_t* s_lo, const int64_t* ixs,
    int64_t suffix_bits, uint64_t suffix_mask, int64_t bad_ix,
    int64_t packsize, int64_t sparsity, int64_t word_bits, int64_t max_ix,
    const uint8_t* codes, const int64_t* offsets, int64_t num_reads,
    int64_t* hits_out, const int64_t* hit_offsets, int64_t* counts_out) {
#pragma omp parallel for schedule(dynamic, 16)
  for (int64_t r = 0; r < num_reads; ++r) {
    counts_out[r] = utree_shallow_scan(
        bin_ix, s_lo, ixs, suffix_bits, suffix_mask, bad_ix, packsize,
        sparsity, word_bits, max_ix, codes + offsets[r],
        offsets[r + 1] - offsets[r], hits_out + hit_offsets[r]);
  }
}

// Fused shallow search: FASTA records -> output lines in one call.
//
// The reference's rank-specific driver interleaves scan and vote per read
// (itree.c:969-1007); our previous split (native scan, Python vote +
// formatting) left ~38% of the single-core wall in the Python tail
// (VERDICT r4 item 4).  This entry does the whole per-read pipeline in C:
//   1. encode each record's sequence (+ 'N' + revcomp when do_rc), parallel;
//   2. run the literal word state machine per read (utree_shallow_scan),
//      parallel across reads;
//   3. replay XT_SHALLOWVOTE sequentially IN READ ORDER over the persistent
//      `vote_buffer` — sequential because the reference's `if (!kingsMen++)`
//      post-increment bug (itree.c:982) makes each vote read ONE slot past
//      its own hits, i.e. a slot holding the PREVIOUS read's value (or 0 on
//      fresh pages).  The caller zero-inits vote_buffer once per file and
//      passes it back every batch, so batch boundaries are invisible;
//   4. printf-format accepted lines ("%s\t%s\t%f\t%lld\n", the reference's
//      own format at itree.c:1000) into `out`.
//
// recs: int64 quads from utree_scan_fasta (name start/end, seq start/end).
// label_offsets: num_labels+1 offsets into label_pool (no terminators).
// Returns bytes written to out; -1 out too small; -3 vote_cap too small.
int64_t utree_shallow_classify_batch(
    const int64_t* bin_ix, const uint64_t* s_lo, const int64_t* ixs,
    int64_t suffix_bits, uint64_t suffix_mask, int64_t bad_ix,
    int64_t packsize, int64_t sparsity, int64_t word_bits, int64_t max_ix,
    const char* data, const int64_t* recs, int64_t first, int64_t count,
    int64_t do_rc, const char* label_pool, const int64_t* label_offsets,
    int64_t tolerance, int64_t slack, int64_t* vote_buffer, int64_t vote_cap,
    char* out, int64_t out_cap) {
  // encode tables: C2Xb (itree.c:110-121) and its complement twin — the RC
  // append maps non-ACGT to 'N' (itree.c:838-841), which encodes invalid,
  // so comp[] = 3 - code for bases, invalid otherwise.
  struct Enc {
    uint8_t code[256];
    uint8_t comp[256];
    Enc() {
      memset(code, kInvalid, sizeof(code));
      memset(comp, kInvalid, sizeof(comp));
      const char* b = "AaCcGgTt";
      for (int i = 0; i < 8; ++i) {
        code[(uint8_t)b[i]] = (uint8_t)(i / 2);
        comp[(uint8_t)b[i]] = (uint8_t)(3 - i / 2);
      }
    }
  };
  static const Enc enc;

  // per-read extended lengths + prefix offsets
  std::vector<int64_t> off(count + 1), hoff(count + 1);
  off[0] = hoff[0] = 0;
  for (int64_t r = 0; r < count; ++r) {
    const int64_t* q = recs + (first + r) * 4;
    const int64_t slen = q[3] - q[2];
    const int64_t ext = do_rc ? 2 * slen + 1 : slen;
    off[r + 1] = off[r] + ext;
    const int64_t wins = ext - (packsize - 1);
    hoff[r + 1] = hoff[r] + (wins > 0 ? wins : 0);
  }
  std::vector<uint8_t> codes(off[count] ? off[count] : 1);
  std::vector<int64_t> hits(hoff[count] ? hoff[count] : 1);
  std::vector<int64_t> counts(count ? count : 1, 0);

#pragma omp parallel for schedule(dynamic, 16)
  for (int64_t r = 0; r < count; ++r) {
    const int64_t* q = recs + (first + r) * 4;
    const char* s = data + q[2];
    const int64_t slen = q[3] - q[2];
    uint8_t* c = codes.data() + off[r];
    for (int64_t j = 0; j < slen; ++j) c[j] = enc.code[(uint8_t)s[j]];
    if (do_rc) {
      c[slen] = kInvalid;  // the 'N' spacer (itree.c:891-897)
      for (int64_t j = 0; j < slen; ++j)
        c[slen + 1 + j] = enc.comp[(uint8_t)s[slen - 1 - j]];
    }
    counts[r] = utree_shallow_scan(
        bin_ix, s_lo, ixs, suffix_bits, suffix_mask, bad_ix, packsize,
        sparsity, word_bits, max_ix, c, off[r + 1] - off[r],
        hits.data() + hoff[r]);
  }

  // sequential vote + format (XT_SHALLOWVOTE, itree.c:969-1006)
  std::vector<int64_t> tally(max_ix > 0 ? max_ix : 1, 0);
  int64_t used = 0;
  for (int64_t r = 0; r < count; ++r) {
    const int64_t n = counts[r];
    if (n == 0) continue;
    if (n + 1 > vote_cap) return -3;
    const int64_t* h = hits.data() + hoff[r];
    for (int64_t i = 0; i < n; ++i) vote_buffer[i] = h[i];
    const int64_t km = n + 1;  // the post-increment phantom slot
    for (int64_t i = 0; i < km; ++i) ++tally[vote_buffer[i]];
    int64_t most = 0, second = 0, most_ix = 0;
    for (int64_t i = 0; i < km; ++i) {
      const int64_t ix = vote_buffer[i];
      const int64_t c = tally[ix];
      if (c > most) {
        second = most;
        most_ix = ix;
        most = c;
      } else if (c > second) {
        second = c;
      }
      tally[ix] = 0;  // Hashes zeroed as read (itree.c:996)
    }
    if (most < tolerance || most < slack * second) continue;
    const double conf = 1.0 - (double)second / (double)most;
    const int64_t* q = recs + (first + r) * 4;
    const int64_t nlen = q[1] - q[0];
    const int64_t llen = label_offsets[most_ix + 1] - label_offsets[most_ix];
    if (used + nlen + llen + 40 > out_cap) return -1;
    memcpy(out + used, data + q[0], nlen);
    used += nlen;
    out[used++] = '\t';
    memcpy(out + used, label_pool + label_offsets[most_ix], llen);
    used += llen;
    used += snprintf(out + used, (size_t)(out_cap - used), "\t%f\t%lld\n",
                     conf, (long long)most);
  }
  return used;
}

}  // extern "C"
