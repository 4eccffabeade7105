// Native linearized-FASTA scanning and batch packing.
//
// The reference reads with fgets under an omp critical section
// (itree.c:867-875) and notes I/O as its own bottleneck (README.md:69).
// Here the host-side pipeline scans the whole (mmap'd) file once into a
// record table, then packs read batches straight into the padded uint8
// matrices the device consumes — no per-read Python.
//
// Build: g++ -O3 -shared -fPIC -o libutreefasta.so fasta.cpp

#include <cstdint>
#include <cstring>

extern "C" {

// Scan a linearized FASTA buffer.  Each record: header line starting '>',
// one sequence line.  Writes 4 int64 per record:
//   [0] name start (after '>'), [1] name end (first ' ' or end of line —
//       the search cuts names at the first space, itree.c:881-882),
//   [2] sequence start, [3] sequence end (trailing \r/\n excluded).
// Returns the record count, or -(position) on a malformed record.
// memchr-based: line ends found at memory bandwidth, not byte-loop speed.
int64_t utree_scan_fasta(const char* data, int64_t size, int64_t* recs,
                         int64_t max_recs) {
  int64_t pos = 0, n = 0;
  while (pos < size) {
    if (data[pos] != '>') return -(pos + 1);
    int64_t hstart = pos + 1;
    const char* hnl = (const char*)memchr(data + hstart, '\n', size - hstart);
    int64_t he = hnl ? (hnl - data) : size;
    // name ends at first space or '\r' (or line end)
    int64_t ne = he;
    const char* sp = (const char*)memchr(data + hstart, ' ', he - hstart);
    if (sp && sp - data < ne) ne = sp - data;
    const char* cr = (const char*)memchr(data + hstart, '\r', ne - hstart);
    if (cr && cr - data < ne) ne = cr - data;
    int64_t sstart = he + 1;
    if (sstart >= size) return -(pos + 1);
    const char* snl = (const char*)memchr(data + sstart, '\n', size - sstart);
    int64_t se = snl ? (snl - data) : size;
    int64_t send = se;
    if (send > sstart && data[send - 1] == '\r') --send;
    if (n >= max_recs) return -(pos + 1);
    recs[n * 4] = hstart;
    recs[n * 4 + 1] = ne;
    recs[n * 4 + 2] = sstart;
    recs[n * 4 + 3] = send;
    ++n;
    pos = se + 1;
  }
  return n;
}

// Pack records [first, first+count) into a zero-padded (count, lmax) uint8
// matrix + lengths, and emit a '\0'-separated name pool + offsets for the
// vote formatter.  Sequences longer than lmax are an error (-1) — the caller
// routes long reads separately.  Returns bytes used in name_pool.
int64_t utree_pack_batch(const char* data, const int64_t* recs, int64_t first,
                         int64_t count, int64_t lmax, uint8_t* reads,
                         int32_t* lens, char* name_pool, int64_t name_cap,
                         int64_t* name_offsets) {
  memset(reads, 0, (size_t)count * lmax);
  int64_t bad = 0;
#pragma omp parallel for schedule(static) reduction(| : bad)
  for (int64_t i = 0; i < count; ++i) {
    const int64_t* r = recs + (first + i) * 4;
    int64_t slen = r[3] - r[2];
    if (slen > lmax) {
      bad |= 1;
      continue;
    }
    memcpy(reads + i * lmax, data + r[2], slen);
    lens[i] = (int32_t)slen;
  }
  if (bad) return -1;
  int64_t np_used = 0;
  for (int64_t i = 0; i < count; ++i) {
    const int64_t* r = recs + (first + i) * 4;
    int64_t nlen = r[1] - r[0];
    if (np_used + nlen + 1 > name_cap) return -2;
    name_offsets[i] = np_used;
    memcpy(name_pool + np_used, data + r[0], nlen);
    np_used += nlen;
    name_pool[np_used++] = '\0';
  }
  name_offsets[count] = np_used;
  return np_used;
}

// 2-bit pack records [first, first+count) directly: `packed` (count, lmax/4)
// MSB-first 2-bit codes, `vbits` (count, lmax/8) MSB-first validity bits
// (1 = ACGT) — bit-identical to the Python pack_reads_host so the device
// decode is unchanged.  lmax must be a multiple of 8.  Returns name-pool
// bytes used, -1 on an over-long sequence, -2 on name-pool overflow.
int64_t utree_pack_batch_2bit(const char* data, const int64_t* recs,
                              int64_t first, int64_t count, int64_t lmax,
                              uint8_t* packed, uint8_t* vbits, int32_t* lens,
                              char* name_pool, int64_t name_cap,
                              int64_t* name_offsets) {
  // thread-safe lazy init ("magic static", C++11): the packer may be called
  // from multiple host threads concurrently.  Pair tables process 2 chars
  // per load: code2[c0<<8|c1] = code[c0]<<2 | code[c1] (and valid bits).
  struct Tables {
    uint8_t code2[65536];
    uint8_t valid2[65536];
    Tables() {
      uint8_t code[256], valid[256];
      memset(code, 0, sizeof(code));
      memset(valid, 0, sizeof(valid));
      const char* bases = "AaCcGgTt";
      for (int i = 0; i < 8; ++i) {
        code[(uint8_t)bases[i]] = (uint8_t)(i / 2);
        valid[(uint8_t)bases[i]] = 1;
      }
      for (int a = 0; a < 256; ++a)
        for (int b = 0; b < 256; ++b) {
          code2[(a << 8) | b] = (uint8_t)((code[a] << 2) | code[b]);
          valid2[(a << 8) | b] = (uint8_t)((valid[a] << 1) | valid[b]);
        }
    }
  };
  static const Tables t;
  const uint8_t* code2 = t.code2;
  const uint8_t* valid2 = t.valid2;
  const int64_t pb = lmax / 4, vb = lmax / 8;
  memset(packed, 0, (size_t)count * pb);
  memset(vbits, 0, (size_t)count * vb);
  int64_t bad = 0;
  // rows are independent: 2-bit packing parallelizes across the batch
#pragma omp parallel for schedule(static) reduction(| : bad)
  for (int64_t i = 0; i < count; ++i) {
    const int64_t* r = recs + (first + i) * 4;
    int64_t slen = r[3] - r[2];
    if (slen > lmax) {
      bad |= 1;
      continue;
    }
    const uint8_t* s = (const uint8_t*)data + r[2];
    uint8_t* p = packed + i * pb;
    uint8_t* v = vbits + i * vb;
    int64_t full = slen >> 3;  // whole 8-char groups -> 2 packed, 1 vbit byte
    for (int64_t g = 0; g < full; ++g) {
      const uint8_t* c = s + g * 8;
      uint16_t p01 = (uint16_t)((c[0] << 8) | c[1]);
      uint16_t p23 = (uint16_t)((c[2] << 8) | c[3]);
      uint16_t p45 = (uint16_t)((c[4] << 8) | c[5]);
      uint16_t p67 = (uint16_t)((c[6] << 8) | c[7]);
      p[g * 2] = (uint8_t)((code2[p01] << 4) | code2[p23]);
      p[g * 2 + 1] = (uint8_t)((code2[p45] << 4) | code2[p67]);
      v[g] = (uint8_t)((valid2[p01] << 6) | (valid2[p23] << 4) |
                       (valid2[p45] << 2) | valid2[p67]);
    }
    for (int64_t j = full * 8; j < slen; ++j) {  // tail chars
      uint8_t ch = s[j];
      uint8_t c1 = (uint8_t)(code2[ch] & 3);  // code2[0<<8|ch] = code[ch]
      uint8_t v1 = (uint8_t)(valid2[ch] & 1);
      p[j >> 2] |= (uint8_t)(c1 << (2 * (3 - (j & 3))));
      v[j >> 3] |= (uint8_t)(v1 << (7 - (j & 7)));
    }
    lens[i] = (int32_t)slen;
  }
  if (bad) return -1;
  int64_t np_used = 0;
  for (int64_t i = 0; i < count; ++i) {
    const int64_t* r = recs + (first + i) * 4;
    int64_t nlen = r[1] - r[0];
    if (np_used + nlen + 1 > name_cap) return -2;
    name_offsets[i] = np_used;
    memcpy(name_pool + np_used, data + r[0], nlen);
    np_used += nlen;
    name_pool[np_used++] = '\0';
  }
  name_offsets[count] = np_used;
  return np_used;
}

}  // extern "C"
