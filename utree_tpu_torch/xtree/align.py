"""XTree ALIGN (xtree.c:721-1644) — host-exact implementation; the port's
copy of `utree_tpu/xtree/align.py`.  Two changes: the constructor takes
`device` ("cuda": the k-mer front end on the GPU through kernel K9
`xtree_probe`; "cpu": its plain PyTorch version; None: the host engine,
`utree_tpu`'s `use_device=False`), and the coverage writer tallies its runs
with NumPy instead of a Python loop over every pod (same bytes).

The hot k-mer matching is vectorized NumPy (and later runs on device; the
geometry — 26-bit prefix bins + u32 suffix exact-match — is the same shape as
the utree CTR lookup).  The per-query voting, LCA interpolation, capitalist
redistribution, and the five writers replay the reference literally,
including its observable quirks:

- LBS_k reads one pod past the bin (xtree.c:177): for the last bin that byte
  range is the stringSz field — we append that sentinel pod at load;
- the per-entry taxon dedupe uses the negative-mark trick (xtree.c:1211-1214);
- a query matched at full-string level with a single taxon (h_max2 == 0) sets
  finalT but leaves MasterBin.a[H+1] = -1, so it is absent from tax-out
  (xtree.c:1238-1240 vs 1300);
- redistribution skips the first blank taxonomy string and reassigns
  MasterBin wholesale (xtree.c:1344-1398).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from utree_tpu_torch.encode import encode_bases
from utree_tpu_torch.xtree.build import XtreeDB


def binsearch_str_L(strings: list[bytes], key: bytes, key_len: int) -> int:
    """Literal replay of xtree.c:122-141 (length-limited prefix search)."""
    lo, hi = 0, len(strings)
    while lo < hi:
        mid = lo + ((hi - lo) >> 1)
        ref = strings[mid]
        i = 0
        while i < key_len and i < len(ref):
            if key[i] != ref[i]:
                break
            i += 1
        if i == key_len and i < len(ref):
            cmp = -1
        else:
            kc = key[i] if i < len(key) else 0
            rc = ref[i] if i < len(ref) else 0
            cmp = kc - rc
        if cmp > 0:
            lo = mid + 1
        elif cmp < 0:
            hi = mid
        else:
            return mid
    return lo


def build_lbins(strings: list[bytes]) -> list[np.ndarray]:
    """Per-level ancestor table (xtree.c:843-856): LBins[lv][i] = index of the
    first string strictly extending i's prefix up to its (lv+1)-th ';'."""
    levels: list[np.ndarray] = []
    n = len(strings)
    for i, s in enumerate(strings):
        lv = 0
        pos = -1
        while True:
            pos = s.find(b";", pos + 1)
            if pos < 0:
                break
            find = binsearch_str_L(strings, s, pos)
            if lv >= len(levels):
                levels.append(np.full(n, -1, np.int64))
            levels[lv][i] = find
            lv += 1
    return levels


@dataclasses.dataclass
class AlignOptions:
    confidence: float = 0.33
    n_uniq_matches: int = 0
    do_full_lca: bool = True
    do_redist: bool = False
    do_fast_redist: bool = False
    perq_out: str | None = None
    ref_out: str | None = None
    tax_out: str | None = None
    cov_out: str | None = None
    orthog_out: str | None = None


class XtreeAligner:
    #: queries per vectorized tally chunk (the hot loops run flat across a
    #: whole chunk; per-query Python work is O(1) string formatting)
    chunk_queries: int = 8192

    def __init__(self, db: XtreeDB, device: str | None = "cuda"):
        self.db = db
        self.k = db.pl + db.sl
        self.pl = db.pl
        self.sl = db.sl
        n = db.num_kmers
        # sentinel pod past the end: LBS_k may read KGrid[numK], whose bytes
        # in the mmap'd file are the u64 ref-string-pool size (xtree.c:177)
        pool_sz = sum(len(x) + 1 for x in db.ref_names)
        self.sfx = np.concatenate([db.sfx.astype(np.int64), [pool_sz & 0xFFFFFFFF]])
        self.rix = np.concatenate([db.rix.astype(np.int64), [pool_sz >> 32]])
        self.bins = db.bin_offsets.astype(np.int64)
        # run_end[j]: end of the equal-suffix run containing pod j, within its bin
        bin_of = np.searchsorted(self.bins, np.arange(n), side="right") - 1
        brk = np.ones(n + 1, bool)
        if n > 1:
            brk[1:n] = (self.sfx[1:n] != self.sfx[: n - 1]) | (bin_of[1:] != bin_of[:-1])
        ends = np.flatnonzero(brk)
        self.run_end = np.repeat(ends[1:], np.diff(ends))
        # sentinel seed (pod n) has no run data; empty run keeps the batch
        # expansion in-bounds (the scalar replay would index out of range,
        # i.e. the case never occurs on real DBs)
        self.run_end_ext = np.concatenate([self.run_end, [n]]).astype(np.int64)
        self.h_strings = db.h_strings
        self.h_pairs = db.h_pairs
        self.n_uniq_h = (len(db.h_strings[0]), len(db.h_strings[1]))
        self.lbins = (
            build_lbins(db.h_strings[0]) if db.h_strings[0] else [],
            build_lbins(db.h_strings[1]) if db.h_strings[1] else [],
        )
        self._dev_step = None
        if device is not None:
            from utree_tpu_torch.xtree.device import (build_xtree_device_index,
                                                      make_device_step)

            self._dev_index = build_xtree_device_index(db, self.sfx, self.bins,
                                                       device)
            self._dev_step = make_device_step(self._dev_index)
        # C++ engine (csrc/host/xtree.cpp): scan twin of _batch_hits (device
        # front end replaces it when a device is given) and tally twins of
        # _batch_ref_tally/_batch_h_tally (used in both modes); NumPy stays
        # the spec twin (a test selects it with `_xt_lib = None`).  A failed
        # g++ build raises: the port takes no fallback.
        from utree_tpu_torch.native import xtree_lib

        self._xt_lib = xtree_lib()
        self._pq_pools = None
        # cached inputs for the fused native deep call: int64 hmaps and
        # row-major (L, Hn) lbins stacks per hierarchy
        packs = []
        for h in range(2):
            if self.h_strings[h]:
                hm = np.ascontiguousarray(self.h_pairs[h], np.int64)
                lv = self.lbins[h]
                lb = (np.ascontiguousarray(np.vstack(lv), np.int64)
                      if lv else None)
                packs += [hm, self.n_uniq_h[h], lb, len(lv)]
            else:
                packs += [None, 0, None, 0]
        packs += [1 if self.h_strings[0] else 0, 1 if self.h_strings[1] else 0]
        self._deep_pack = tuple(packs)

    def _perq_pools(self):
        """StringPools for the native perq formatter (built once per DB)."""
        if self._pq_pools is None:
            from utree_tpu_torch.native import StringPool

            self._pq_pools = (StringPool(self.db.ref_names),
                              StringPool(self.h_strings[0]),
                              StringPool(self.h_strings[1]))
        return self._pq_pools

    # ---- k-mer matching (vectorized; both strands at every valid window) ----

    def query_hits(self, seq: bytes):
        """All (prefix_bin, seed_pod) pairs in scan order: per position,
        forward then RC (xtree.c:1024-1081).  Misses skipped."""
        codes = encode_bases(seq).astype(np.int64)
        n = len(codes)
        k, pl, sl = self.k, self.pl, self.sl
        if n < k:
            return np.zeros(0, np.int64), np.zeros(0, np.int64), 0
        valid = codes <= 3
        inv = np.concatenate(([0], np.cumsum(~valid).astype(np.int64)))
        xs = np.arange(0, n - k + 1)
        ok = (inv[xs + k] - inv[xs]) == 0
        xs = xs[ok]
        if len(xs) == 0:
            return np.zeros(0, np.int64), np.zeros(0, np.int64), 0
        cc = np.where(valid, codes, 0)
        rc = 3 - cc
        pre_f = np.zeros(len(xs), np.int64)
        for j in range(pl):
            pre_f = (pre_f << 2) | cc[xs + j]
        suf_f = np.zeros(len(xs), np.int64)
        for j in range(pl, k):
            suf_f = (suf_f << 2) | cc[xs + j]
        # RC: prefix = revcomp of last PL bases; suffix = revcomp of first SL
        pre_r = np.zeros(len(xs), np.int64)
        for j in range(k - 1, sl - 1, -1):
            pre_r = (pre_r << 2) | rc[xs + j]
        suf_r = np.zeros(len(xs), np.int64)
        for j in range(sl - 1, -1, -1):
            suf_r = (suf_r << 2) | rc[xs + j]

        seeds_f = self._lookup(pre_f, suf_f)
        seeds_r = self._lookup(pre_r, suf_r)
        # interleave in scan order: fwd(x) then rc(x)
        pre_all = np.stack([pre_f, pre_r], axis=1).reshape(-1)
        seed_all = np.stack([seeds_f, seeds_r], axis=1).reshape(-1)
        hit = seed_all >= 0
        return pre_all[hit], seed_all[hit], len(xs)

    def _lookup(self, pre: np.ndarray, suf: np.ndarray) -> np.ndarray:
        """LBS_k lower bound per bin (xtree.c:170-178); -1 = miss.

        Masked data-parallel bisection: most 26-bit prefix bins are EMPTY
        (those lanes exit after zero iterations), so the loop runs only
        log2(max bin size) passes — measured ~6x faster than one global
        searchsorted over (bin, suffix) keys, which pays log2(num_pods)
        steps on every lane."""
        lo = self.bins[pre]
        hi = self.bins[pre + 1]
        empty = lo >= hi
        l, r = lo.copy(), hi.copy()
        while (l < r).any():
            m = (l + r) >> 1
            go = l < r
            lt = self.sfx[np.minimum(m, len(self.sfx) - 1)] < suf
            l = np.where(go & lt, m + 1, l)
            r = np.where(go & ~lt, m, r)
        # the C checks KP[L] even when L == bin size (reads next bin/sentinel)
        found = (~empty) & (self.sfx[np.minimum(l, len(self.sfx) - 1)] == suf)
        return np.where(found, l, -1)

    # ---- batch (vectorized) engine ----------------------------------------
    # The per-seed dict loops below (_ref_tally/_h_tally/_max2) are the
    # exactness spec, replaying xtree.c literally; these flat NumPy versions
    # produce identical tallies for a whole chunk of queries at once (the
    # data-parallel re-design of the OpenMP hot loop, xtree.c:1002-1120).
    # Order-dependence notes:
    #   * _max2/_h_max2 tie-break = smallest id among max-count entries and
    #     mx2 = second-largest count WITH multiplicity -> order-independent;
    #   * aufbau's lwin and the redistribution candidate lists follow dict
    #     INSERTION order = first-encounter order in scan order, so the
    #     batch forms carry a first-occurrence flat index per (query, taxon).

    def _batch_hits(self, seqs: list[bytes]):
        """Seed hits for a chunk: (qid, prefix, seed) int64 arrays in
        per-query scan order (position asc, fwd before rc, xtree.c:1024-1081);
        the probed prefix bounds the vote expansion (hardstop)."""
        k, pl, sl = self.k, self.pl, self.sl
        Q = len(seqs)
        lens = np.fromiter((len(s) for s in seqs), np.int64, Q)
        starts = np.concatenate(([0], np.cumsum(lens)))
        codes = encode_bases(b"".join(seqs)).astype(np.int64)
        valid = codes <= 3
        inv = np.concatenate(([0], np.cumsum(~valid).astype(np.int64)))
        cc = np.where(valid, codes, 0)
        rc = 3 - cc
        wn = np.maximum(lens - k + 1, 0)
        tot = int(wn.sum())
        empty = (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, np.int64))
        if tot == 0:
            return empty
        qid_x = np.repeat(np.arange(Q), wn)
        cw = np.cumsum(wn) - wn
        xs = np.arange(tot) - cw[qid_x] + starts[qid_x]
        ok = (inv[xs + k] - inv[xs]) == 0
        xs, qid_x = xs[ok], qid_x[ok]
        if len(xs) == 0:
            return empty
        # doubling pyramids: k gathers/word -> log2(k) contiguous combines +
        # ~3 gathers/word.  W[t][i] = word of codes[i : i+2^t] read forward;
        # R[t][i] = word of rc[i : i+2^t] read REVERSED (high bits = last
        # base) — the reference's rolling encode (xtree.c:1002-1030), made
        # data-parallel.
        top = max(pl, sl).bit_length()
        N = len(cc)
        W = [cc]
        R = [rc]
        for t in range(1, top):
            h = 1 << (t - 1)
            w = np.zeros(N, np.int64)
            r = np.zeros(N, np.int64)
            np.left_shift(W[-1][: N - h], 2 * h, out=w[: N - h])
            w[: N - h] |= W[-1][h:]
            np.left_shift(R[-1][h:], 2 * h, out=r[: N - h])
            r[: N - h] |= R[-1][: N - h]
            W.append(w)
            R.append(r)

        def fwd(L, base):
            w = np.zeros(len(xs), np.int64)
            off = 0
            for t in range(top - 1, -1, -1):
                if (L >> t) & 1:
                    w = (w << (2 << t)) | W[t][xs + base + off]
                    off += 1 << t
            return w

        def rev(L, base):
            w = np.zeros(len(xs), np.int64)
            off = 0
            for t in range(top):
                if (L >> t) & 1:
                    w |= R[t][xs + base + off] << (2 * off)
                    off += 1 << t
            return w

        pre_f = fwd(pl, 0)
        suf_f = fwd(sl, pl)
        pre_r = rev(pl, sl)
        suf_r = rev(sl, 0)
        seeds_f = self._lookup(pre_f, suf_f)
        seeds_r = self._lookup(pre_r, suf_r)
        seed_all = np.stack([seeds_f, seeds_r], axis=1).reshape(-1)
        pre_all = np.stack([pre_f, pre_r], axis=1).reshape(-1)
        qid_all = np.repeat(qid_x, 2)
        hit = seed_all >= 0
        return qid_all[hit], pre_all[hit], seed_all[hit]

    def _batch_hits_device(self, seqs: list[bytes]):
        """Device front end: identical (qid, prefix, seed) hit arrays to
        _batch_hits, computed by `xtree.device.xtree_step` (K9 on the GPU,
        its plain version on the CPU).  Batch rows pad to the chunk size and
        lengths bucket to multiples of 64, as `utree_tpu` bounds its jit
        shapes, so both packages probe the same matrices."""
        import torch

        from utree_tpu_torch.pipeline import _bucket_len64

        Q = len(seqs)
        k = self.k
        maxlen = max(max((len(s) for s in seqs), default=k), k)
        lmax = _bucket_len64(maxlen)
        b = self.chunk_queries if Q <= self.chunk_queries else Q
        reads = np.zeros((b, lmax), np.uint8)
        lens = np.zeros(b, np.int32)
        for i, s in enumerate(seqs):
            reads[i, : len(s)] = np.frombuffer(s, np.uint8)
            lens[i] = len(s)
        dev = self._dev_index.device
        out = self._dev_step(self.tables, torch.from_numpy(reads).to(dev),
                             torch.from_numpy(lens).to(dev))
        sf, sr, pf, pr = (t[:Q].cpu().numpy() for t in out)
        w = sf.shape[1]
        # scan order: position ascending, forward before RC (xtree.c:1024-1081)
        seed2 = np.stack([sf, sr], axis=2).reshape(Q, 2 * w)
        pre2 = np.stack([pf, pr], axis=2).reshape(Q, 2 * w)
        qid_all, col = np.nonzero(seed2 >= 0)
        return (qid_all.astype(np.int64), pre2[qid_all, col].astype(np.int64),
                seed2[qid_all, col].astype(np.int64))

    @property
    def tables(self):
        return self._dev_index.tables

    def _expand(self, seeds: np.ndarray, pres: np.ndarray):
        """CSR expansion of equal-suffix runs: per seed entry s probed in
        prefix bin p, the pods [s, min(run_end(s), bins[p+1])) — the C
        clamps every expansion at the PROBED bin's end (hardstop,
        xtree.c:1108), so a one-past LBS_k hit expands to an EMPTY run.
        Returns (sid, off, j): entry id, offset in run, global pod index."""
        L = np.maximum(
            np.minimum(self.run_end_ext[seeds], self.bins[pres + 1]) - seeds, 0)
        tot = int(L.sum())
        sid = np.repeat(np.arange(len(seeds)), L)
        cs = np.cumsum(L) - L
        off = np.arange(tot) - cs[sid]
        j = seeds[sid] + off
        return sid, off, j

    @staticmethod
    def _group_minmax(qv, cv, tiev, Q):
        """Per-query (mx, mx2, widx) from (query, count, tiebreak) triples:
        mx = max count; mx2 = second-largest count WITH multiplicity; widx =
        index (into the input arrays) of the entry with min tiebreak among
        count == mx, or -1 when the query has no entries."""
        mx = np.zeros(Q, np.int64)
        mx2 = np.zeros(Q, np.int64)
        widx = np.full(Q, -1, np.int64)
        if len(qv) == 0:
            return mx, mx2, widx
        order = np.lexsort((tiev, -cv, qv))
        qs = qv[order]
        s0 = np.searchsorted(qs, np.arange(Q), "left")
        s1 = np.searchsorted(qs, np.arange(Q), "right")
        has = s1 > s0
        i0 = np.minimum(s0, len(qs) - 1)
        csorted = cv[order]
        mx = np.where(has, csorted[i0], 0)
        widx = np.where(has, order[i0], -1)
        i1 = np.minimum(s0 + 1, len(qs) - 1)
        mx2 = np.where(s1 - s0 >= 2, csorted[i1], 0)
        return mx, mx2, widx

    def _batch_ref_tally_native(self, qid_h, pres_h, seeds_h, Q):
        """C++ _batch_ref_tally (native/xtree.cpp): same contract minus the
        flat expansion arrays (sid/j/rx), which only the coverage pass needs
        — cov_out keeps the NumPy path."""
        from utree_tpu_torch.native import xt_ref_tally

        R = self.db.num_refs
        mx, mx2, mix, qu, rxu, counts, first, _nd = xt_ref_tally(
            self._xt_lib, qid_h, pres_h, seeds_h, self.bins,
            self.run_end_ext, self.rix, Q, R)

        class RT:
            pass

        rt = RT()
        rt.R, rt.qu, rt.rxu, rt.counts, rt.first = R, qu, rxu, counts, first
        rt.uniq = qu * R + rxu
        return mx, mx2, mix, rt

    def _batch_ref_tally(self, qid_h, pres_h, seeds_h, Q):
        """Vectorized _ref_tally + _max2.  Returns (mx, mx2, mix, rt) where
        rt holds the per-(query, ref) CSR (sorted by key), the insertion-order
        key `first`, and the run expansion for the coverage pass."""
        R = self.db.num_refs
        sid, off, j = self._expand(seeds_h, pres_h)
        rx = self.rix[j]
        keep = (off == 0) | (rx != self.rix[j - 1])  # consecutive in-run dedupe
        kidx = np.flatnonzero(keep)
        key = qid_h[sid[kidx]] * R + rx[kidx]
        uniq, first, counts = np.unique(key, return_index=True, return_counts=True)
        qu = uniq // R
        rxu = uniq - qu * R
        mx, mx2, widx = self._group_minmax(qu, counts, rxu, Q)
        mix = np.where(widx >= 0, rxu[np.maximum(widx, 0)], -1)

        class RT:
            pass

        rt = RT()
        rt.R, rt.qu, rt.rxu, rt.counts, rt.uniq = R, qu, rxu, counts, uniq
        rt.first = kidx[first]  # flat index = dict-insertion order key
        rt.sid, rt.j, rt.rx = sid, j, rx
        return mx, mx2, mix, rt

    def _batch_h_tally(self, qid_h, pres_h, seeds_h, hmap, Hn, Q, lbin=None):
        """Vectorized _h_tally (lbin=None) / _h_tally_lbins: counts per
        (query, taxon) with per-seed-entry dedupe.  Returns (q2, h2, c2,
        ins2) where ins2 is the global first-encounter flat index — the dict
        insertion-order key."""
        if self._xt_lib is not None:
            from utree_tpu_torch.native import xt_h_tally

            return xt_h_tally(
                self._xt_lib, qid_h, pres_h, seeds_h, self.bins,
                self.run_end_ext, self.rix,
                np.ascontiguousarray(hmap, np.int64), Hn, Q,
                None if lbin is None else np.ascontiguousarray(lbin, np.int64))
        sid, off, j = self._expand(seeds_h, pres_h)
        h = hmap[self.rix[j]]
        if lbin is not None:
            h = lbin[h]
            m = np.flatnonzero(h != -1)
        else:
            m = np.arange(len(h), dtype=np.int64)
        z = np.zeros(0, np.int64)
        if len(m) == 0:
            return z, z, z, z
        key1 = sid[m] * Hn + h[m]
        u1, f1 = np.unique(key1, return_index=True)  # per-entry taxon dedupe
        sid1 = u1 // Hn
        h1 = u1 - sid1 * Hn
        ins1 = m[f1]  # first flat occurrence per (entry, taxon)
        key2 = qid_h[sid1] * Hn + h1
        # u1 is sorted by (sid, taxon), so key2's first occurrence of a
        # (query, taxon) is its smallest sid -> ins1 there is the global
        # first-encounter index (flat order increases with sid)
        u2, i2, c2 = np.unique(key2, return_index=True, return_counts=True)
        q2 = u2 // Hn
        h2 = u2 - q2 * Hn
        ins2 = ins1[i2]
        return q2, h2, c2, ins2

    @staticmethod
    def _group_lists(qv, vals, inskey, Q):
        """Per-query Python lists of `vals` in insertion order (for the
        redistribution candidate bins)."""
        o = np.lexsort((inskey, qv))
        qs = qv[o]
        vs = vals[o]
        bounds = np.searchsorted(qs, np.arange(Q + 1))
        return [vs[bounds[q]:bounds[q + 1]].tolist() for q in range(Q)]

    # ---- per-query voting -------------------------------------------------

    def _ref_tally(self, seeds: np.ndarray, pres: np.ndarray):
        """Distinct-ref counts per query (xtree.c:1104-1120): per SBin entry,
        expand the equal-suffix run (clamped at the probed bin's hardstop),
        counting each ref once per CONSECUTIVE occurrence (in-ref copies
        dedupe via prev_rix)."""
        rbin: dict[int, int] = {}
        for s, p in zip(seeds, pres):
            prev = -1
            for j in range(s, min(self.run_end[s], self.bins[p + 1])):
                rx = int(self.rix[j])
                if rx == prev:
                    continue
                rbin[rx] = rbin.get(rx, 0) + 1
                prev = rx
        return rbin

    @staticmethod
    def _max2(rbin: dict[int, int]):
        """max/max2 with the smaller-rix tie-break (xtree.c:1131-1138).
        maxRix starts at (rix_t)-1, so the tie compare is unsigned with
        UINT_MAX as the initial value."""
        mx = mx2 = 0
        mix = 0xFFFFFFFF
        for rx, c in rbin.items():
            if c > mx or (c == mx and rx < mix):
                mx2, mx, mix = mx, c, rx
            elif c > mx2:
                mx2 = c
        return mx, mx2, (-1 if mix == 0xFFFFFFFF else mix)

    def _h_tally(self, seeds: np.ndarray, pres: np.ndarray, hmap: np.ndarray):
        """Per-entry-deduped taxon counts (the sign trick, xtree.c:1200-1215):
        each SBin entry contributes at most 1 to each taxon."""
        hbin: dict[int, int] = {}
        for s, p in zip(seeds, pres):
            seen = set()
            for j in range(s, min(self.run_end[s], self.bins[p + 1])):
                h = int(hmap[int(self.rix[j])])
                if h not in seen:
                    seen.add(h)
                    hbin[h] = hbin.get(h, 0) + 1
        return hbin

    def _h_tally_lbins(self, seeds: np.ndarray, pres: np.ndarray,
                       hmap: np.ndarray, lbin: np.ndarray):
        hbin: dict[int, int] = {}
        for s, p in zip(seeds, pres):
            seen = set()
            for j in range(s, min(self.run_end[s], self.bins[p + 1])):
                h = int(hmap[int(self.rix[j])])
                f = int(lbin[h])
                if f == -1:
                    continue
                if f not in seen:
                    seen.add(f)
                    hbin[f] = hbin.get(f, 0) + 1
        return hbin

    @staticmethod
    def _h_max2(hbin: dict[int, int]):
        """h_max tie-break (xtree.c:1221): `rix < h_maxIx1` where h_maxIx1 is
        int32 -1 but rix is uint32 — usual conversions make the compare
        unsigned, so -1 acts as UINT_MAX and the first candidate wins."""
        mx = mx2 = 0
        mix = 0xFFFFFFFF
        for h, c in hbin.items():
            if c > mx or (c == mx and h < mix):
                mx2 = mx
                mx, mix = c, h
            elif c > mx2:
                mx2 = c
        return mx, mx2, (-1 if mix == 0xFFFFFFFF else mix)

    # ---- align a query file ---------------------------------------------------

    def align_file(self, reads_path: str, opts: AlignOptions):
        """Batch engine: queries stream in chunks, tallies run flat across
        each chunk (NumPy), and only O(1) branch/format work per query stays
        in Python.  Output bytes identical to align_file_scalar (property- and
        golden-tested)."""
        from utree_tpu_torch.xtree.io import iter_queries

        db = self.db
        results: list[list[int]] = []
        cbins = ([], [], [])
        perq_lines = [] if opts.perq_out else None
        query_aligns = np.zeros(db.num_kmers + 1, np.int64)
        full_query_aligns = np.zeros(db.num_refs, np.int64)

        # fast path: read the whole file (gz-decoded), scan records in C
        # once, and hand each chunk [start, end) spans into the buffer —
        # no per-query Python objects at all.  stdin keeps the iterator.
        data = None
        if self._xt_lib is not None and reads_path != "-":
            try:
                with open(reads_path, "rb") as f:
                    data = f.read()
                if str(reads_path).endswith(".gz"):
                    import gzip

                    data = gzip.decompress(data)
            except OSError:
                data = None
        if data is not None:
            from utree_tpu_torch.native import xt_scan_queries

            recs = xt_scan_queries(self._xt_lib, data)
            for f0 in range(0, len(recs), self.chunk_queries):
                self._align_chunk(
                    None, None, opts, results, cbins, perq_lines,
                    query_aligns, full_query_aligns,
                    spans=(data, recs[f0:f0 + self.chunk_queries]))
        else:
            heads: list[bytes] = []
            seqs: list[bytes] = []
            for qhed, seq in iter_queries(reads_path):
                heads.append(qhed)
                seqs.append(seq)
                if len(seqs) >= self.chunk_queries:
                    self._align_chunk(heads, seqs, opts, results, cbins,
                                      perq_lines, query_aligns,
                                      full_query_aligns)
                    heads, seqs = [], []
            if seqs:
                self._align_chunk(heads, seqs, opts, results, cbins,
                                  perq_lines, query_aligns, full_query_aligns)

        master = np.array(results, np.int64) if results else np.zeros((0, 3), np.int64)
        if opts.do_redist:
            self._redistribute(master, cbins, opts)
        self._write_outputs(master, opts, perq_lines, query_aligns, full_query_aligns)
        return master

    def _align_chunk(self, heads, seqs, opts, results, cbins, perq_lines,
                     query_aligns, full_query_aligns, spans=None):
        if spans is not None:
            data, recs = spans
            Q = len(recs)
            if self._dev_step is not None or self._xt_lib is None:
                seqs = [bytes(data[int(a):int(b)]) for a, b in recs[:, 2:4]]
        else:
            Q = len(seqs)
        nuh = self.n_uniq_h
        conf = opts.confidence
        fused = (self._dev_step is None and self._xt_lib is not None
                 and not opts.cov_out and not opts.do_redist)
        if fused:
            # fast path: scan + ref vote fused per query in one C pass (the
            # CSR only cov/redist read is never built)
            from utree_tpu_torch.native import xt_scan_hits_tally

            if spans is not None:
                pool, qs, qe = data, recs[:, 2], recs[:, 3]
            else:
                offsets = np.zeros(Q + 1, np.int64)
                np.cumsum([len(s) for s in seqs], out=offsets[1:])
                pool, qs, qe = b"".join(seqs), offsets[:-1], offsets[1:]
            qid_h, pres_h, seeds_h, tix, mx, mx2, mix = xt_scan_hits_tally(
                self._xt_lib, pool, qs, qe, self.k, self.pl, self.bins,
                self.sfx, self.run_end_ext, self.rix, self.db.num_refs)
            rt = None
        elif self._dev_step is not None:
            qid_h, pres_h, seeds_h = self._batch_hits_device(seqs)
        elif self._xt_lib is not None:
            from utree_tpu_torch.native import xt_scan_hits

            if spans is not None:
                qid_h, pres_h, seeds_h = xt_scan_hits(
                    self._xt_lib, data, recs[:, 2], recs[:, 3], self.k,
                    self.pl, self.bins, self.sfx)
            else:
                offsets = np.zeros(Q + 1, np.int64)
                np.cumsum([len(s) for s in seqs], out=offsets[1:])
                qid_h, pres_h, seeds_h = xt_scan_hits(
                    self._xt_lib, b"".join(seqs), offsets[:-1], offsets[1:],
                    self.k, self.pl, self.bins, self.sfx)
        else:
            qid_h, pres_h, seeds_h = self._batch_hits(seqs)
        if not fused:
            tix = np.bincount(qid_h, minlength=Q).astype(np.int64)
            if self._xt_lib is not None and not opts.cov_out:
                mx, mx2, mix, rt = self._batch_ref_tally_native(
                    qid_h, pres_h, seeds_h, Q)
            else:
                mx, mx2, mix, rt = self._batch_ref_tally(qid_h, pres_h,
                                                         seeds_h, Q)
        matched = (tix > 0) & (mix != -1) & (mx >= opts.n_uniq_matches)

        if opts.cov_out:
            # query_aligns[s] += 1 per run entry (NOT deduped) whose ref is at
            # max count (seed index, not pod — xtree.c:1158)
            cnt_flat = rt.counts[np.searchsorted(rt.uniq, qid_h[rt.sid] * rt.R + rt.rx)]
            hot = (cnt_flat == mx[qid_h[rt.sid]]) & matched[qid_h[rt.sid]]
            np.add.at(query_aligns, seeds_h[rt.sid[hot]], 1)
            um = (rt.counts == mx[rt.qu]) & matched[rt.qu]
            np.add.at(full_query_aligns, rt.rxu[um], 1)

        cand0 = cand1 = cand2 = None
        if opts.do_redist:
            sel = np.flatnonzero((rt.counts == mx[rt.qu]) & matched[rt.qu])
            cand0 = self._group_lists(rt.qu[sel], rt.rxu[sel], rt.first[sel], Q)
            cand1 = [[] for _ in range(Q)]
            cand2 = [[] for _ in range(Q)]

        frac = mx / np.maximum(tix, 1)
        early = matched & ((mx2 == 0) | ((mx > mx2) & (frac >= conf)))
        deep = np.flatnonzero(matched & ~early)

        mb = np.full((Q, 3), -1, np.int64)
        mb[matched, 0] = mix[matched]
        # perq taxonomy per query: (string index, level); ix -1 = empty
        ft_ix = np.full((Q, 2), -1, np.int64)
        ft_lv = np.zeros((Q, 2), np.int64)  # 0 = full string, >0 = cut level

        e = np.flatnonzero(early)
        for h in range(2):
            if self.h_strings[h]:
                hp = self.h_pairs[h][mix[e]].astype(np.int64)
                ft_ix[e, h] = hp
                if opts.tax_out:
                    mb[e, h + 1] = hp
                if opts.do_redist:
                    cl = (cand1, cand2)[h]
                    for q, t in zip(e, hp):
                        cl[q].append(int(t))

        if len(deep) and self._xt_lib is not None and not opts.do_redist:
            # fused native deep call: full tally + level walk per query in
            # one C pass (no per-level subsetting/tally round trips); the
            # redistribution path needs per-level candidate lists, so it
            # keeps the NumPy block below
            from utree_tpu_torch.native import xt_deep_call

            qstart = np.searchsorted(qid_h, np.arange(Q + 1)).astype(np.int64)
            xt_deep_call(self._xt_lib, deep, qstart, pres_h, seeds_h,
                         self.bins, self.run_end_ext, self.rix,
                         self._deep_pack, tix, conf, opts.do_full_lca,
                         bool(opts.tax_out), ft_ix, ft_lv, mb)
        elif len(deep):
            inq = np.zeros(Q, bool)
            inq[deep] = True
            sub = inq[qid_h]
            qid_sub = qid_h[sub]
            pres_sub = pres_h[sub]
            seeds_sub = seeds_h[sub]
            for h in range(2):
                if not self.h_strings[h]:
                    break
                Hn = nuh[h]
                q2, h2, c2, ins2 = self._batch_h_tally(
                    qid_sub, pres_sub, seeds_sub, self.h_pairs[h], Hn, Q)
                hmx, hmx2, hwidx = self._group_minmax(q2, c2, h2, Q)
                hmix = np.where(hwidx >= 0, h2[np.maximum(hwidx, 0)], -1)
                if opts.do_redist:
                    sel = np.flatnonzero(c2 == hmx[q2])
                    glists = self._group_lists(q2[sel], h2[sel], ins2[sel], Q)
                    cl = (cand1, cand2)[h]
                    for q in deep:
                        cl[q].extend(glists[q])
                shallow = (hmx2[deep] == 0) | (
                    (not opts.do_full_lca)
                    & (hmx[deep] > hmx2[deep])
                    & (hmx[deep] / np.maximum(tix[deep], 1) >= conf))
                sq = deep[shallow]
                ft_ix[sq, h] = hmix[sq]
                d2 = deep[~shallow]
                if len(d2):
                    self._batch_aufbau(d2, qid_sub, pres_sub, seeds_sub, h, Hn,
                                       Q, tix, conf, mb, ft_ix, ft_lv, opts)

        # ---- per-query output/bookkeeping (O(1) each) ----
        if self._xt_lib is not None and not opts.do_redist:
            # batch tail: the results rows ARE mb's rows (unmatched queries
            # stay [-1,-1,-1], exactly what the scalar loop appends), and the
            # perq lines format natively (native/xtree.cpp:xt_format_perq —
            # the blob joins lines with '\n' so _write_outputs' `blob + "\n"`
            # is byte-identical to per-line writes).  cbins stays empty:
            # it is only consumed under do_redist, which takes the loop below.
            results.extend(mb.tolist())
            if perq_lines is not None:
                from utree_tpu_torch.native import xt_format_perq

                if spans is not None:
                    hp, hs, he = data, recs[:, 0], recs[:, 1]
                else:
                    ho = np.zeros(Q + 1, np.int64)
                    np.cumsum([len(h) for h in heads], out=ho[1:])
                    hp, hs, he = b"".join(heads), ho[:-1], ho[1:]
                perq_lines.append(xt_format_perq(
                    self._xt_lib, hp, hs, he, self._perq_pools(),
                    matched, mix, mx, mx2, tix, ft_ix, ft_lv))
            return
        if heads is None:  # spans fast path falling through to the Python
            heads = [bytes(data[int(a):int(b)]) for a, b in recs[:, 0:2]]
        for q in range(Q):
            if not matched[q]:
                if perq_lines is not None:
                    perq_lines.append(heads[q] + b"\tNo matches found")
                results.append([-1, -1, -1])
                for jh in range(3):
                    cbins[jh].append([])
                continue
            if perq_lines is not None:
                rn = self.db.ref_names[int(mix[q])]
                parts = []
                for h in range(2):
                    ix = int(ft_ix[q, h])
                    if ix < 0:
                        parts.append(b"")
                        continue
                    s = self.h_strings[h][ix]
                    lv = int(ft_lv[q, h])
                    if lv > 0:
                        p = -1
                        for _ in range(lv):
                            p = s.find(b";", p + 1)
                        s = s[:p] if p >= 0 else s
                    parts.append(s)
                perq_lines.append(
                    heads[q] + b"\t" + rn + b"\t[%d,%d]\t" % (int(mx[q]), int(mx2[q]))
                    + parts[0] + b"\t" + parts[1] + b"\t%d" % int(tix[q]))
            results.append(mb[q].tolist())
            cbins[0].append(cand0[q] if cand0 is not None else [])
            cbins[1].append(cand1[q] if cand1 is not None else [])
            cbins[2].append(cand2[q] if cand2 is not None else [])

    def _batch_aufbau(self, d2, qid_sub, pres_sub, seeds_sub, h, Hn, Q, tix,
                      conf, mb, ft_ix, ft_lv, opts):
        """Vectorized full-LCA walk (xtree.c:1241-1301) over the queries d2:
        per level, one flat lbins tally; winners keep the FIRST-inserted
        taxon among max-count entries (dict-order contract)."""
        ag_thres = (conf * tix[d2]).astype(np.int64)  # int() truncation
        agreed = tix[d2].copy()
        winner = np.full(len(d2), -1, np.int64)
        win_lv = np.full(len(d2), -1, np.int64)
        levels = self.lbins[h]
        thr = np.zeros(Q, np.int64)
        thr[d2] = ag_thres
        semi = 1
        active = agreed >= ag_thres
        while active.any() and semi - 1 < len(levels):
            inq = np.zeros(Q, bool)
            inq[d2[active]] = True
            sm = inq[qid_sub]
            q2, f2, c2, ins2 = self._batch_h_tally(
                qid_sub[sm], pres_sub[sm], seeds_sub[sm], self.h_pairs[h], Hn,
                Q, lbin=levels[semi - 1])
            ok = c2 >= thr[q2]  # entries below ag_thres never update lmax/lmax2
            lmx, lmx2, lwidx = self._group_minmax(q2[ok], c2[ok], ins2[ok], Q)
            lwin = np.where(lwidx >= 0, f2[ok][np.maximum(lwidx, 0)], -1)
            lmx_d = lmx[d2]
            cond = active & (lmx_d > lmx2[d2]) & (lmx_d >= ag_thres)
            agreed = np.where(active, np.where(cond, lmx_d, 0), agreed)
            winner = np.where(cond, lwin[d2], winner)
            win_lv = np.where(cond, semi, win_lv)
            active = active & (agreed >= ag_thres)
            semi += 1
        won = winner != -1
        wq = d2[won]
        ft_ix[wq, h] = winner[won]
        ft_lv[wq, h] = win_lv[won]
        if opts.tax_out:
            mb[wq, h + 1] = winner[won] + win_lv[won] * self.n_uniq_h[h]

    def align_file_scalar(self, reads_path: str, opts: AlignOptions):
        """Literal per-query replay (the exactness spec; kept as the batch
        engine's property-test twin)."""
        from utree_tpu_torch.xtree.io import iter_queries

        db = self.db
        nuh = self.n_uniq_h
        results = []  # MasterBin rows: [rix, h1, h2]
        cbins = ([], [], [])  # candidate lists per hierarchy (redistribution)
        perq_lines = [] if opts.perq_out else None
        query_aligns = np.zeros(db.num_kmers + 1, np.int64)  # QueryAligns
        full_query_aligns = np.zeros(db.num_refs, np.int64)  # FullQueryAligns
        n_queries = 0

        for qhed, seq in iter_queries(reads_path):
            n_queries += 1
            pres, seeds, _nw = self.query_hits(seq)
            tix = len(seeds)
            mb = [-1, -1, -1]
            cand = ([], [], [])
            if tix == 0:
                if perq_lines is not None:
                    perq_lines.append(qhed + b"\tNo matches found")
                results.append(mb)
                for j in range(3):
                    cbins[j].append(cand[j])
                continue

            rbin = self._ref_tally(seeds, pres)
            mx, mx2, mix = self._max2(rbin)
            if not rbin or mix == -1 or mx < opts.n_uniq_matches:
                if perq_lines is not None:
                    perq_lines.append(qhed + b"\tNo matches found")
                results.append(mb)
                for j in range(3):
                    cbins[j].append(cand[j])
                continue

            if opts.cov_out:
                for s, p in zip(seeds, pres):
                    for j in range(s, min(self.run_end[s], self.bins[p + 1])):
                        if rbin.get(int(self.rix[j]), 0) == mx:
                            query_aligns[s] += 1  # seed, not j (xtree.c:1158)
                for rx, c in rbin.items():
                    if c == mx:
                        full_query_aligns[rx] += 1
            if opts.do_redist:
                cand[0].extend(rx for rx, c in rbin.items() if c == mx)

            mb[0] = mix
            final_t = [b"", b""]
            final_l = [0xFFFF, 0xFFFF]
            if not mx2 or (mx > mx2 and mx / tix >= opts.confidence):
                # early call (xtree.c:1182-1195)
                for h in range(2):
                    if self.h_strings[h]:
                        final_t[h] = self.h_strings[h][int(self.h_pairs[h][mix])]
                if self.h_strings[0]:
                    if opts.tax_out:
                        mb[1] = int(self.h_pairs[0][mix])
                    if opts.do_redist:
                        cand[1].append(int(self.h_pairs[0][mix]))
                if self.h_strings[1]:
                    if opts.tax_out:
                        mb[2] = int(self.h_pairs[1][mix])
                    if opts.do_redist:
                        cand[2].append(int(self.h_pairs[1][mix]))
            else:
                for h in range(2):
                    if not self.h_strings[h]:
                        break
                    hbin = self._h_tally(seeds, pres, self.h_pairs[h])
                    hmx, hmx2, hmix = self._h_max2(hbin)
                    if opts.do_redist:
                        cand[h + 1].extend(t for t, c in hbin.items() if c == hmx)
                    if not hmx2 or (not opts.do_full_lca and hmx > hmx2 and hmx / tix >= opts.confidence):
                        final_t[h] = self.h_strings[h][hmix]
                    else:
                        # full aufbau over LBins levels (xtree.c:1241-1301)
                        agreed = tix
                        ag_thres = int(opts.confidence * tix)
                        winner, win_lv = -1, -1
                        semi = 1
                        while agreed >= ag_thres:
                            if semi - 1 >= len(self.lbins[h]):
                                break
                            agreed = 0
                            lb = self._h_tally_lbins(seeds, pres, self.h_pairs[h], self.lbins[h][semi - 1])
                            lmax = lmax2 = 0
                            lwin = 0
                            for t, c in lb.items():
                                if c >= ag_thres:
                                    if c > lmax:
                                        lmax2, lmax, lwin = lmax, c, t
                                    elif c > lmax2:
                                        lmax2 = c
                            if lmax > lmax2 and lmax >= ag_thres:
                                agreed, winner, win_lv = lmax, lwin, semi
                            semi += 1
                        if winner != -1:
                            if perq_lines is not None:
                                s = self.h_strings[h][winner]
                                p = -1
                                for _ in range(win_lv):
                                    p = s.find(b";", p + 1)
                                final_l[h] = p if p >= 0 else 0xFFFF
                                final_t[h] = s
                            if opts.tax_out:
                                mb[h + 1] = winner + win_lv * nuh[h]

            if perq_lines is not None:
                rn = db.ref_names[mix] if mix != -1 else b""
                t0 = final_t[0][: final_l[0]] if final_l[0] != 0xFFFF else final_t[0]
                t1 = final_t[1][: final_l[1]] if final_l[1] != 0xFFFF else final_t[1]
                perq_lines.append(
                    qhed + b"\t" + rn + b"\t[%d,%d]\t" % (mx, mx2) + t0 + b"\t" + t1
                    + b"\t%d" % tix
                )
            results.append(mb)
            for j in range(3):
                cbins[j].append(cand[j])

        master = np.array(results, np.int64) if results else np.zeros((0, 3), np.int64)
        if opts.do_redist:
            self._redistribute(master, cbins, opts)
        self._write_outputs(master, opts, perq_lines, query_aligns, full_query_aligns)
        return master

    # ---- capitalist redistribution (xtree.c:1321-1403) ----------------------

    def _redistribute(self, master: np.ndarray, cbins, opts: AlignOptions):
        """Capitalist redistribution (xtree.c:1321-1403), vectorized: the
        per-query candidate scan runs column-wise over a padded (nq, Lmax)
        matrix — each pass is Lmax vector ops instead of an nq x L Python
        loop — replaying the scan's exact pick rules (strict '>' keeps the
        FIRST max; the blank taxonomy first_ix only picks while nothing
        else has)."""
        nq = len(master)
        sizes = [self.db.num_refs if opts.ref_out else 0, self.n_uniq_h[0], self.n_uniq_h[1]]
        for i in range(3):
            if not sizes[i]:
                continue
            lists = cbins[i]
            lmax = max((len(x) for x in lists), default=0)
            cmat = np.full((nq, max(lmax, 1)), -1, np.int64)
            for q, lst in enumerate(lists):
                if lst:
                    cmat[q, : len(lst)] = lst
            first_ix = -1
            if i > 0:
                for j, s in enumerate(self.h_strings[i - 1]):
                    if not s:
                        first_ix = j
                        break
            tally = np.bincount(cmat[cmat >= 0], minlength=sizes[i]).astype(np.int64)

            def scan(tally):
                which = np.full(nq, -1, np.int64)
                mx = np.zeros(nq, np.int64)
                for col in range(cmat.shape[1]):
                    c = cmat[:, col]
                    t = np.where(c >= 0, tally[np.maximum(c, 0)], 0)
                    ok = (c >= 0) & (t > mx) & ((c != first_ix) | (which == -1))
                    mx = np.where(ok, t, mx)
                    which = np.where(ok, c, which)
                return which

            changes = -1
            conv = nq // 100000
            max_pass = 1 if opts.do_fast_redist else 100
            p = 0
            while p < max_pass and (changes == -1 or changes > conv):
                which = scan(tally)
                next_tally = np.bincount(which[which >= 0], minlength=sizes[i]).astype(np.int64)
                changes = int(np.abs(tally - next_tally).sum())
                tally = next_tally
                p += 1
            master[:, i] = scan(tally)

    # ---- writers -------------------------------------------------------------

    def _write_outputs(self, master, opts: AlignOptions, perq_lines,
                       query_aligns, full_query_aligns):
        db = self.db
        if opts.perq_out and perq_lines is not None:
            with open(opts.perq_out, "wb") as fo:
                for ln in perq_lines:
                    fo.write(ln + b"\n")
        if opts.ref_out:
            tally = np.zeros(db.num_refs, np.int64)
            for r in master[:, 0]:
                if r != -1:
                    tally[r] += 1
            with open(opts.ref_out, "wb") as fo:
                for i in range(db.num_refs):
                    if tally[i]:
                        fo.write(db.ref_names[i] + b"\t%d\n" % tally[i])
        if opts.tax_out:
            self._write_tax(master, opts.tax_out)
        if opts.orthog_out:
            self._write_orthog(master, opts.orthog_out)
        if opts.cov_out:
            self._write_cov(opts.cov_out, query_aligns, full_query_aligns)

    def _write_tax(self, master, path):
        """Tax tally with interpolation decode (xtree.c:1421-1462)."""
        with open(path, "wb") as fo:
            for h in range(2):
                col = master[:, h + 1]
                vals = col[col != -1]
                if len(vals) == 0:
                    continue
                max_h = int(vals.max())
                if max_h == 0 and not len(vals):
                    continue
                tally = np.bincount(vals, minlength=max_h + 1)
                nuh = self.n_uniq_h[h]
                lv, next_lv = 0, nuh
                for i in range(max_h + 1):
                    if not tally[i]:
                        continue
                    while i >= next_lv:
                        next_lv += nuh
                        lv += 1
                    if not lv:
                        fo.write(self.h_strings[h][i] + b"\t%d\n" % tally[i])
                    else:
                        s = self.h_strings[h][i - (next_lv - nuh)]
                        semi = 0
                        pos = 0
                        while semi < lv and pos < len(s):
                            semi += s[pos] == 0x3B
                            pos += 1
                        fo.write(s[: pos - 1] + b"\t%d\n" % tally[i])

    def _write_orthog(self, master, path):
        """Orthogonal (H1,H2) cross-tab (xtree.c:1464-1535), replayed literally
        including the run-length commit quirk that drops/miscounts the last
        element of each hash bucket."""
        prime = 4969
        rows = [q for q in range(len(master)) if master[q, 0] != -1]
        buckets: dict[int, list[int]] = {}
        for q in rows:
            h1 = master[q, 1] & 0xFFFFFFFF
            h2 = master[q, 2] & 0xFFFFFFFF
            val = (h2 << 32) | h1
            buckets.setdefault(val % prime, []).append(val)
        with open(path, "wb") as fo:
            for hsh in range(prime):
                if hsh not in buckets:
                    continue
                vals = sorted(buckets[hsh])
                last = vals[0]
                tally = 0
                for i, val in enumerate(vals):
                    if val != last or i == len(vals) - 1:
                        commit = vals[i - 1]
                        h1 = commit & 0xFFFFFFFF
                        h2 = commit >> 32
                        self._orthog_line(fo, h1, h2, tally)
                        tally = 0
                    tally += 1
                    last = val

    def _orthog_line(self, fo, h1, h2, tally):
        nuh = self.n_uniq_h
        if h1 == 0xFFFFFFFF or h2 == 0xFFFFFFFF:
            return  # unreachable for matched queries with taxa set
        lv1, lv2 = h1 // nuh[0], h2 // nuh[1] if nuh[1] else 0
        s1 = self.h_strings[0][h1 % nuh[0]]
        s2 = self.h_strings[1][h2 % nuh[1]] if nuh[1] else b""
        l1 = self._semi_offset(s1, lv1)
        l2 = self._semi_offset(s2, lv2)
        fo.write(s1[:l1] + b"\t" + s2[:l2] + b"\t%d\n" % tally)

    @staticmethod
    def _semi_offset(s: bytes, lv: int) -> int:
        if not lv:
            return len(s)  # L = UINT16_MAX ?: full string via %.*s
        semi = 0
        pos = 0
        while semi < lv and pos < len(s):
            semi += s[pos] == 0x3B
            pos += 1
        return pos - 1

    def _cov_tallies(self, query_aligns):
        """Per-ref (tot_k, tot_uniq, found_k, found_uniq, prop_k, prop_uniq)
        of the coverage table (xtree.c:1537-1620).  The reference walks each
        equal-suffix run (within its bin, as run_end) and inside it each
        stretch of one rix: a stretch of nd pods of ref rr, with mv the
        run's largest query_aligns, adds nd, mv and min(mv, nd) to rr's
        tot, found and prop, and to the uniq columns too when its run holds
        one rix only.  Here all runs and stretches at once, where
        `utree_tpu` takes a Python step per pod."""
        n, nr = self.db.num_kmers, self.db.num_refs
        if not n:
            return (np.zeros(nr, np.int64),) * 6
        rix = self.rix[:n]
        run_start = np.ones(n, bool)
        run_start[1:] = self.run_end[:-1] == np.arange(1, n)
        run_of = np.cumsum(run_start) - 1
        mv_run = np.maximum.reduceat(query_aligns[:n], np.flatnonzero(run_start))
        stretch = run_start.copy()
        stretch[1:] |= rix[1:] != rix[:-1]
        s0 = np.flatnonzero(stretch)
        nd = np.diff(np.append(s0, n))
        run_s = run_of[s0]
        mv = mv_run[run_s]
        uniq = (np.bincount(run_s, minlength=len(mv_run)) == 1)[run_s]
        out = []
        for sel in (slice(None), uniq):
            for w in (nd, mv, np.minimum(mv, nd)):
                # float64 sums of integers far below 2^53: exact
                out.append(np.bincount(rix[s0][sel], weights=w[sel],
                                       minlength=nr).astype(np.int64))
        tot_k, found_k, prop_k, tot_uniq, found_uniq, prop_uniq = out
        return tot_k, tot_uniq, found_k, found_uniq, prop_k, prop_uniq

    def _write_cov(self, path, query_aligns, full_query_aligns):
        """Coverage table (xtree.c:1537-1640)."""
        db = self.db
        nr = db.num_refs
        (tot_k, tot_uniq, found_k, found_uniq, prop_k,
         prop_uniq) = self._cov_tallies(query_aligns)
        with open(path, "wb") as fo:
            fo.write(b"Reference\tKmers_found\t")
            fo.write(b"Unique_kmers_found\tKmers_covered\tUnique_kmers_covered\t")
            fo.write(b"Proportion_covered\tUnique_proportion_covered\tReads_covered\n")
            for i in range(nr):
                if not found_k[i]:
                    continue
                fo.write(db.ref_names[i] + b"\t%d\t%d\t%d\t%d" % (
                    found_k[i], found_uniq[i], prop_k[i], prop_uniq[i]))
                fo.write(b"\t%f\t%f\t%d\n" % (
                    prop_k[i] / tot_k[i] if tot_k[i] else 0.0,
                    prop_uniq[i] / tot_uniq[i] if tot_uniq[i] else 0.0,
                    full_query_aligns[i]))
