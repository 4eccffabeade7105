"""Host (NumPy) search: the exactness reference for the device path (the
port's copy of `utree_tpu/search_host.py`'s GG search).

Implements utree-searchGG (XT_doSearch32, itree.c:833-1108) against a loaded
CTR index: per read, every valid k-mer window (forward + optional RC) is
looked up with the exact xtSuffixBS probe sequence (itree.c:699-730), hits
below the label count are histogrammed, and the aufbau vote emits the output
line.  Output equals the reference binary's classifications.txt run with one
thread.  `chip_smoke.py` holds the device path to it, and the pipeline
replays over-cap PACKSIZE=64 reads through `lookup_words`.

The rank-specific search (utree-search, `search_file_shallow`) runs on the
host only, as in `utree_tpu`: the literal word state machine of the shallow
scan (`scan_shallow_literal`, its batched twin `scan_shallow_fast`, and the
C++ `native.shallow_*`) and the stateful `classify.ShallowVoter`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from utree_tpu_torch.classify import aufbau_vote
from utree_tpu_torch.config import UTreeConfig
from utree_tpu_torch.encode import search_window_words
from utree_tpu_torch.formats import CtrData, read_ctr
from utree_tpu_torch.io.fasta import iter_fasta_records
from utree_tpu_torch.taxonomy import count_semicolons


@dataclasses.dataclass
class HostIndex:
    """CTR index in flat NumPy arrays.

    Suffixes are stored two-lane (s_hi, s_lo u64): for PACKSIZE=32 the 40-bit
    suffix sits in s_lo (s_hi = 0); for PACKSIZE=64 the 104-bit suffix splits
    as s_hi = bits 103..64, s_lo = bits 63..0.  Lexicographic (s_hi, s_lo)
    order equals unsigned wide-integer order, so one probe loop serves both.
    """

    bin_ix: np.ndarray  # int64 [2^24+1]
    s_hi: np.ndarray  # uint64 [N]
    s_lo: np.ndarray  # uint64 [N]
    ixs: np.ndarray  # int64 [N]
    strings: list[bytes]
    semicolons: np.ndarray  # uint8 per label (EXTRA_ADD_DELIM, itree.c:1188-1199)
    config: UTreeConfig

    @property
    def num_labels(self) -> int:
        return len(self.strings)

    @classmethod
    def from_ctr(cls, ctr: CtrData | str, config: UTreeConfig = UTreeConfig()) -> "HostIndex":
        if isinstance(ctr, str):
            ctr = read_ctr(ctr, config)
        semis = np.array([count_semicolons(s) for s in ctr.labels], dtype=np.uint8)
        if ctr.suffixes.dtype.names:  # W128 structured (PACKSIZE=64)
            s_hi = ctr.suffixes["hi"].astype(np.uint64)
            s_lo = ctr.suffixes["lo"].astype(np.uint64)
        else:
            s_hi = np.zeros(len(ctr.suffixes), np.uint64)
            s_lo = ctr.suffixes.astype(np.uint64)
        return cls(ctr.bin_ix, s_hi, s_lo, ctr.ixs, ctr.labels, semis, config)


def lookup_words(index: HostIndex, words: np.ndarray) -> np.ndarray:
    """Vectorized exact replay of XT_getIX32 + xtSuffixBS (itree.c:699-730).

    The probe loop is replayed literally — `while size: w=size>>1;
    if suffix[p+w+1] <= q: p+=w+1, size-=w+1; else size=w` — so results match
    the reference even over the quirky merged bins the compressor can emit
    (see formats.compute_bin_ix).  Returns BAD (=2^8*ixtype-1) for misses.
    """
    cfg = index.config
    if words.dtype.names:  # W128 (PACKSIZE=64): prefix = top 24 of hi
        hi = words["hi"].astype(np.uint64)
        qpre = (hi >> np.uint64(40)).astype(np.int64)
        q_hi = hi & np.uint64((1 << 40) - 1)
        q_lo = words["lo"].astype(np.uint64)
    else:
        words = np.asarray(words, dtype=np.uint64)
        qpre = (words >> np.uint64(cfg.ctr_suffix_bits)).astype(np.int64)
        q_hi = np.zeros(len(words), np.uint64)
        q_lo = words & np.uint64(cfg.suffix_mask)
    start = index.bin_ix[qpre]
    end = index.bin_ix[qpre + 1]
    empty = start >= end
    p = np.where(empty, np.int64(0), start)
    size = np.where(empty, np.int64(0), end - start - 1)
    s_hi, s_lo = index.s_hi, index.s_lo
    nmax = len(s_lo) - 1
    while True:
        active = size > 0
        if not active.any():
            break
        w = size >> 1
        probe = np.minimum(p + w + 1, nmax)  # clamp only for inactive lanes
        le = active & (
            (s_hi[probe] < q_hi) | ((s_hi[probe] == q_hi) & (s_lo[probe] <= q_lo))
        )
        p = np.where(le, p + w + 1, p)
        size = np.where(active, np.where(le, size - w - 1, w), size)
    pc = np.minimum(p, nmax)
    found = (~empty) & (s_hi[pc] == q_hi) & (s_lo[pc] == q_lo)
    out = np.full(len(qpre), cfg.bad_ix, dtype=np.int64)
    out[found] = index.ixs[p[found]]
    return out


def classify_read(
    index: HostIndex, name: bytes, seq: bytes, do_rc: bool = False,
    support_ranges: int = 1,
) -> bytes | None:
    """One read -> output line (no newline) or None (itree.c:1020-1098)."""
    words = search_window_words(seq, index.config.packsize, do_rc)
    if len(words) == 0:
        return None
    ixs = lookup_words(index, words)
    hits = ixs[ixs < index.num_labels]
    return aufbau_vote(name, hits, index.strings, index.config.taxacut,
                       support_ranges)


def search_file(
    index: HostIndex, reads_path: str, out_path: str, do_rc: bool = False,
    support_ranges: int = 1,
) -> int:
    """Full searchGG over a reads file; returns the number of queries.
    support_ranges=8 emits the README-documented per-rank SUPPORT;RANGE
    columns (classify.aufbau_vote_counts)."""
    n = 0
    with open(out_path, "wb") as fo:
        for header, seq in iter_fasta_records(reads_path):
            n += 1
            # search cuts the name at the first space (itree.c:881-882)
            name = header.split(b" ")[0]
            line = classify_read(index, name, seq, do_rc, support_ranges)
            if line is not None:
                fo.write(line + b"\n")
    return n


def _lookup_one(index: HostIndex, word: int) -> int:
    """Single-word XT_getIX32 replay (itree.c:699-730); `word` is a Python
    int of any width (64-bit or 128-bit)."""
    cfg = index.config
    qpre = word >> cfg.ctr_suffix_bits
    qsuf = word & cfg.suffix_mask
    start = int(index.bin_ix[qpre])
    end = int(index.bin_ix[qpre + 1])
    if start >= end:
        return cfg.bad_ix

    def suffix_at(j: int) -> int:
        return (int(index.s_hi[j]) << 64) | int(index.s_lo[j])

    p, size = start, end - start - 1
    while size:
        w = size >> 1
        if suffix_at(p + w + 1) <= qsuf:
            p += w + 1
            size -= w + 1
        else:
            size = w
    return int(index.ixs[p]) if suffix_at(p) == qsuf else cfg.bad_ix


def scan_shallow_literal(index: HostIndex, seq: bytes, do_rc: bool) -> list[int]:
    """Literal replay of XT_WORD_SEARCH + XT_SHALLOWVOTE (itree.c:903-951).

    The shallow vote's skip-after-hit (`i += PACKSIZE/SPARSITY - 1`) re-enters
    the incremental encoder with a gap > 1, and its catch-up shift
    `w <<= (i-z-1)<<1` plus the per-base append shifts OVER-shifts the word
    (itree.c:920-924) — the reference then looks up corrupted k-mers until the
    corruption rolls out or a bad character forces a re-encode.  Bit-exact
    output requires replaying that word state machine literally, so this path
    is a sequential scan (the GG search never skips and is unaffected)."""
    from utree_tpu_torch.encode import INVALID, encode_bases, revcomp_text

    cfg = index.config
    k1 = cfg.packsize - 1
    kv = k1
    step = cfg.packsize // cfg.sparsity - 1
    mask = (1 << cfg.word_bits) - 1
    if do_rc:
        seq = seq + b"N" + revcomp_text(seq)
    codes = encode_bases(seq)
    length = len(codes)
    max_ix = index.num_labels
    hits: list[int] = []
    w = 0
    i = kv
    z = -4
    while i < length:
        if i < z + kv:
            w = (w << ((i - z - 1) << 1)) & mask
            j = z + 1
        else:
            w = 0
            j = i - k1
        p = j
        broke = False
        while j <= i:
            c = int(codes[j])
            if c == INVALID or c > 3:
                i += j - p
                z = 0
                broke = True
                break
            w = ((w << 2) | c) & mask
            j += 1
        if broke:
            i += 1
            continue
        z = i
        ix = _lookup_one(index, w)
        if ix < max_ix:
            hits.append(ix)
            i += step
        i += 1
    return hits


def scan_shallow_fast(index: HostIndex, seq: bytes, do_rc: bool) -> list[int]:
    """Exact scan_shallow_literal with the per-window Python work removed
    from every no-hit span.

    All CLEAN window words are batch-looked-up once (lookup_words, the
    vectorized XT_getIX32 replay).  From any provably-clean machine state —
    the start, after a bad-char re-encode (z=0 forces a fresh word), or a
    clean-word miss — every window the machine would visit up to the next
    precomputed hit is a clean miss (no state to replay), so the scan jumps
    straight to that hit with one binsearch.  Only the stretch AFTER a hit
    runs the literal word state machine, because the skip-after-hit
    over-shift (itree.c:920-924) corrupts the word there and corrupted
    k-mers can themselves hit; the stretch ends at the first window whose
    machine word equals the clean word and misses.  Output identical to the
    literal replay by construction on every path."""
    from utree_tpu_torch.encode import (INVALID, encode_bases, revcomp_text,
                                  search_window_words_positions)

    cfg = index.config
    k1 = cfg.packsize - 1
    kv = k1
    step = cfg.packsize // cfg.sparsity - 1
    mask = (1 << cfg.word_bits) - 1
    words, positions = search_window_words_positions(seq, cfg.packsize, do_rc)
    max_ix = index.num_labels
    if len(words):
        pre_ix = lookup_words(index, words)
        if words.dtype.names:  # W128 -> python ints matching the machine's w
            wlist = [(int(h) << 64) | int(l)
                     for h, l in zip(words["hi"], words["lo"])]
        else:
            wlist = words.tolist()  # python ints: fast == against w
        ilist = pre_ix.tolist()
        hit_t = np.flatnonzero(pre_ix < max_ix)
        hitpos = positions[hit_t]  # window starts of clean hits, ascending
    else:
        wlist, ilist = [], []
        hit_t = hitpos = np.zeros(0, np.int64)
    ext = seq + b"N" + revcomp_text(seq) if do_rc else seq
    codes = encode_bases(ext)
    length = len(codes)
    pos_to_j = np.full(length + 1, -1, np.int64)
    if len(words):
        pos_to_j[positions] = np.arange(len(words))
    hits: list[int] = []
    w = 0
    i = kv
    z = -4
    clean = True  # machine word provably equals the clean window word
    while i < length:
        if clean:
            # every valid window with start in [i-k1, next hit) is a clean
            # miss and invalid spans re-encode fresh: jump to the next hit
            t = int(np.searchsorted(hitpos, i - k1))
            if t >= len(hitpos):
                break
            tj = int(hit_t[t])
            hits.append(ilist[tj])
            w = wlist[tj]  # machine word at the hit = its clean window word
            z = int(hitpos[t]) + k1
            i = z + step + 1
            clean = False
            continue
        if i < z + kv:
            w = (w << ((i - z - 1) << 1)) & mask
            j = z + 1
        else:
            w = 0
            j = i - k1
        p = j
        broke = False
        while j <= i:
            c = int(codes[j])
            if c == INVALID or c > 3:
                i += j - p
                z = 0
                broke = True
                break
            w = ((w << 2) | c) & mask
            j += 1
        if broke:
            i += 1
            clean = True  # z=0: the next window re-encodes from scratch
            continue
        z = i
        pj = int(pos_to_j[i - k1])
        if pj >= 0 and wlist[pj] == w:
            ix = ilist[pj]
            if ix < max_ix:
                hits.append(ix)
                i += step
            else:
                clean = True  # clean miss: back to the jump cadence
        else:  # over-shift-corrupted word: literal scalar replay
            ix = _lookup_one(index, w)
            if ix < max_ix:
                hits.append(ix)
                i += step
        i += 1
    return hits


def search_file_shallow(
    index: HostIndex, reads_path: str, out_path: str, do_rc: bool = False,
    chunk: int = 4096,
) -> int:
    """Rank-specific search (utree-search, doCollapse=0 path itree.c:969-1006):
    SPARSITY-subsampled hits, majority vote with TOLERANCE/SLACK rejection.

    When the word fits u64, the whole per-read pipeline (encode, scan,
    stateful vote, formatting) runs in one native call per batch
    (csrc/host/shallow.cpp utree_shallow_classify_batch); a file the native
    scanner cannot read as linearized FASTA takes the native scan with the
    Python vote instead.  Wider words take scan_shallow_fast.  A failed g++
    build raises (utree_tpu falls back to Python there)."""
    from utree_tpu_torch.classify import ShallowVoter
    from utree_tpu_torch.encode import encode_bases, revcomp_text
    from utree_tpu_torch.native import shallow_classify_file, shallow_scan_batch

    cfg = index.config
    use_native = cfg.word_bits <= 64 and not index.s_hi.any()
    if use_native:
        try:
            return shallow_classify_file(index, reads_path, out_path, do_rc)
        except ValueError:  # not linearized FASTA for the native scanner
            pass
    voter = ShallowVoter(index.strings, cfg.tolerance, cfg.slack)
    n = 0
    pend_names: list[bytes] = []
    pend_ext: list[np.ndarray] = []

    with open(out_path, "wb") as fo:
        def flush():
            for name, hits in zip(pend_names, shallow_scan_batch(index, pend_ext)):
                line = voter.vote(name, hits)
                if line is not None:
                    fo.write(line + b"\n")
            pend_names.clear()
            pend_ext.clear()

        for header, seq in iter_fasta_records(reads_path):
            n += 1
            name = header.split(b" ")[0]
            if use_native:
                ext = seq + b"N" + revcomp_text(seq) if do_rc else seq
                pend_names.append(name)
                pend_ext.append(encode_bases(ext))
                if len(pend_names) >= chunk:
                    flush()
            else:
                hits = scan_shallow_fast(index, seq, do_rc)
                line = voter.vote(name, hits)
                if line is not None:
                    fo.write(line + b"\n")
        if pend_names:
            flush()
    return n
