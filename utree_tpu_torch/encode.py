"""DNA encoding and k-mer window extraction on the host (the port's copy of
`utree_tpu/encode.py`).

Reference semantics reimplemented vectorized:
- base codes A/a=0 C/c=1 G/g=2 T/t=3, everything else invalid
  (initConverter, itree.c:110-121);
- build-time sampling: sliding k-mer whose `complevel` preceding bases must
  spell the prefix of "AGCT", skipping windows containing invalid bases
  (itree.c:603-623);
- search-time extraction: every valid window, with optional reverse-complement
  appended after a sentinel 'N' (itree.c:891-897, 903-933);
- word packing: MSB-first 2 bits/base (itree.c:617-621);
- the build's stable word order (`word_sort_key`) and the .ctr record split
  (`split_word`).

Words are NumPy uint64 (k <= 32) or W128 (k = 64).
"""

from __future__ import annotations

import numpy as np

# --- host base-code table (C2Xb, itree.c:110-121) ---------------------------

INVALID = 255

_CODE_TABLE = np.full(256, INVALID, dtype=np.uint8)
for _b, _c in ((b"Aa", 0), (b"Cc", 1), (b"Gg", 2), (b"Tt", 3)):
    for _ch in _b:
        _CODE_TABLE[_ch] = _c

# Gate base codes: the complevel bases before a k-mer must spell "AGCT"[:lv]
# (itree.c:605-616): A=0, G=2, C=1, T=3.
GATE_CODES = np.array([0, 2, 1, 3], dtype=np.uint8)

# Reverse-complement character table (RC, itree.c:838-841): ACGT<->TGCA
# case-insensitive, everything else 'N'.
_RC_TABLE = np.full(256, ord("N"), dtype=np.uint8)
for _src, _dst in ((b"Aa", b"T"), (b"Cc", b"G"), (b"Gg", b"C"), (b"Tt", b"A")):
    for _ch in _src:
        _RC_TABLE[_ch] = _dst[0]


def encode_bases(seq: bytes | np.ndarray) -> np.ndarray:
    """Map ASCII sequence to base codes (uint8; INVALID for non-ACGT)."""
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, (bytes, bytearray)) else np.asarray(seq, dtype=np.uint8)
    return _CODE_TABLE[arr]


def revcomp_text(seq: bytes) -> bytes:
    """Reverse complement at the character level, exactly like the reference
    search's RC append (itree.c:891-897): non-ACGT become 'N'."""
    arr = np.frombuffer(seq, dtype=np.uint8)
    return _RC_TABLE[arr][::-1].tobytes()


# 128-bit words (PACKSIZE=64, WTYPE=__uint128_t, itree.c:55-57) are stored as
# a structured (hi, lo) pair — numpy sorts/compares it lexicographically,
# which equals unsigned 128-bit order.
W128 = np.dtype([("hi", "<u8"), ("lo", "<u8")])


def _pack_words_u64(codes: np.ndarray, starts: np.ndarray, k: int) -> np.ndarray:
    """Pack k<=32 bases starting at each index into uint64 words, MSB-first;
    k=64 packs into W128 (hi = first 32 bases, lo = last 32)."""
    if k > 32:
        if k != 64:
            raise NotImplementedError("only k<=32 and k=64 word packing")
        out = np.zeros(len(starts), dtype=W128)
        out["hi"] = _pack_words_u64(codes, starts, 32)
        out["lo"] = _pack_words_u64(codes, starts + 32, 32)
        return out
    # doubling pyramid: levels[t][i] = word of codes[i : i+2^t], built with
    # log2(k) contiguous-slice combines; each output word then needs one
    # gather per set bit of k (k=32 -> ONE gather) instead of k gathers.
    n = len(codes)
    levels = {0: codes.astype(np.uint64)}
    t = 0
    while (1 << (t + 1)) <= k:
        h = 1 << t
        prev = levels[t]
        nxt = np.zeros(n, dtype=np.uint64)
        np.left_shift(prev[: n - h], np.uint64(2 * h), out=nxt[: n - h])
        nxt[: n - h] |= prev[h:]
        levels[t + 1] = nxt
        if not (k >> t) & 1:  # level t is not a component of k: free it
            del levels[t]
        t += 1
    w = np.zeros(len(starts), dtype=np.uint64)
    off = 0
    for tt in range(t, -1, -1):
        if (k >> tt) & 1:
            w = (w << np.uint64(2 << tt)) | levels[tt][starts + off]
            off += 1 << tt
    return w


def word_sort_key(words: np.ndarray):
    """Stable argsort key handling both u64 and W128 words."""
    return np.argsort(words, kind="stable", order=("hi", "lo") if words.dtype == W128 else None)


def _empty_words(k: int) -> np.ndarray:
    return np.zeros(0, dtype=W128 if k > 32 else np.uint64)


def sample_build_kmers(seq: bytes, k: int, complevel: int) -> np.ndarray:
    """All sampled k-mer words of one reference sequence, in position order.

    Implements the build driver's sampling (itree.c:584-624): window end i
    runs from kv=k-1+lv; the lv bases at i-kv.. must be the prefix of "AGCT";
    any invalid base in the window skips it.  Returns uint64 (or W128) words.
    """
    codes = encode_bases(seq)
    n = len(codes)
    lv = complevel
    if n < k + lv:
        return _empty_words(k)
    valid = codes != INVALID
    # window with start s covers [s, s+k); gate positions are [s-lv, s).
    # Windows must satisfy: s >= lv; all k bases valid; gate bases match.
    starts = np.arange(lv, n - k + 1)
    ok = np.ones(len(starts), dtype=bool)
    # validity: no invalid base inside the window
    inv_cum = np.concatenate(([0], np.cumsum(~valid).astype(np.int64)))
    ok &= (inv_cum[starts + k] - inv_cum[starts]) == 0
    # gate
    for t in range(lv):
        ok &= codes[starts - lv + t] == GATE_CODES[t]
    starts = starts[ok]
    return _pack_words_u64(codes, starts, k)


def search_window_words_positions(seq: bytes, k: int, do_rc: bool):
    """Like search_window_words but also returns each window's start position
    (over the RC-extended text) — needed by the rank-specific search's
    skip-after-hit subsampling (itree.c:948-951)."""
    if do_rc:
        seq = seq + b"N" + revcomp_text(seq)
    codes = encode_bases(seq)
    n = len(codes)
    if n < k:
        return _empty_words(k), np.zeros(0, dtype=np.int64)
    valid = codes != INVALID
    inv_cum = np.concatenate(([0], np.cumsum(~valid).astype(np.int64)))
    starts = np.arange(0, n - k + 1)
    ok = (inv_cum[starts + k] - inv_cum[starts]) == 0
    starts = starts[ok]
    return _pack_words_u64(codes, starts, k), starts


def search_window_words(seq: bytes, k: int, do_rc: bool) -> np.ndarray:
    """All valid k-mer words scanned by the search loop, in scan order.

    The search scans every window (its complevel gate is compiled out,
    itree.c:906-918) over the read text, optionally followed by 'N' + the
    reverse complement (itree.c:891-897).  The bad-character skip in
    XT_WORD_SEARCH only ever skips windows containing the bad base, so the
    dense valid-window set reproduces its hits exactly.  Returns uint64 words.
    """
    if do_rc:
        seq = seq + b"N" + revcomp_text(seq)
    codes = encode_bases(seq)
    n = len(codes)
    if n < k:
        return _empty_words(k)
    valid = codes != INVALID
    inv_cum = np.concatenate(([0], np.cumsum(~valid).astype(np.int64)))
    starts = np.arange(0, n - k + 1)
    ok = (inv_cum[starts + k] - inv_cum[starts]) == 0
    return _pack_words_u64(codes, starts[ok], k)



def split_word(words: np.ndarray, word_bits: int, suffix_bits: int):
    """Split uint64 words into (prefix, suffix_hi, suffix_lo32) int arrays.

    prefix = top (word_bits - suffix_bits) bits; suffix split into the
    (suffix_bits-32) high bits and the low 32 bits: the two-lane
    representation of the .ctr record split (itree.c:689-695).
    """
    words = words.astype(np.uint64)
    prefix = (words >> np.uint64(suffix_bits)).astype(np.int64)
    suffix = words & np.uint64((1 << suffix_bits) - 1)
    hi = (suffix >> np.uint64(32)).astype(np.int32)
    lo = (suffix & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    return prefix.astype(np.int32), hi, lo
