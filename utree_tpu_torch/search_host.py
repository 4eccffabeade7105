"""Host (NumPy) search: the exactness reference for the device path (the
port's copy of `utree_tpu/search_host.py`'s GG search).

Implements utree-searchGG (XT_doSearch32, itree.c:833-1108) against a loaded
CTR index: per read, every valid k-mer window (forward + optional RC) is
looked up with the exact xtSuffixBS probe sequence (itree.c:699-730), hits
below the label count are histogrammed, and the aufbau vote emits the output
line.  Output equals the reference binary's classifications.txt run with one
thread.  `chip_smoke.py` holds the device path to it, and the pipeline
replays over-cap PACKSIZE=64 reads through `lookup_words`.
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
