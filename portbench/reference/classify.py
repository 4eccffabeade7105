"""The plain reference of a GG search: what the reference tool
(`utree-searchGG db.ctr reads.fa out.txt [threads] [RC]`, itree.c:861-1098)
writes for a sample, worked out from the database the harness made (sorted
32-mer words and their label ids) and the reads.

- bin offsets over the words' 24-bit prefixes, as the reference compressor
  computes them, quirks included (itree.c:1281-1289);
- every window of 32 valid bases of each read, and with RC of its reverse
  complement (the read and its RC text joined by an 'N', itree.c:891-897);
- each window looked up by the literal suffix binary search over its bin
  (xtSuffixBS, itree.c:699-730);
- each read's hit labels counted, voted (`vote.aufbau_vote_counts`) and
  formatted, one line a read with a hit, in read order.

Plain PyTorch (on whichever device it is given) and NumPy; it imports nothing
of the program.  `drop_bases` > 0 compares keys without their last bases: the
control, a lookup at a lower precision than the configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.vote import aufbau_vote_counts

K = 32
PRE_BITS = 24
SUF_BITS = 2 * K - PRE_BITS
BLOCK = 65536  # reads a block


def bin_offsets(prefixes: np.ndarray) -> np.ndarray:
    """The .ctr bin table (2^24 + 1 int64 offsets) over the sorted records'
    prefixes, by the reference's zero-sentinel scan: a populated bin gets its
    first record's index, the bin of record 0 gets 1 if it holds two or more
    records (else 0), the last entry the record count; then the first nonzero
    entry is zeroed and every empty bin after it takes the next bin's start."""
    n_bins = (1 << PRE_BITS) + 1
    out = np.zeros(n_bins, np.int64)
    n = len(prefixes)
    if n:
        new = np.ones(n, bool)
        new[1:] = prefixes[1:] != prefixes[:-1]
        starts = np.flatnonzero(new)
        out[prefixes[starts]] = starts
        first_count = starts[1] if len(starts) > 1 else n
        out[prefixes[0]] = 1 if first_count >= 2 else 0
    out[-1] = n
    u = int(np.argmax(out != 0))
    out[u] = 0
    tail = out[u + 1:]
    tail = np.where(tail == 0, np.iinfo(np.int64).max, tail)
    out[u + 1:] = np.minimum.accumulate(tail[::-1])[::-1]
    return out


class Reference:
    """The database on `device`, ready to classify reads."""

    def __init__(self, words: np.ndarray, ixs: np.ndarray, strings: list[bytes],
                 taxacut: int, device, drop_bases: int = 0):
        words = np.asarray(words, np.uint64)
        self.device = torch.device(device)
        self.strings = strings
        self.taxacut = taxacut
        self.shift = 2 * drop_bases
        pre = (words >> np.uint64(SUF_BITS)).astype(np.int64)
        suf = (words & np.uint64((1 << SUF_BITS) - 1)).astype(np.int64)
        self.bins = torch.from_numpy(bin_offsets(pre)).to(self.device)
        self.suf = torch.from_numpy(suf).to(self.device) >> self.shift
        self.ix = torch.from_numpy(np.asarray(ixs, np.int64)).to(self.device)

    def _keys(self, codes: torch.Tensor):
        """(prefix, suffix, valid) of every 32-base window of each row of
        `codes` (int64 base codes, -1 for a base that is not ACGT)."""
        win = codes.unfold(1, K, 1)
        valid = (win >= 0).all(-1)
        win = win.clamp(min=0)
        w_pre = 4 ** torch.arange(PRE_BITS // 2 - 1, -1, -1, device=codes.device)
        w_suf = 4 ** torch.arange(SUF_BITS // 2 - 1, -1, -1, device=codes.device)
        pre = (win[..., :PRE_BITS // 2] * w_pre).sum(-1)
        suf = (win[..., PRE_BITS // 2:] * w_suf).sum(-1)
        return pre, suf, valid

    def _lookup(self, pre, suf, valid) -> torch.Tensor:
        """Label id of each window, -1 for a miss (xtSuffixBS over its bin)."""
        n = len(self.suf)
        q = suf >> self.shift
        start = self.bins[pre]
        end = self.bins[pre + 1]
        empty = (start >= end) | ~valid
        p = torch.where(empty, 0, start)
        size = torch.where(empty, 0, end - start - 1)
        while bool((size > 0).any()):
            active = size > 0
            w = size >> 1
            le = active & (self.suf[torch.clamp(p + w + 1, max=n - 1)] <= q)
            p = torch.where(le, p + w + 1, p)
            size = torch.where(active, torch.where(le, size - w - 1, w), size)
        p = torch.clamp(p, max=n - 1)
        found = ~empty & (self.suf[p] == q)
        return torch.where(found, self.ix[p], -1)

    def histograms(self, reads: np.ndarray, do_rc: bool):
        """Each read's hit labels and their counts: (read, label, count)
        arrays sorted by read, then label."""
        lut = torch.full((256,), -1, dtype=torch.int64)
        for code, ch in enumerate(b"ACGT"):
            lut[ch] = code
            lut[ch + 32] = code
        lut = lut.to(self.device)
        n_labels = len(self.strings)
        out = []
        for a in range(0, len(reads), BLOCK):
            codes = lut[torch.from_numpy(reads[a:a + BLOCK]).to(self.device).long()]
            parts = [self._lookup(*self._keys(codes))]
            if do_rc:
                rc = torch.where(codes >= 0, 3 - codes, -1).flip(1)
                parts.append(self._lookup(*self._keys(rc)))
            hits = torch.cat(parts, 1)
            row = torch.arange(a, a + len(codes), device=self.device)[:, None].expand_as(hits)
            ok = (hits >= 0) & (hits < n_labels)
            key, cnt = torch.unique(row[ok] * n_labels + hits[ok], return_counts=True)
            out.append((key.cpu().numpy(), cnt.cpu().numpy()))
        key = np.concatenate([k for k, _ in out])
        cnt = np.concatenate([c for _, c in out])
        return key // n_labels, key % n_labels, cnt

    def lines(self, reads: np.ndarray, names, do_rc: bool,
              support_ranges: int = 1) -> list[bytes]:
        """The output line (no newline) of every read with a hit, in read
        order; `names(i)` is read i's name."""
        rows, labels, counts = self.histograms(reads, do_rc)
        bounds = np.flatnonzero(np.diff(rows)) + 1
        firsts = np.concatenate([[0], bounds]).astype(np.int64)
        lasts = np.concatenate([bounds, [len(rows)]]).astype(np.int64)
        strings, cut = self.strings, self.taxacut
        out = []
        for a, b in zip(firsts.tolist(), lasts.tolist()):
            if a == b:
                continue
            name = names(int(rows[a]))
            if b - a == 1:  # one label: its string, the hit count, 1, '*'
                out.append(b"%s\t%s\t%d\t1\t*" % (name, strings[labels[a]], counts[a]))
            else:
                out.append(aufbau_vote_counts(name, labels[a:b], counts[a:b], strings,
                                              cut, support_ranges))
        return out
