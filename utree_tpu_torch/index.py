"""The search index on the host (the port's copy of `utree_tpu/index.py`).

The reference search holds the CTR dump as one flat byte array in RAM and
binary-searches 7-byte records (itree.c:673-730).  Here the same records are
a structure of arrays:

  bin_ix   int32[2^24+1]  prefix-bin start offsets (as stored in the .ctr,
                           quirks included, see formats.compute_bin_ix)
  suf_hi   int32[N+1]     bits 39..32 of each 40-bit suffix
  suf_lo   uint32[N+1]    bits 31..0
  ix       int32[N+1]     label id per record

each with one sentinel record at the end, so that clamped probes stay in
bounds.  `probe_iters` is the trip count of the binary search over the
largest bin (ceil(log2(max_range+1))).  The hash tables are built from
these arrays (hash_index, hash_index64); the bsearch replay searches them
directly (hash_index.bsearch_to_device).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from utree_tpu_torch.config import UTreeConfig
from utree_tpu_torch.encode import W128
from utree_tpu_torch.formats import CtrData, compute_bin_ix, read_ctr
from utree_tpu_torch.taxonomy import count_semicolons
from utree_tpu_torch.utils import trace


def _probe_iters(bin_ix: np.ndarray) -> int:
    ranges = np.diff(bin_ix)
    max_range = int(ranges.max()) if len(ranges) else 0
    return max(1, math.ceil(math.log2(max_range + 1))) if max_range > 0 else 1


@dataclasses.dataclass
class DeviceIndexArrays:
    """Host (NumPy) arrays of the index; hash_index moves tables to a device."""

    bin_ix: np.ndarray  # int32 [2^24+1] (int64 if N >= 2^31)
    suf_hi: np.ndarray  # int32 [N+1]
    suf_lo: np.ndarray  # uint32 [N+1]
    ix: np.ndarray  # int32 [N+1]
    strings: list[bytes]
    semicolons: np.ndarray
    probe_iters: int
    config: UTreeConfig
    # PACKSIZE=64 only: full 104-bit suffix lanes (hi = bits 103..64,
    # lo = 63..0), which feed the 64-mer builders and the host replay
    s_hi64: np.ndarray | None = None
    s_lo64: np.ndarray | None = None

    @property
    def num_records(self) -> int:
        if self.s_hi64 is not None:
            return len(self.s_hi64)
        return len(self.suf_lo)

    @property
    def num_labels(self) -> int:
        return len(self.strings)

    @classmethod
    def from_ctr(cls, ctr: CtrData | str, config: UTreeConfig = UTreeConfig()) -> "DeviceIndexArrays":
        with trace.process().phase("index"):
            if isinstance(ctr, str):
                ctr = read_ctr(ctr, config)
            return cls._from_parts(ctr.bin_ix, ctr.suffixes, ctr.ixs, ctr.labels, config)

    @classmethod
    def from_build(cls, words: np.ndarray, ixs: np.ndarray, labels: list[bytes],
                   config: UTreeConfig = UTreeConfig()) -> "DeviceIndexArrays":
        """Straight from sorted words and their label ids, skipping the .ctr
        round trip (the bin table still uses the reference compressor's
        algorithm, so lookups agree with a reference binary reading the
        equivalent .ctr).  Spans `index` and, inside it, `index:bins`."""
        rec = trace.process()
        with rec.phase("index"):
            with rec.phase("index:bins"):
                bin_ix = compute_bin_ix(words, config.word_bits, config.ctr_prefix_bits)
            if words.dtype == W128:  # 104-bit suffix = (hi & 2^40-1, lo)
                suffixes = np.zeros(len(words), dtype=W128)
                suffixes["hi"] = words["hi"] & np.uint64((1 << 40) - 1)
                suffixes["lo"] = words["lo"]
            else:
                suffixes = np.asarray(words, dtype=np.uint64) & np.uint64(config.suffix_mask)
            return cls._from_parts(bin_ix, suffixes, np.asarray(ixs, np.int64), list(labels),
                                   config)

    @classmethod
    def _from_parts(cls, bin_ix, suffixes, ixs, labels, config) -> "DeviceIndexArrays":
        if suffixes.dtype.names:  # W128 (PACKSIZE=64)
            return cls._from_parts64(bin_ix, suffixes, ixs, labels, config)
        n = len(suffixes)
        suf_hi = np.zeros(n + 1, dtype=np.int32)
        suf_lo = np.zeros(n + 1, dtype=np.uint32)
        # the sentinel record holds BAD_IX as its int32 bits: -1 for
        # IXTYPE=u32 (2^32-1 does not fit int32, and newer NumPy refuses to
        # wrap it in np.full), 65535 for u16
        ix_arr = np.full(n + 1, np.uint32(config.bad_ix).view(np.int32), dtype=np.int32)
        suf_hi[:n] = (suffixes >> np.uint64(32)).astype(np.int32)
        suf_lo[:n] = (suffixes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        ix_arr[:n] = ixs.astype(np.int32)
        dtype = np.int32 if n < 2**31 else np.int64
        semis = np.array([count_semicolons(s) for s in labels], dtype=np.uint8)
        return cls(bin_ix=bin_ix.astype(dtype), suf_hi=suf_hi, suf_lo=suf_lo,
                   ix=ix_arr, strings=list(labels), semicolons=semis,
                   probe_iters=_probe_iters(bin_ix), config=config)

    @classmethod
    def _from_parts64(cls, bin_ix, suffixes, ixs, labels, config) -> "DeviceIndexArrays":
        semis = np.array([count_semicolons(s) for s in labels], dtype=np.uint8)
        return cls(
            bin_ix=bin_ix.astype(np.int64),
            suf_hi=np.zeros(0, np.int32),  # 40-bit lanes do not apply at k=64
            suf_lo=np.zeros(0, np.uint32),
            ix=ixs.astype(np.int64),
            strings=list(labels),
            semicolons=semis,
            probe_iters=_probe_iters(bin_ix),
            config=config,
            s_hi64=suffixes["hi"].astype(np.uint64),
            s_lo64=suffixes["lo"].astype(np.uint64),
        )

    def host_index(self):
        """HostIndex view over the same records (the exact host path)."""
        from utree_tpu_torch.search_host import HostIndex

        if self.s_hi64 is not None:
            return HostIndex(self.bin_ix.astype(np.int64), self.s_hi64, self.s_lo64,
                             self.ix.astype(np.int64), self.strings, self.semicolons,
                             self.config)
        n = self.num_records
        return HostIndex(
            self.bin_ix.astype(np.int64),
            np.zeros(n, np.uint64),
            (self.suf_hi[:n].astype(np.uint64) << np.uint64(32))
            | self.suf_lo[:n].astype(np.uint64),
            self.ix[:n].astype(np.int64),
            self.strings,
            self.semicolons,
            self.config,
        )
