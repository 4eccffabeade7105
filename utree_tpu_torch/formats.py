"""Byte-exact .ubt / .ctr database (de)serialization (the port's copy of
`utree_tpu/formats.py`).

.ubt (UT_writeTreeBinary, itree.c:1317-1343):
  u64 header {sizeof(WTYPE), 0, sizeof(IXTYPE), numNodes}; numNodes x
  {word (little-endian WTYPE), ix (IXTYPE)} ascending by word; then ASCII
  "label\\tcount\\n" per label id in order (dead labels included, count 0).

.ctr (XT_cmp32, itree.c:1234-1315):
  same header; 2^24+1 bin offsets (u32 each when numNodes < 2^32-1, u64
  otherwise); numNodes x (low sizeof(WTYPE)-3 bytes of the word + IXTYPE),
  i.e. the 24-bit prefix is dropped and the 40-bit suffix kept; then the
  same label lines.  The bin-offset table is built with a zero-sentinel
  scan that has observable quirks (first populated bin's offset temporarily
  lands on 1 and is repaired by the first-nonzero fixup, itree.c:1282-1289);
  compute_bin_ix replays that algorithm literally so the bytes, and any
  downstream lookup behavior, match the reference exactly.

Little-endian host assumed (the reference's byte-truncation serialization is
little-endian dependent, itree.c:1306-1308).
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from utree_tpu_torch.config import UTreeConfig
from utree_tpu_torch.encode import W128


@dataclasses.dataclass
class UbtData:
    wtype_bytes: int
    ixtype_bytes: int
    words: np.ndarray  # uint64 ascending
    ixs: np.ndarray  # int64
    labels: list[bytes]
    counts: np.ndarray  # uint64 per label


@dataclasses.dataclass
class CtrData:
    wtype_bytes: int
    ixtype_bytes: int
    num_nodes: int
    bin_ix: np.ndarray  # int64, 2^24+1 entries, as stored on disk
    suffixes: np.ndarray  # uint64 (low 40 bits of each word), record order
    ixs: np.ndarray  # int64
    labels: list[bytes]
    counts: np.ndarray  # uint64


def _parse_label_tail(tail: bytes) -> tuple[list[bytes], np.ndarray]:
    """Parse trailing "label\\tcount\\n" lines (readSamplesFPdelim, itree.c:1154-1223)."""
    labels: list[bytes] = []
    counts: list[int] = []
    for line in tail.split(b"\n"):
        if not line:
            continue
        name, _, cnt = line.partition(b"\t")
        labels.append(name)
        counts.append(int(cnt) if cnt.strip() else 0)
    return labels, np.array(counts, dtype=np.uint64)


def _words_le_bytes(words: np.ndarray, wtype_bytes: int) -> np.ndarray:
    """(n, wtype_bytes) little-endian byte view of u64 or W128 words."""
    n = len(words)
    out = np.zeros((n, wtype_bytes), np.uint8)
    if words.dtype == W128:
        out[:, :8] = words["lo"].astype("<u8").view(np.uint8).reshape(n, 8)
        out[:, 8:16] = words["hi"].astype("<u8").view(np.uint8).reshape(n, 8)
    else:
        # small-k words (wtype_bytes 1/2/4) are the low LE bytes of the u64
        w8 = np.asarray(words, dtype="<u8").view(np.uint8).reshape(n, 8)
        nb = min(8, wtype_bytes)
        out[:, :nb] = w8[:, :nb]
    return out


def label_lines(labels: list[bytes], counts) -> bytes:
    """The trailing "label\\tcount\\n" lines of a .ubt or .ctr."""
    return b"".join(lbl + b"\t" + str(int(cnt)).encode() + b"\n"
                    for lbl, cnt in zip(labels, counts))


def _word_prefixes(words: np.ndarray, word_bits: int, prefix_bits: int) -> np.ndarray:
    """Top prefix_bits of each word, for u64 or W128 words."""
    if words.dtype == W128:
        return (words["hi"] >> np.uint64(word_bits - prefix_bits - 64)).astype(np.int64)
    return (np.asarray(words, dtype=np.uint64) >> np.uint64(word_bits - prefix_bits)).astype(np.int64)


def write_ubt(path: str, words: np.ndarray, ixs: np.ndarray, labels: list[bytes],
              config: UTreeConfig) -> None:
    n = len(words)
    wb, ib = config.wtype_bytes, config.ixtype_bytes
    counts = np.bincount(np.asarray(ixs, dtype=np.int64), minlength=len(labels)).astype(np.uint64)
    with open(path, "wb") as of:
        of.write(struct.pack("<4Q", wb, 0, ib, n))
        rec = np.zeros((n, wb + ib), np.uint8)
        rec[:, :wb] = _words_le_bytes(words, wb)
        rec[:, wb:] = np.asarray(ixs, dtype=f"<u{ib}").view(np.uint8).reshape(n, ib)
        of.write(rec.tobytes())
        of.write(label_lines(labels, counts))


def sniff_config(path: str) -> UTreeConfig:
    """UTreeConfig from a .ubt/.ctr header (both start with u64
    {sizeof(WTYPE), 0, sizeof(IXTYPE), numNodes}, itree.c:1317-1343) — the
    equivalent of picking the right reference binary for a DB."""
    with open(path, "rb") as fp:
        wsz, _csz, isz, _n = struct.unpack("<4Q", fp.read(32))
    if wsz * 4 not in (4, 8, 16, 32, 64) or isz not in (2, 4):
        raise ValueError(f"unrecognized DB header: WTYPE={wsz}B IXTYPE={isz}B")
    return UTreeConfig(packsize=wsz * 4, ixtype_bytes=isz)


def read_ubt(path: str) -> UbtData:
    with open(path, "rb") as fp:
        data = fp.read()
    wsz, csz, isz, n = struct.unpack_from("<4Q", data, 0)
    if csz != 0:
        raise ValueError("count-carrying trees are not supported (NO_COUNT builds only)")
    rec_sz = wsz + isz
    raw = np.frombuffer(data, np.uint8, count=n * rec_sz, offset=32).reshape(n, rec_sz)
    if wsz == 16:
        words = np.zeros(n, dtype=W128)
        words["lo"] = raw[:, :8].copy().view("<u8").reshape(n)
        words["hi"] = raw[:, 8:16].copy().view("<u8").reshape(n)
    else:
        words = raw[:, :wsz].copy().view(f"<u{wsz}").reshape(n).astype(np.uint64)
    ixs = raw[:, wsz:].copy().view(f"<u{isz}").reshape(n).astype(np.int64)
    labels, counts = _parse_label_tail(data[32 + n * rec_sz:])
    return UbtData(wsz, isz, words, ixs, labels, counts)


def compute_bin_ix(words: np.ndarray, word_bits: int, prefix_bits: int = 24) -> np.ndarray:
    """Replay the reference's bin-offset construction (itree.c:1281-1289).

    Literal semantics of the zero-sentinel scan:
      - populated bin whose first node index s>0 gets s;
      - the bin containing node 0 gets 1 if it has >=2 nodes, else stays 0;
      - BinIx[last] = numNodes;
      - the FIRST nonzero entry is zeroed (repairing the node-0 bin in the
        common case; shifting the second bin when the first is a singleton);
      - empty bins above that point are back-filled with the next bin's start.
    """
    num_nodes = len(words)
    num_bins = (1 << prefix_bits) + 1
    bin_ix = np.zeros(num_bins, dtype=np.int64)
    prefixes = _word_prefixes(words, word_bits, prefix_bits)
    if num_nodes:
        first_new = np.empty(num_nodes, dtype=bool)
        first_new[0] = True
        first_new[1:] = prefixes[1:] != prefixes[:-1]
        starts = np.flatnonzero(first_new)
        pop_bins = prefixes[starts]
        bin_ix[pop_bins] = starts
        # zero-sentinel quirk: the bin holding node 0 re-triggers at node 1
        first_bin = pop_bins[0]
        first_count = (starts[1] if len(starts) > 1 else num_nodes) - 0
        bin_ix[first_bin] = 1 if first_count >= 2 else 0
    bin_ix[num_bins - 1] = num_nodes
    u = int(np.argmax(bin_ix != 0))  # first nonzero (one exists: last entry)
    bin_ix[u] = 0
    # back-fill zeros above u with the next nonzero to the right
    tail = bin_ix[u + 1 :].copy()
    filled = np.where(tail == 0, np.int64(np.iinfo(np.int64).max), tail)
    filled = np.minimum.accumulate(filled[::-1])[::-1]
    bin_ix[u + 1 :] = filled
    return bin_ix


def write_ctr_from_ubt(ubt_path: str, ctr_path: str, config: UTreeConfig = UTreeConfig()) -> None:
    """utree-compress equivalent (XT_cmp32, itree.c:1234-1315), byte-exact."""
    ubt = read_ubt(ubt_path)
    write_ctr(ctr_path, ubt.words, ubt.ixs, ubt.labels, ubt.counts, config)


def write_ctr(path: str, words: np.ndarray, ixs: np.ndarray, labels: list[bytes],
              counts: np.ndarray, config: UTreeConfig = UTreeConfig()) -> None:
    if config.ctr_suffix_bytes < 1:
        raise ValueError(
            f"PACKSIZE={config.packsize} words ({config.wtype_bytes}B) cannot "
            f"be compressed: the CTR trims {config.ctr_trim_bytes} prefix "
            "bytes (itree.c:690-692); the reference supports COMPRESS/SEARCH "
            "for PACKSIZE >= 16 only")
    n = len(words)
    bin_ix = compute_bin_ix(words, config.word_bits, config.ctr_prefix_bits)
    off_dtype = "<u4" if n < 0xFFFFFFFF else "<u8"  # numNodes < UINT32_MAX, itree.c:1303
    suffix_bytes = config.ctr_suffix_bytes
    with open(path, "wb") as of:
        of.write(struct.pack("<4Q", config.wtype_bytes, 0, config.ixtype_bytes, n))
        of.write(bin_ix.astype(off_dtype).tobytes())
        # records: low `suffix_bytes` bytes of each little-endian word + ix
        rec = np.zeros((n, config.ctr_record_bytes), dtype=np.uint8)
        rec[:, :suffix_bytes] = _words_le_bytes(words, config.wtype_bytes)[:, :suffix_bytes]
        rec[:, suffix_bytes:] = (np.asarray(ixs, dtype=f"<u{config.ixtype_bytes}")
                                 .view(np.uint8).reshape(n, config.ixtype_bytes))
        of.write(rec.tobytes())
        of.write(label_lines(labels, counts))


def read_ctr(path: str, config: UTreeConfig = UTreeConfig()) -> CtrData:
    """CTR loader (XT_read32, itree.c:733-828)."""
    with open(path, "rb") as fp:
        data = fp.read()
    wsz, csz, isz, n = struct.unpack_from("<4Q", data, 0)
    if wsz != config.wtype_bytes or csz != 0 or isz != config.ixtype_bytes:
        raise ValueError(
            f"DB requires PACKSIZE={wsz * 4}, IXTYPE bytes={isz}; config has "
            f"PACKSIZE={config.packsize}, IXTYPE bytes={config.ixtype_bytes}"
        )
    num_bins = config.ctr_num_bins
    off_sz = 4 if n < 0xFFFFFFFF else 8
    off = 32
    bin_ix = np.frombuffer(data, dtype=f"<u{off_sz}", count=num_bins, offset=off).astype(np.int64)
    off += num_bins * off_sz
    rec_sz = config.ctr_record_bytes
    raw = np.frombuffer(data, dtype=np.uint8, count=n * rec_sz, offset=off).reshape(n, rec_sz)
    off += n * rec_sz
    sfx_b = config.ctr_suffix_bytes
    if sfx_b <= 8:
        padded = np.zeros((n, 8), dtype=np.uint8)
        padded[:, :sfx_b] = raw[:, :sfx_b]
        suffixes = padded.view("<u8").reshape(n)
    else:
        # 104-bit suffixes (PACKSIZE=64): (hi = bits 103..64, lo = bits 63..0)
        suffixes = np.zeros(n, dtype=W128)
        suffixes["lo"] = raw[:, :8].copy().view("<u8").reshape(n)
        hi_pad = np.zeros((n, 8), dtype=np.uint8)
        hi_pad[:, : sfx_b - 8] = raw[:, 8:sfx_b]
        suffixes["hi"] = hi_pad.view("<u8").reshape(n)
    ix_pad = np.zeros((n, 8), dtype=np.uint8)
    ix_pad[:, : config.ixtype_bytes] = raw[:, sfx_b:]
    ixs = ix_pad.view("<u8").reshape(n).astype(np.int64)
    labels, counts = _parse_label_tail(data[off:])
    return CtrData(wsz, isz, n, bin_ix, suffixes, ixs, labels, counts)
