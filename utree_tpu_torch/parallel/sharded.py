"""Sharded search: counterpart of `utree_tpu/parallel/sharded.py`, the three
modes of a (data, table) `mesh.ShardMesh`:

  replicated_search_step  data parallel: the reads split by rows over
                          `data`, each data row's through `lookup.search_step`
                          against a table held whole on its devices (the
                          bsearch records, c1, d1 or t1).
  sharded_search_step     the CTR records cut by 24-bit prefix range over
                          `table` (`ShardedIndex`): device (d, t) probes data
                          row d's reads against slice t, and the one-hot
                          results merge by a sum over `table`.
  long_read_histogram     one long read cut into chunks (`split_long_read`)
                          spread over every device: window ids, then a
                          per-label histogram, summed over the whole mesh.

One process drives every device.  On CPU devices the steps run the plain
twins of the JAX code; on CUDA devices the kernels:

  lookup.ascii_pack   -> K14 `csrc/ascii_pack.cu`
  shard_probe         -> K15 `csrc/bsearch_probe.cu`, bsearch_probe_shard
                         (plain: shard_probe_plain, over local_lookup_plain)
  label_histogram     -> K16 `csrc/label_histogram.cu`
                         (plain: label_histogram_plain)

and `search_step`'s K1, K4, K7 or K10.  A device the mesh names but the
machine lacks raises at the first copy; no shard moves to the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from utree_tpu_torch import kernels
from utree_tpu_torch._u32 import u32
from utree_tpu_torch.config import UTreeConfig
from utree_tpu_torch.hash_index import records, records_to_device
from utree_tpu_torch.index import DeviceIndexArrays
from utree_tpu_torch.lookup import (_records, _with_rc_words, ascii_pack,
                                    base_codes_packed, bsearch_descend, extract_windows,
                                    int32_miss, search_step, window_lanes)
from utree_tpu_torch.parallel.mesh import ShardMesh


def _per_shard(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{n} {what} do not divide over {parts} shards")
    return n // parts


def _in_row_order(mesh: ShardMesh, parts: list[torch.Tensor]) -> torch.Tensor:
    """The data shards' outputs, concatenated on the mesh's first device."""
    return torch.cat([p.to(mesh.devices[0]) for p in parts])


# ---- replicated table (data parallel) ---------------------------------------

def replicated_search_step(mesh: ShardMesh, index: DeviceIndexArrays, do_rc: bool = False):
    """`replicated_search_step` (sharded.py:46-71): returns step(tables,
    reads, lengths) -> (B, W') int32 ids in row order on the mesh's first
    device.  `tables` holds one table a device (`mesh.replicate(table)`);
    the B rows split over `data`, and data row d runs on its first device
    (d, 0): JAX's other devices of the row compute the same rows."""
    cfg = index.config
    kw = dict(k=cfg.packsize, do_rc=do_rc, probe_iters=index.probe_iters,
              bad_ix=cfg.bad_ix, num_labels=index.num_labels)
    d_rows, t_cols = mesh.shape

    def step(tables, reads, lengths):
        b = _per_shard(reads.shape[0], d_rows, "rows")
        out = []
        for d in range(d_rows):
            i = d * t_cols
            dev = mesh.devices[i]
            with mesh.on(i):
                out.append(search_step(tables[i], reads[d * b:(d + 1) * b].to(dev),
                                       lengths[d * b:(d + 1) * b].to(dev), **kw))
        return _in_row_order(mesh, out)

    return step


# ---- prefix-sharded table ------------------------------------------------------

@dataclasses.dataclass
class ShardedIndex:
    """Per-table-shard slices of the index, stacked on a leading shard axis
    (sharded.py:74-116).  Shard s owns prefixes [s*2^24/S, (s+1)*2^24/S);
    its records are [bin_ix[lo], bin_ix[hi]) of the global arrays.  The bin
    offsets are global and nondecreasing, so every bin's probe range lies
    in its shard, the compressor's merged bins included.  Slices shorter
    than the longest end in zero-suffix records of id bad_ix."""

    bin_ix: np.ndarray  # int32 (S, bins_per_shard+1), local offsets
    suf_hi: np.ndarray  # int32 (S, max_local+1)
    suf_lo: np.ndarray  # uint32 (S, max_local+1)
    ix: np.ndarray  # int32 (S, max_local+1)
    prefix_lo: np.ndarray  # int32 (S,), first owned prefix
    num_shards: int
    probe_iters: int
    config: UTreeConfig

    @classmethod
    def from_index(cls, index: DeviceIndexArrays, num_shards: int) -> "ShardedIndex":
        cfg = index.config
        num_prefixes = 1 << cfg.ctr_prefix_bits
        if num_prefixes % num_shards:
            raise ValueError("num_shards must divide 2^24")
        per = num_prefixes // num_shards
        gbin = index.bin_ix.astype(np.int64)
        lows = np.arange(num_shards) * per
        rec_lo = gbin[lows]
        rec_hi = gbin[lows + per]
        max_local = int((rec_hi - rec_lo).max()) if num_shards else 0
        s_bin = np.zeros((num_shards, per + 1), dtype=np.int32)
        s_hi = np.zeros((num_shards, max_local + 1), dtype=np.int32)
        s_lo = np.zeros((num_shards, max_local + 1), dtype=np.uint32)
        # bad_ix as its int32 bits (-1 for IXTYPE=u32, which NumPy 2.0
        # wraps to and newer NumPy refuses to put in np.full)
        s_ix = np.full((num_shards, max_local + 1),
                       np.uint32(cfg.bad_ix).view(np.int32), dtype=np.int32)
        for s in range(num_shards):
            a, b = int(rec_lo[s]), int(rec_hi[s])
            s_bin[s] = (gbin[lows[s]: lows[s] + per + 1] - a).astype(np.int32)
            s_hi[s, : b - a] = index.suf_hi[a:b]
            s_lo[s, : b - a] = index.suf_lo[a:b]
            s_ix[s, : b - a] = index.ix[a:b]
        return cls(bin_ix=s_bin, suf_hi=s_hi, suf_lo=s_lo, ix=s_ix,
                   prefix_lo=lows.astype(np.int32), num_shards=num_shards,
                   probe_iters=index.probe_iters, config=cfg)

    def slice_records(self, t: int) -> np.ndarray:
        """Slice t's records as K15 reads them (`hash_index.records`)."""
        return records(self.suf_hi[t], self.suf_lo[t], self.ix[t])

    def to_devices(self, mesh: ShardMesh) -> list[dict[str, torch.Tensor]]:
        """One `hash_index.records_to_device` dict a device: slice t's
        bin_ix and `slice_records(t)` on every device of mesh column t.
        Devices that are one device share one copy of a slice."""
        if mesh.shape[1] != self.num_shards:
            raise ValueError(f"{self.num_shards} table shards on a mesh of {mesh.shape}")
        copies: dict[tuple[int, torch.device], dict[str, torch.Tensor]] = {}
        out = []
        for i, dev in enumerate(mesh.devices):
            t = i % self.num_shards
            if (t, dev) not in copies:
                copies[(t, dev)] = records_to_device(self.bin_ix[t], self.slice_records(t), dev)
            out.append(copies[(t, dev)])
        return out


def local_lookup_plain(bin_ix, suf_hi, suf_lo, ix_arr, prefix_lo: int,
                       num_local_bins: int, qpre, qhi, qlo, valid, probe_iters: int,
                       bad_ix: int):
    """`_local_lookup` (sharded.py:130-157): the replay against one slice,
    with JAX's fixed `probe_iters` trips.  The prefix is taken relative to
    the slice's first; a lane outside its bins, or invalid, misses.
    Returns (where(found, ix, bad_ix) int32, found); suf_lo holds int32
    bits, compared unsigned."""
    suf_hi, suf_lo = suf_hi.to(torch.int64), u32(suf_lo)
    local = qpre - prefix_lo
    in_range = (local >= 0) & (local < num_local_bins) & valid
    lp = torch.where(in_range, local, 0)
    start = bin_ix[lp].to(torch.int64)
    end = bin_ix[lp + 1].to(torch.int64)
    empty = (start >= end) | ~in_range
    p = bsearch_descend(suf_hi, suf_lo, empty, start, end, qhi, qlo, probe_iters)
    found = (~empty) & (suf_hi[p] == qhi) & (suf_lo[p] == qlo)
    return torch.where(found, ix_arr[p].to(torch.int64), bad_ix).to(torch.int32), found


def _slice_args(table: dict):
    return table["bin_ix"], table["suf_hi"], table["suf_lo"], table["ix"]


def shard_probe_plain(table: dict, packed, vbits, lengths, *, prefix_lo: int,
                      width: int, do_rc: bool, probe_iters: int):
    """Plain version of K15: packed reads, the windows of their first
    `width` positions ([fwd | rc] with RC), against one slice ->
    (where(found, ix, 0) int32, found u8), each (B, 2W) or (B, W),
    W = width - 31."""
    codes = base_codes_packed(packed, vbits, lengths)[:, :width]
    lanes = _with_rc_words(*extract_windows(codes), do_rc)
    ix, found = local_lookup_plain(*_slice_args(table), prefix_lo,
                                   table["bin_ix"].shape[0] - 1, *lanes, probe_iters, 0)
    return ix, found.to(torch.uint8)


def shard_probe(table: dict, packed, vbits, lengths, *, prefix_lo: int, width: int,
                do_rc: bool, probe_iters: int):
    """K15 `bsearch_probe_shard` on CUDA tensors (which loops while a
    range is non-empty and reads no `probe_iters`); `shard_probe_plain` on
    CPU tensors.  K15 reads the slice's bin_ix and its records as `rec`
    (n + 1, 4), 16 B aligned (`ShardedIndex.to_devices` places both)."""
    if packed.device.type == "cpu":
        return shard_probe_plain(table, packed, vbits, lengths, prefix_lo=prefix_lo,
                                 width=width, do_rc=do_rc, probe_iters=probe_iters)
    dev = packed.device
    kernels.require(packed, "packed", torch.uint8, 2, dev)
    kernels.require(vbits, "vbits", torch.uint8, 2, dev)
    kernels.require(lengths, "lengths", torch.int32, 1, dev)
    bin_ix, rec, n = _records(table, "K15", dev)
    b, row4 = packed.shape
    row8 = vbits.shape[1]
    if lengths.shape[0] != b or vbits.shape[0] != b or row8 * 2 != row4:
        raise ValueError("packed/vbits/lengths shapes disagree")
    if bin_ix.shape[0] < 2:
        raise ValueError("bin_ix must hold a slice's bin offsets and its end")
    w = width - 31
    if w <= 0 or width > row4 * 4:
        raise ValueError(f"width {width} is no window width of {row4 * 4} positions")
    cols = 2 * w if do_rc else w
    ix = torch.empty((b, cols), dtype=torch.int32, device=dev)
    found = torch.empty((b, cols), dtype=torch.uint8, device=dev)
    kernels.launch("bsearch_probe_shard", packed.data_ptr(), vbits.data_ptr(),
                   lengths.data_ptr(), b, row4, row8, w, bin_ix.data_ptr(),
                   rec.data_ptr(), n, prefix_lo, bin_ix.shape[0] - 1, int(do_rc),
                   ix.data_ptr(), found.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return ix, found


def _probe_slice(table: dict, reads, lengths, *, prefix_lo: int, k: int, do_rc: bool,
                 probe_iters: int, bad_ix: int):
    """One device's part of the prefix-sharded step: (where(found, ix, 0),
    found as int32).  CPU: `window_lanes` and `local_lookup_plain`, as
    JAX; CUDA: K14, then K15 over JAX's W = L-31 windows."""
    if reads.device.type == "cpu":
        lanes = window_lanes(reads, lengths, k, do_rc)
        int32_miss(bad_ix)
        ix, found = local_lookup_plain(*_slice_args(table), prefix_lo,
                                       table["bin_ix"].shape[0] - 1, *lanes,
                                       probe_iters, bad_ix)
        return torch.where(found, ix, 0), found.to(torch.int32)
    if k != 32:
        raise NotImplementedError("extract_windows implements the 32-mer geometry")
    if reads.shape[1] - 31 <= 0:
        raise ValueError("reads shorter than k after padding")
    int32_miss(bad_ix)
    packed, vbits = ascii_pack(reads, lengths)
    ix, found = shard_probe(table, packed, vbits, lengths, prefix_lo=prefix_lo,
                            width=reads.shape[1], do_rc=do_rc, probe_iters=probe_iters)
    return ix, found.to(torch.int32)


def sharded_search_step(mesh: ShardMesh, sharded: ShardedIndex, do_rc: bool = False):
    """`sharded_search_step` (sharded.py:160-196): returns step(tables,
    reads, lengths) -> (B, W') int32 ids in row order on the mesh's first
    device.  `tables` is `sharded.to_devices(mesh)`.  The rows split over
    `data`; every device of data row d probes all of that row's reads
    against its slice, and the results sum over `table`: where(found_any,
    sum of where(found, ix, 0), bad_ix).  A word is found in one slice at
    most, and a stored bad_ix counts as found, so it comes through the sum."""
    cfg = sharded.config
    kw = dict(k=cfg.packsize, do_rc=do_rc, probe_iters=sharded.probe_iters,
              bad_ix=cfg.bad_ix)
    d_rows, t_cols = mesh.shape
    if t_cols != sharded.num_shards:
        raise ValueError(f"{sharded.num_shards} table shards on a mesh of {mesh.shape}")

    def step(tables, reads, lengths):
        b = _per_shard(reads.shape[0], d_rows, "rows")
        ixs, founds = [], []
        for i, dev in enumerate(mesh.devices):
            d, t = divmod(i, t_cols)
            with mesh.on(i):
                ix, found = _probe_slice(tables[i], reads[d * b:(d + 1) * b].to(dev),
                                         lengths[d * b:(d + 1) * b].to(dev),
                                         prefix_lo=int(sharded.prefix_lo[t]), **kw)
            ixs.append(ix)
            founds.append(found)
        out = []
        for d, (ix_sum, f_sum) in enumerate(zip(mesh.reduce(ixs, "table"),
                                                mesh.reduce(founds, "table"))):
            with mesh.on(d * t_cols):
                out.append(torch.where(f_sum > 0, ix_sum, cfg.bad_ix))
        return _in_row_order(mesh, out)

    return step


# ---- sequence-parallel long reads ---------------------------------------------

def label_histogram_plain(ids: torch.Tensor, num_labels: int) -> torch.Tensor:
    """Plain version of K16: `hist.at[where(ix < num_labels, ix,
    num_labels)].add(1)[:num_labels]` (sharded.py:215-218) over every id.
    JAX's `.at[]` wraps a negative slot once by num_labels + 1 and drops
    what still lies outside."""
    ix = ids.reshape(-1).to(torch.int64)
    slot = torch.where(ix < num_labels, ix, num_labels)
    slot = torch.where(slot < 0, slot + num_labels + 1, slot)
    keep = (slot >= 0) & (slot < num_labels)
    return torch.bincount(slot[keep], minlength=num_labels).to(torch.int32)


def label_histogram(ids: torch.Tensor, num_labels: int) -> torch.Tensor:
    """K16 `label_histogram` on CUDA tensors; `label_histogram_plain` on
    CPU tensors."""
    if ids.device.type == "cpu":
        return label_histogram_plain(ids, num_labels)
    dev = ids.device
    kernels.require(ids, "ids", torch.int32, 2, dev)
    if not 1 <= num_labels < (1 << 31):
        raise ValueError(f"num_labels {num_labels} out of range")
    hist = torch.empty(num_labels, dtype=torch.int32, device=dev)
    kernels.launch("label_histogram", ids.data_ptr(), ids.numel(), num_labels,
                   hist.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    return hist


def long_read_histogram(mesh: ShardMesh, index: DeviceIndexArrays, num_labels: int,
                        do_rc: bool = False):
    """`long_read_histogram` (sharded.py:199-228): returns step(tables,
    chunks, chunk_lens) -> (num_labels,) int32 hit counts on the mesh's
    first device.  The D chunks of `split_long_read` spread over all the
    mesh's devices in order (JAX's P(("data", "table"))), D/(mesh size) a
    device; each device looks up its windows in its copy of the bsearch
    records (`tables`, one a device), counts them by label, and the counts
    sum over the whole mesh."""
    cfg = index.config
    kw = dict(k=cfg.packsize, do_rc=do_rc, probe_iters=index.probe_iters,
              bad_ix=cfg.bad_ix)

    def step(tables, chunks, chunk_lens):
        per = _per_shard(chunks.shape[0], mesh.size, "chunks")
        hists = []
        for i, dev in enumerate(mesh.devices):
            if "bin_ix" not in tables[i]:
                raise KeyError("bin_ix")  # JAX's lookup_kmers reads the records
            with mesh.on(i):
                ids = search_step(tables[i], chunks[i * per:(i + 1) * per].to(dev),
                                  chunk_lens[i * per:(i + 1) * per].to(dev), **kw)
                hists.append(label_histogram(ids, num_labels))
        return mesh.reduce(hists)[0]

    return step


def split_long_read(seq: bytes, num_chunks: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Cut one read into overlapping chunks.

    Chunk d covers window starts [d*C, (d+1)*C) so it needs bases
    [d*C, (d+1)*C + k - 1).  Returns (chunks (D, C+k-1) uint8, lens (D,))."""
    n = len(seq)
    w = max(0, n - k + 1)
    c = -(-max(w, 1) // num_chunks)
    width = c + k - 1
    chunks = np.zeros((num_chunks, width), dtype=np.uint8)
    lens = np.zeros(num_chunks, dtype=np.int32)
    arr = np.frombuffer(seq, dtype=np.uint8)
    for d in range(num_chunks):
        a = d * c
        b = min(n, a + width)
        if a < n:
            chunks[d, : b - a] = arr[a:b]
            lens[d] = b - a
    return chunks, lens
