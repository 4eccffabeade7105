"""End-to-end GG search on one device: counterpart of `utree_tpu/pipeline.py`.

The slice ported here is the product's main path:

  host:   the C++ FASTA scanner packs reads to 2 bits (shared native code);
  device: one step per batch -- K1 scan_probe (windows, canonical keys,
          displaced probe), K2 histogram, K3 aufbau_vote -- returning
          12 B/read vote rows (lookup.search_step_vote_compact);
  host:   the shared C formatter writes the lines; reads the device flagged
          (more unique labels than hist_cap, or fields too wide) are
          replayed exactly on the host first.

Batches are dispatched asynchronously: the rows of a finished batch start
their device->host copy into pinned memory at once, and the drain waits on
that copy's CUDA event, `queue_depth` batches later.  Output bytes equal the
JAX pipeline's in `lookup_mode="displaced"` with the device vote on, which
equal the reference binary's.

Everything outside the slice raises NotImplementedError naming its ROADMAP
item; nothing falls back silently.
"""

from __future__ import annotations

import pathlib

import numpy as np
import torch

from utree_tpu.index import DeviceIndexArrays
from utree_tpu_torch.lookup import search_step_vote_compact

_TODO = {
    "canonical": "the canonical ladder (ROADMAP A.7)",
    "hash": "the legacy two-table hash (ROADMAP A.8)",
    "bsearch": "the bsearch replay (ROADMAP A.8)",
    "routed": "routed shards across GPUs (ROADMAP A.9)",
}


def _bucket_len64(n: int, minimum: int = 64) -> int:
    """Batch width: a multiple of 64 (pow2 above 2048), as utree_tpu.pipeline."""
    if n > 2048:
        b = 4096
        while b < n:
            b *= 2
        return b
    return max(minimum, (n + 63) & ~63)


class _Readback:
    """One dispatched batch: its (B, 3) vote rows, on their way to the host.
    On CUDA `rows` is a pinned host tensor filled by a non-blocking copy that
    `event` marks done; on the CPU the rows are already there."""

    def __init__(self, rows: torch.Tensor, event=None):
        self.rows = rows
        self.event = event

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.rows.numpy()


class SearchPipeline:
    long_read_threshold = 1 << 14
    # file pieces the C++ scanner reads at a time (search RSS is O(chunk))
    stream_chunk_bytes = 32 << 20

    def __init__(self, index: DeviceIndexArrays, *, device="cuda",
                 do_rc: bool = False, batch_size: int = 8192,
                 hist_cap: int = 8, lookup_mode: str = "auto",
                 support_ranges: int = 1, devices: int | None = None,
                 tracer=None, _table: dict | None = None):
        cfg = index.config
        if not 1 <= hist_cap <= 30:
            raise ValueError(
                f"hist_cap={hist_cap} out of range: the packed device "
                "histogram carries nuniq in 5 bits (valid caps are 1..30)")
        if lookup_mode in _TODO:
            raise NotImplementedError(
                f"--lookup-mode {lookup_mode}: {_TODO[lookup_mode]} is not "
                "ported yet; use auto or displaced")
        if lookup_mode not in ("auto", "displaced"):
            raise ValueError(f"unknown lookup_mode {lookup_mode!r}")
        if devices is not None and devices > 1:
            raise NotImplementedError(
                "devices > 1 (data parallel over GPUs) is not ported yet "
                "(ROADMAP A.9)")
        if cfg.packsize != 32:
            raise NotImplementedError(
                f"PACKSIZE={cfg.packsize}: only the 32-mer device path is "
                "ported (PACKSIZE=64 is ROADMAP A.8)")
        if index.num_labels >= 0xFFFF:
            raise NotImplementedError(
                "wide labels (IXTYPE=u32, >= 65535 labels) are not ported yet "
                "(ROADMAP A.7)")
        if support_ranges != 1:
            raise NotImplementedError(
                "support_ranges=8 (per-rank SUPPORT;RANGE columns) is not "
                "ported yet (ROADMAP A.6)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False")

        from utree_tpu.classify_device import build_aufbau_tables
        from utree_tpu.native import VoteEngine, fasta_lib

        eng = VoteEngine(index.strings, cfg.taxacut)
        if not eng.available or fasta_lib() is None:
            raise RuntimeError(
                "the native vote formatter / FASTA scanner did not build "
                "(utree_tpu.native needs g++); the port has no Python path")
        self._vote_engine = eng
        vtab = build_aufbau_tables(index.strings)
        if vtab.max_len > 2047:
            raise NotImplementedError(
                "label strings of 2048+ chars do not fit the device vote's "
                "11-bit dv lane; the host-vote layout is ROADMAP A.7")

        self.index = index
        self.do_rc = do_rc
        self.batch_size = batch_size
        self.hist_cap = hist_cap
        self.lookup_mode = lookup_mode
        self.tracer = tracer
        if _table is None:
            from utree_tpu.hash_index import build_displaced_index
            from utree_tpu_torch.hash_index import displaced_to_device

            try:
                disp = build_displaced_index(index)
            except (ValueError, RuntimeError) as e:
                raise RuntimeError(
                    f"--lookup-mode displaced cannot be honored: {e}") from e
            _table = displaced_to_device(disp, self.device)
        if "d1" not in _table:
            raise ValueError("_table must hold the displaced table (d1/ds/d3)")
        table = {k: v.to(self.device) for k, v in _table.items()}
        if not any(k.startswith("vt_") for k in table):
            from utree_tpu_torch.classify_device import aufbau_tables_to_device

            table.update({"vt_" + k: v for k, v in
                          aufbau_tables_to_device(vtab, self.device).items()})
        self._table = table
        self._step_kw = dict(
            do_rc=do_rc,
            # any miss sentinel >= num_labels is equivalent (the histogram
            # only tests ix < num_labels); keep it inside int32
            bad_ix=min(cfg.bad_ix, 0x7FFFFFFF),
            num_labels=index.num_labels, cap=hist_cap, taxacut=cfg.taxacut,
            max_iters=(vtab.max_len + 4) * (hist_cap + 2) + 16)

    @property
    def table_kind(self) -> str:
        return "displaced"

    # ---- device dispatch -------------------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def dispatch_packed(self, packed: np.ndarray, vbits: np.ndarray,
                        lens: np.ndarray) -> _Readback:
        """Dispatch 2-bit-packed reads (e.g. from the C++ scanner) and start
        the copy of their vote rows to the host.  The window count is trimmed
        to the batch's true max read length, rounded up to 8."""
        k = self.index.config.packsize
        tl = int(lens.max()) if len(lens) else k
        tl = min(max(k, (tl + 7) & ~7), packed.shape[1] * 4)
        rows = search_step_vote_compact(
            self._table, self._to_device(packed), self._to_device(vbits),
            self._to_device(lens.astype(np.int32)), true_len=tl, **self._step_kw)
        if self.device.type == "cpu":
            return _Readback(rows)
        host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
        host.copy_(rows, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return _Readback(host, event)

    # ---- host-side exact replay of flagged reads ---------------------------

    def _host_hits(self, seq: bytes) -> np.ndarray:
        """Every hit label id of one read (forward + RC when do_rc), by the
        exact xtSuffixBS replay on the host arrays (itree.c:699-730)."""
        from utree_tpu.encode import search_window_words

        cfg = self.index.config
        words = search_window_words(seq, cfg.packsize, self.do_rc)
        if len(words) == 0:
            return np.zeros(0, np.int64)
        idx = self.index
        suffixes = ((idx.suf_hi[:-1].astype(np.uint64) << np.uint64(32))
                    | idx.suf_lo[:-1].astype(np.uint32).astype(np.uint64))
        qpre = (words >> np.uint64(cfg.ctr_suffix_bits)).astype(np.int64)
        qsuf = words & np.uint64(cfg.suffix_mask)
        start = idx.bin_ix[qpre].astype(np.int64)
        end = idx.bin_ix[qpre + 1].astype(np.int64)
        empty = start >= end
        p = np.where(empty, 0, start)
        size = np.where(empty, 0, end - start - 1)
        while (size > 0).any():
            active = size > 0
            w = size >> 1
            probe = np.minimum(p + w + 1, len(suffixes) - 1)
            le = active & (suffixes[probe] <= qsuf)
            p = np.where(le, p + w + 1, p)
            size = np.where(active, np.where(le, size - w - 1, w), size)
        found = (~empty) & (suffixes[np.minimum(p, len(suffixes) - 1)] == qsuf)
        hits = idx.ix[:-1][p[found]]
        return hits[hits < idx.num_labels]

    # ---- vote rows -> lines --------------------------------------------------

    def _devvote_rows(self, handle: _Readback, count: int) -> np.ndarray:
        """(count, 3) uint32 device-vote rows."""
        if self.tracer is not None:
            with self.tracer.phase("drain:d2h-wait"):
                arr = handle.wait()
        else:
            arr = handle.wait()
        return arr.view(np.uint32).reshape(-1, 3)[:count]

    def _format_devvote(self, count, name_pool, name_offsets, handle,
                        seq_of) -> bytes:
        """Drain one batch: replay the flagged reads on the host into an
        override CSR, then format every line in C."""
        u = self._devvote_rows(handle, count)
        flags = np.flatnonzero((u[:, 0] >> 24) & 1).astype(np.int64)
        over_offsets = np.zeros(len(flags) + 1, np.int64)
        ols, ocs = [], []
        for j, i in enumerate(flags):
            cnt = np.bincount(self._host_hits(seq_of(int(i))))
            nz = np.flatnonzero(cnt)
            ols.append(nz.astype(np.int32))
            ocs.append(cnt[nz].astype(np.int32))
            over_offsets[j + 1] = over_offsets[j] + len(nz)
        over_labels = np.concatenate(ols) if ols else np.zeros(0, np.int32)
        over_counts = np.concatenate(ocs) if ocs else np.zeros(0, np.int32)
        args = (count, name_pool, name_offsets, u, flags, over_offsets,
                over_labels, over_counts)
        if self.tracer is not None:
            with self.tracer.phase("drain:vote"):
                return self._vote_engine.format_device_vote(*args)
        return self._vote_engine.format_device_vote(*args)

    # ---- streaming search -----------------------------------------------------

    def _iter_fasta_pieces(self, reads_path: str, tm):
        """FastaScanner pieces covering the file in order, cut at record
        boundaries ('\\n>'); .gz inputs stream through zlib."""
        from utree_tpu.native import FastaScanner

        chunk_bytes = max(1 << 16, self.stream_chunk_bytes)
        if str(reads_path).endswith(".gz"):
            import gzip

            opener = gzip.open
        else:
            opener = open
        with opener(reads_path, "rb") as f:
            tail = b""
            while True:
                with tm.phase("scan"):
                    chunk = f.read(chunk_bytes)
                if not chunk:
                    if tail:
                        with tm.phase("scan"):
                            sc = FastaScanner(tail)
                        yield sc
                    return
                data = tail + chunk
                if len(chunk) == chunk_bytes:
                    cut = data.rfind(b"\n>")
                    if cut == -1:
                        tail = data  # one record spans the chunk: keep growing
                        continue
                    piece, tail = data[: cut + 1], data[cut + 1:]
                else:
                    piece, tail = data, b""
                if piece:
                    with tm.phase("scan"):
                        sc = FastaScanner(piece)
                    yield sc

    def search_file(self, reads_path: str, out_path: str, queue_depth: int = 3,
                    resume: bool = False,
                    record_range: tuple[int, int] | None = None) -> int:
        """Stream reads -> classifications; returns the number of records
        processed.  resume=True continues an interrupted run from the last
        committed batch (sidecar <out>.ckpt); record_range=(lo, hi) processes
        only that slice of the file's records.  Output bytes equal an
        uninterrupted run's and the JAX pipeline's."""
        from utree_tpu.utils.checkpoint import SearchCheckpoint
        from utree_tpu.utils.trace import PhaseTimer

        tm = self.tracer if self.tracer is not None else PhaseTimer(quiet=True)
        ckpt = SearchCheckpoint(out_path)
        skip, out_bytes = ckpt.load() if resume else (0, 0)
        range_lo, range_hi = record_range if record_range is not None else (0, None)
        skip += range_lo  # ckpt's `done` counts records from the range start
        mode = "r+b" if resume and pathlib.Path(out_path).exists() else "wb"
        pending: list[tuple] = []
        threshold = self.long_read_threshold
        packsize = self.index.config.packsize

        def batches():
            # batches accumulate across piece boundaries; a partial batch is
            # dispatched only at EOF
            r_global = 0
            spans: list[tuple] = []  # (scanner, start, count) of this batch
            acc = 0
            maxlen = 0

            def flush():
                nonlocal spans, acc, maxlen
                if not acc:
                    return None
                lmax = max(_bucket_len64(maxlen), packsize)
                with tm.phase("pack"):
                    pools, offs = [], []
                    row = shift = 0
                    packed = np.zeros((self.batch_size, lmax // 4), np.uint8)
                    vbits = np.zeros((self.batch_size, lmax // 8), np.uint8)
                    lens = np.zeros(self.batch_size, np.int32)
                    for sc, start, count in spans:
                        p2, v2, l2, npool, noffs = sc.pack_2bit(start, count, lmax)
                        packed[row:row + count] = p2
                        vbits[row:row + count] = v2
                        lens[row:row + count] = l2[:count]
                        pools.append(npool)
                        offs.append(noffs[:-1] + shift)
                        shift += len(npool)
                        row += count
                    item = ("batch", spans, acc, (packed, vbits, lens),
                            b"".join(pools), np.concatenate(offs))
                spans, acc, maxlen = [], 0, 0
                return item

            for sc in self._iter_fasta_pieces(reads_path, tm):
                if range_hi is not None and r_global >= range_hi:
                    break
                n_piece = sc.num_records
                lens_all = sc.seq_lengths()
                r = 0
                while r < n_piece:
                    if range_hi is not None and r_global >= range_hi:
                        break
                    if r_global < skip:  # resume / range: skip records
                        adv = int(min(n_piece - r, skip - r_global))
                        r += adv
                        r_global += adv
                        continue
                    if lens_all[r] > threshold:
                        raise NotImplementedError(
                            f"read {r_global} is {int(lens_all[r])} bp, longer "
                            f"than long_read_threshold={threshold}: long reads "
                            "(pack_hist + split_long_read) are ROADMAP A.7")
                    e = r
                    lim = self.batch_size - acc
                    while (e < n_piece and e - r < lim
                           and lens_all[e] <= threshold):
                        if range_hi is not None and r_global + (e - r) >= range_hi:
                            break
                        e += 1
                    count = e - r
                    if count:
                        spans.append((sc, r, count))
                        acc += count
                        maxlen = max(maxlen, int(lens_all[r:e].max()))
                        r = e
                        r_global += count
                    if acc >= self.batch_size:
                        yield flush()
            b = flush()
            if b is not None:
                yield b
            yield ("eof", min(r_global, range_hi) if range_hi is not None else r_global)

        with open(out_path, mode) as fo:
            fo.truncate(out_bytes)
            fo.seek(out_bytes)
            done = skip

            def row_seq(spans, i):
                for sc, start, count in spans:
                    if i < count:
                        return sc.record_seq(start + i)
                    i -= count
                raise IndexError(i)

            def drain(block: bool):
                nonlocal done
                while pending and (block or len(pending) >= queue_depth):
                    spans, count, h, npool, noffs = pending.pop(0)
                    with tm.phase("drain+vote"):
                        lines = self._format_devvote(
                            count, npool, noffs, h,
                            lambda i, spans=spans: row_seq(spans, i))
                    with tm.phase("write"):
                        fo.write(lines)
                        fo.flush()
                        done += count
                        ckpt.commit(done - range_lo, fo.tell())

            n = skip
            for item in batches():
                if item[0] == "eof":
                    n = item[1]
                    break
                _, spans, count, arrays, npool, noffs = item
                with tm.phase("dispatch"):
                    handle = self.dispatch_packed(*arrays)
                pending.append((spans, count, handle, npool, noffs))
                drain(block=False)
            drain(block=True)
        ckpt.finish()
        tm.count("reads", n - skip)
        return n - range_lo
