"""End-to-end GG search on one device: counterpart of `utree_tpu/pipeline.py`.

  host:   the C++ FASTA scanner packs reads to 2 bits (PACKSIZE=32) or to
          an ASCII (B, L) matrix (PACKSIZE=64) (shared native code);
  device: one step per batch over the table `lookup_mode` resolves to, as
          the JAX pipeline resolves it.  PACKSIZE=32: the canonical ladder
          (K4 ladder_probe) below 80M records under `auto`, the displaced
          table (K1 scan_probe) from 80M, `_wide` kernels for IXTYPE=u32
          labels, and the bsearch replay over the CTR records (K7
          bsearch_probe) when asked for or when `auto` finds neither table
          fits a DB below 80M records.  PACKSIZE=64: the 64-mer ladder (K6
          ladder_probe64) below 80M records, the 64-mer displaced table (K5
          scan_probe64) from 80M or when asked for;
  readback, by the JAX pipeline's step choice:
          PACKSIZE=32, narrow labels of <= 2047 chars: K2 histogram + K3
            aufbau_vote, 12 B/read vote rows (lookup.search_step_vote_compact);
          PACKSIZE=32, narrow labels of 2048+ chars: K2 histogram_packed,
            (B, cap+1) rows voted by the shared C `VoteEngine.vote_packed`;
          wide labels, and PACKSIZE=64 at any label width: K2
            histogram_unpacked, (B, 2*cap+2) rows voted by
            `VoteEngine.vote_batch_pooled`;
  host:   reads the device flagged (more unique labels than hist_cap, or
          fields too wide) are replayed exactly on the host; the shared C
          formatter writes the lines.

Reads over `long_read_threshold` are cut into chunks (`split_long_read`)
whose histograms go through the histogram step, merge on the host and take
one vote (`classify_long_read`).

Batches are dispatched asynchronously: the rows of a finished batch start
their device->host copy into pinned memory at once, and the drain waits on
that copy's CUDA event, `queue_depth` batches later.  Output bytes equal the
JAX pipeline's in every layout.

Not ported yet, each raising NotImplementedError that names its ROADMAP
item (nothing falls back silently): the modes in `_TODO`, `devices > 1`
(A.9) and `support_ranges=8` (A.6).
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np
import torch

from utree_tpu.index import DeviceIndexArrays
from utree_tpu_torch.lookup import (WIDE_LABELS, pack_reads_host,
                                    search_step_hist,
                                    search_step_hist_packed,
                                    search_step_hist_packed_in,
                                    search_step_vote_compact)

_TODO = {
    "hash": "the legacy two-table hash (ROADMAP A.8)",
    "routed": "routed shards across GPUs (ROADMAP A.9)",
}
_MODES = ("auto", "canonical", "displaced", "bsearch")
# `auto` table choice, as utree_tpu.pipeline resolves it: the displaced
# table from _DISPLACED_AUTO_MIN records (the ladder below); at PACKSIZE=32
# the device tables only below _HASH_AUTO_MAX records, and the bsearch
# replay never from _REPLAY_AUTO_MAX on.  All three were tuned on a TPU
# (ROADMAP A.11).
_DISPLACED_AUTO_MIN = 80_000_000
_HASH_AUTO_MAX = 400_000_000
_REPLAY_AUTO_MAX = 80_000_000
_TABLE_KINDS = (("d1", "displaced"), ("c1", "canonical"),
                ("c64_1", "canonical64"), ("d64_1", "displaced64"),
                ("bin_ix", "bsearch"))


def _bucket_len(n: int, minimum: int = 64) -> int:
    """Round up to a power of two (the long-read chunk count)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _bucket_len64(n: int, minimum: int = 64) -> int:
    """Batch width: a multiple of 64 (pow2 above 2048), as utree_tpu.pipeline."""
    if n > 2048:
        return _bucket_len(n, 4096)
    return max(minimum, (n + 63) & ~63)


class _Readback:
    """One dispatched batch: its int32 rows, on their way to the host.  On
    CUDA `rows` is a pinned host tensor filled by a non-blocking copy that
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
    long_chunk = 1 << 14
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
        if cfg.packsize == 64 and lookup_mode not in ("auto", "canonical", "displaced"):
            # don't silently ignore an explicit table-layout request
            raise ValueError(
                f"--lookup-mode {lookup_mode!r} is unsupported for "
                "PACKSIZE=64; device paths are the canonical hash and "
                "the seeded-displacement table")
        if lookup_mode in _TODO:
            raise NotImplementedError(
                f"--lookup-mode {lookup_mode}: {_TODO[lookup_mode]} is not "
                "ported yet; use " + ", ".join(_MODES))
        if lookup_mode not in _MODES:
            raise ValueError(f"unknown lookup_mode {lookup_mode!r}")
        if devices is not None and devices > 1:
            raise NotImplementedError(
                "devices > 1 (data parallel over GPUs) is not ported yet "
                "(ROADMAP A.9)")
        if cfg.packsize not in (32, 64):
            raise NotImplementedError(
                f"PACKSIZE={cfg.packsize}: the port runs the 32-mer and "
                "64-mer device paths only")
        if support_ranges != 1:
            raise NotImplementedError(
                "support_ranges=8 (per-rank SUPPORT;RANGE columns) is not "
                "ported yet (ROADMAP A.6)")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False")

        from utree_tpu.native import VoteEngine, fasta_lib

        eng = VoteEngine(index.strings, cfg.taxacut)
        if not eng.available or fasta_lib() is None:
            raise RuntimeError(
                "the native vote formatter / FASTA scanner did not build "
                "(utree_tpu.native needs g++); the port has no Python path")
        self._vote_engine = eng
        self.index = index
        self.do_rc = do_rc
        self.batch_size = batch_size
        self.hist_cap = hist_cap
        self.lookup_mode = lookup_mode
        self.tracer = tracer
        # reads travel 2-bit packed at PACKSIZE=32 and as ASCII at 64; the
        # u16-packed histogram lanes need narrow labels and packed input
        # (utree_tpu/pipeline.py:314-315)
        self._packed = cfg.packsize == 32
        packed_out = self._packed and index.num_labels < WIDE_LABELS
        vtab = None
        if packed_out:
            from utree_tpu.classify_device import build_aufbau_tables

            vtab = build_aufbau_tables(index.strings)
        # the readback layout (utree_tpu/pipeline.py:314-394): the device vote
        # needs u16 label lanes and labels that fit its 11-bit dv lane
        if not packed_out:
            self.layout = "unpacked"
        elif vtab.max_len <= 2047:
            self.layout = "vote"
        else:
            self.layout = "packed"
        if _table is None:
            _table = self._build_table(index, lookup_mode)
        if not any(k in _table for k, _ in _TABLE_KINDS):
            raise ValueError("_table must hold a device table: "
                             + ", ".join(k for k, _ in _TABLE_KINDS))
        table = {k: v.to(self.device) for k, v in _table.items()}
        # any miss sentinel >= num_labels is equivalent (the histogram only
        # tests ix < num_labels); keep it inside int32
        kw = dict(do_rc=do_rc, bad_ix=min(cfg.bad_ix, 0x7FFFFFFF),
                  num_labels=index.num_labels, cap=hist_cap)
        if not self._packed:
            hist = search_step_hist
        else:
            kw["probe_iters"] = index.probe_iters
            hist = search_step_hist_packed if packed_out else search_step_hist_packed_in
        # long-read chunks need per-chunk histograms, merged on the host
        # before one vote, whatever the main step returns
        self._step_hist = functools.partial(hist, **kw)
        if self.layout == "vote":
            if not any(k.startswith("vt_") for k in table):
                from utree_tpu_torch.classify_device import aufbau_tables_to_device

                table.update({"vt_" + k: v for k, v in
                              aufbau_tables_to_device(vtab, self.device).items()})
            max_iters = (vtab.max_len + 4) * (hist_cap + 2) + 16
            self._step = functools.partial(search_step_vote_compact,
                                           taxacut=cfg.taxacut,
                                           max_iters=max_iters, **kw)
        else:
            self._step = self._step_hist
        self._table = table

    def _build_table(self, index: DeviceIndexArrays, mode: str) -> dict:
        """The device table `mode` resolves to, as utree_tpu/pipeline.py:180-288
        resolves it, with its exception types and messages; the shared numpy
        code places the hash tables."""
        from utree_tpu_torch import hash_index as hi

        n = index.num_records
        want_displaced = mode == "displaced" or (
            mode == "auto" and n >= _DISPLACED_AUTO_MIN)
        if index.config.packsize == 64:
            from utree_tpu.hash_index64 import (build_canonical_hash_index64,
                                                build_displaced_index64)

            if want_displaced:
                try:
                    return hi.displaced64_to_device(build_displaced_index64(index),
                                                    self.device)
                except (ValueError, RuntimeError) as e:
                    if mode == "displaced":
                        raise RuntimeError(
                            f"--lookup-mode displaced cannot be honored: {e}") from e
            try:
                return hi.canonical64_to_device(build_canonical_hash_index64(index),
                                                self.device)
            except (ValueError, RuntimeError) as e:
                raise RuntimeError(
                    "PACKSIZE=64 device search needs the canonical hash "
                    f"table, which this DB cannot build ({e}); use the "
                    "host path (search --host)") from e
        from utree_tpu.hash_index import (build_canonical_hash_index,
                                          build_displaced_index)

        if mode in ("canonical", "displaced") or (
                mode == "auto" and n < _HASH_AUTO_MAX):
            if want_displaced:
                try:
                    return hi.displaced_to_device(build_displaced_index(index),
                                                  self.device)
                except (ValueError, RuntimeError) as e:
                    if mode == "displaced":
                        raise RuntimeError(
                            f"--lookup-mode displaced cannot be honored: {e}") from e
            try:
                return hi.canonical_to_device(build_canonical_hash_index(index),
                                              self.device)
            except (ValueError, RuntimeError) as e:
                if mode == "canonical":
                    raise RuntimeError(
                        f"--lookup-mode canonical cannot be honored: {e}") from e
                # neither device table fits: only a DB below the replay
                # ceiling may quietly take the bsearch replay
                if n >= _REPLAY_AUTO_MAX:
                    raise RuntimeError(
                        f"this DB ({n:,} records) fits no single-chip device "
                        f"table ({e}); shard it across chips with --devices N "
                        "--lookup-mode routed, or force the ~15x-slower replay "
                        "explicitly with --lookup-mode bsearch") from e
                return hi.bsearch_to_device(index, self.device)
        # explicit --lookup-mode bsearch, or auto beyond the device tables'
        # ceiling, which must not be served at replay speed without asking
        if mode == "auto" and n >= _REPLAY_AUTO_MAX:
            raise RuntimeError(
                f"this DB ({n:,} records) exceeds the single-chip device-table "
                "ceiling; shard it across chips with --devices N --lookup-mode "
                "routed, or force the ~15x-slower replay explicitly with "
                "--lookup-mode bsearch")
        return hi.bsearch_to_device(index, self.device)

    @property
    def table_kind(self) -> str:
        """'displaced', 'canonical', 'canonical64', 'displaced64' or
        'bsearch', as utree_tpu.pipeline names the table it resolved to."""
        return next(kind for key, kind in _TABLE_KINDS if key in self._table)

    # ---- device dispatch -------------------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cpu":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _readback(self, rows: torch.Tensor) -> _Readback:
        """Start the copy of a batch's rows to the host."""
        if self.device.type == "cpu":
            return _Readback(rows)
        host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
        host.copy_(rows, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return _Readback(host, event)

    def dispatch_packed(self, packed: np.ndarray, vbits: np.ndarray,
                        lens: np.ndarray, step=None) -> _Readback:
        """Dispatch 2-bit-packed reads (e.g. from the C++ scanner) through
        `step` (default: the main step) and start the copy of their rows to
        the host.  The window count is trimmed to the batch's true max read
        length, rounded up to 8."""
        k = self.index.config.packsize
        tl = int(lens.max()) if len(lens) else k
        tl = min(max(k, (tl + 7) & ~7), packed.shape[1] * 4)
        return self._readback((step or self._step)(
            self._table, self._to_device(packed), self._to_device(vbits),
            self._to_device(lens.astype(np.int32)), true_len=tl))

    def dispatch_matrix(self, reads: np.ndarray, lengths: np.ndarray,
                        step=None) -> _Readback:
        """Dispatch an ASCII (B, L) batch: 2-bit packed on the host at
        PACKSIZE=32, as ASCII at PACKSIZE=64, whose step reads all L - 63
        windows (utree_tpu/pipeline.py:468-480)."""
        if self._packed:
            if reads.shape[1] % 8:
                reads = np.pad(reads, ((0, 0), (0, 8 - reads.shape[1] % 8)))
            return self.dispatch_packed(*pack_reads_host(reads, lengths), step=step)
        return self._readback((step or self._step)(
            self._table, self._to_device(reads),
            self._to_device(lengths.astype(np.int32))))

    # ---- host-side exact replay of flagged reads ---------------------------

    def _host_hits(self, seq: bytes) -> np.ndarray:
        """Every hit label id of one read (forward + RC when do_rc), by the
        exact xtSuffixBS replay on the host arrays (itree.c:699-730); the
        104-bit suffixes of PACKSIZE=64 go through `search_host.lookup_words`."""
        from utree_tpu.encode import search_window_words

        cfg = self.index.config
        words = search_window_words(seq, cfg.packsize, self.do_rc)
        if len(words) == 0:
            return np.zeros(0, np.int64)
        idx = self.index
        if idx.s_hi64 is not None:  # PACKSIZE=64: the host index's replay
            from utree_tpu.search_host import lookup_words

            if not hasattr(self, "_hidx"):
                self._hidx = idx.host_index()
            ixs = lookup_words(self._hidx, words)
            return ixs[ixs < idx.num_labels]
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

    # ---- rows -> lines ----------------------------------------------------------

    def _wait_rows(self, handle: _Readback) -> np.ndarray:
        if self.tracer is not None:
            with self.tracer.phase("drain:d2h-wait"):
                return handle.wait()
        return handle.wait()

    def _replay(self, rows: np.ndarray, seq_of):
        """Exact host histograms of the reads `rows`, as an override CSR
        (offsets, labels, counts)."""
        offsets = np.zeros(len(rows) + 1, np.int64)
        ls, cs = [], []
        for j, i in enumerate(rows):
            cnt = np.bincount(self._host_hits(seq_of(int(i))))
            nz = np.flatnonzero(cnt)
            ls.append(nz.astype(np.int32))
            cs.append(cnt[nz].astype(np.int32))
            offsets[j + 1] = offsets[j] + len(nz)
        return (offsets, np.concatenate(ls) if ls else np.zeros(0, np.int32),
                np.concatenate(cs) if cs else np.zeros(0, np.int32))

    def _vote(self, fn, *args) -> bytes:
        if self.tracer is not None:
            with self.tracer.phase("drain:vote"):
                return fn(*args)
        return fn(*args)

    def _format_devvote(self, count, name_pool, name_offsets, handle,
                        seq_of) -> bytes:
        """Device-vote rows: replay the flagged reads on the host into an
        override CSR, then format every line in C."""
        u = self._wait_rows(handle).view(np.uint32).reshape(-1, 3)[:count]
        flags = np.flatnonzero((u[:, 0] >> 24) & 1).astype(np.int64)
        return self._vote(self._vote_engine.format_device_vote, count, name_pool,
                          name_offsets, u, flags, *self._replay(flags, seq_of))

    def _vote_packed(self, count, name_pool, name_offsets, handle,
                     seq_of) -> bytes:
        """(B, cap+1) `pack_hist` rows straight to `utree_vote_packed`
        (unpack + vote + format in C); over-cap reads take the override CSR."""
        u = self._wait_rows(handle).view(np.uint32)[:count]
        cap = self.hist_cap
        over = np.flatnonzero((u[:, cap] & 31) > cap).astype(np.int64)
        return self._vote(self._vote_engine.vote_packed, count, name_pool,
                          name_offsets, u, cap, over, *self._replay(over, seq_of))

    def _vote_unpacked(self, count, name_pool, name_offsets, handle,
                       seq_of) -> bytes:
        """(B, 2*cap+2) rows (wide labels or PACKSIZE=64) flattened to a CSR, with over-cap
        reads replayed on the host, then voted and formatted in C."""
        labels, counts, nuniq, _ = self._unpack(self._wait_rows(handle)[:count])
        cap = self.hist_cap
        nu = np.minimum(nuniq, cap).astype(np.int64)
        over = np.flatnonzero(nuniq > cap)
        offsets = np.zeros(count + 1, np.int64)
        if len(over) == 0:
            np.cumsum(nu, out=offsets[1:])
            mask = np.arange(cap)[None, :] < nu[:, None]
            flat_l = labels[mask].astype(np.int32)
            flat_c = counts[mask].astype(np.int32)
        else:
            o_off, o_l, o_c = self._replay(over, seq_of)
            nu[over] = np.diff(o_off)
            np.cumsum(nu, out=offsets[1:])
            flat_l = np.empty(int(offsets[-1]), np.int32)
            flat_c = np.empty(int(offsets[-1]), np.int32)
            extra = {int(i): j for j, i in enumerate(over)}
            for i in range(count):
                a, b = offsets[i], offsets[i + 1]
                if i in extra:
                    j = extra[i]
                    flat_l[a:b] = o_l[o_off[j]:o_off[j + 1]]
                    flat_c[a:b] = o_c[o_off[j]:o_off[j + 1]]
                else:
                    flat_l[a:b] = labels[i, : nu[i]]
                    flat_c[a:b] = counts[i, : nu[i]]
        return self._vote(self._vote_engine.vote_batch_pooled, count, name_pool,
                          name_offsets, offsets, flat_l, flat_c)

    def _format(self, *args) -> bytes:
        return {"vote": self._format_devvote, "packed": self._vote_packed,
                "unpacked": self._vote_unpacked}[self.layout](*args)

    def _unpack(self, arr: np.ndarray):
        """Histogram rows (either layout) -> labels, counts (B, cap), nuniq,
        found (B,), as utree_tpu.pipeline._unpack."""
        cap = self.hist_cap
        if self.layout == "unpacked":
            return arr[:, :cap], arr[:, cap:2 * cap], arr[:, 2 * cap], arr[:, 2 * cap + 1]
        u = arr.view(np.uint32)
        lc = u[:, :cap]
        tail = u[:, cap]
        return ((lc & 0xFFFF).astype(np.int32) - 1, (lc >> 16).astype(np.int32),
                (tail & 31).astype(np.int32), (tail >> 5).astype(np.int32))

    # ---- long reads -------------------------------------------------------------

    def classify_long_read(self, name: bytes, seq: bytes) -> bytes | None:
        """One read over `long_read_threshold`: cut into a power-of-two count
        of chunks (each scans forward + RC of its own span, so together they
        yield the read's exact hit multiset), their histograms through the
        histogram step, merged on the host (an over-cap chunk replayed
        exactly), then one vote (utree_tpu/pipeline.py:824-852)."""
        from utree_tpu.classify import aufbau_vote_counts
        from utree_tpu_torch.parallel.sharded import split_long_read

        k = self.index.config.packsize
        num_chunks = max(1, -(-max(0, len(seq) - k + 1) // self.long_chunk))
        num_chunks = _bucket_len(num_chunks, minimum=1)
        chunks, lens = split_long_read(seq, num_chunks, k)
        handle = self.dispatch_matrix(chunks, lens, step=self._step_hist)
        labels, counts, nuniq, _ = self._unpack(self._wait_rows(handle))
        cap = self.hist_cap
        agg: dict[int, int] = {}
        for r in range(len(chunks)):
            if nuniq[r] > cap:  # chunk overflowed the device histogram
                for h in self._host_hits(chunks[r, : lens[r]].tobytes()):
                    agg[int(h)] = agg.get(int(h), 0) + 1
            else:
                for s in range(int(nuniq[r])):
                    agg[int(labels[r, s])] = agg.get(int(labels[r, s]), 0) + int(counts[r, s])
        if not agg:
            return None
        ks = np.array(sorted(agg), np.int64)
        vs = np.array([agg[int(x)] for x in ks], np.int64)
        return aufbau_vote_counts(name, ks, vs, self.index.strings,
                                  self.index.config.taxacut, 1)

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
                    # 2-bit packing (PACKSIZE=32) or the ASCII matrix, in C++
                    if self._packed:
                        arrays = (np.zeros((self.batch_size, lmax // 4), np.uint8),
                                  np.zeros((self.batch_size, lmax // 8), np.uint8))
                    else:
                        arrays = (np.zeros((self.batch_size, lmax), np.uint8),)
                    pack = "pack_2bit" if self._packed else "pack"
                    lens = np.zeros(self.batch_size, np.int32)
                    for sc, start, count in spans:
                        *mats, l2, npool, noffs = getattr(sc, pack)(start, count, lmax)
                        for dst, src in zip(arrays, mats):
                            dst[row:row + count] = src
                        lens[row:row + count] = l2[:count]
                        pools.append(npool)
                        offs.append(noffs[:-1] + shift)
                        shift += len(npool)
                        row += count
                    item = ("batch", spans, acc, (*arrays, lens),
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
                        b = flush()  # long reads emit in record order
                        if b is not None:
                            yield b
                        yield ("long", sc.record_name(r), sc.record_seq(r))
                        r += 1
                        r_global += 1
                        continue
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
                        lines = self._format(
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
                if item[0] == "long":
                    drain(block=True)  # keep output in read order
                    with tm.phase("long-reads"):
                        line = self.classify_long_read(item[1], item[2])
                        if line is not None:
                            fo.write(line + b"\n")
                        fo.flush()
                    done += 1
                    ckpt.commit(done - range_lo, fo.tell())
                    continue
                _, spans, count, arrays, npool, noffs = item
                with tm.phase("dispatch"):
                    if self._packed:
                        handle = self.dispatch_packed(*arrays)
                    else:
                        handle = self.dispatch_matrix(*arrays)
                pending.append((spans, count, handle, npool, noffs))
                drain(block=False)
            drain(block=True)
        ckpt.finish()
        tm.count("reads", n - skip)
        return n - range_lo
