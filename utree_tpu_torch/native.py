"""ctypes bridge to the host C++ of the search and of xtree ALIGN (the port's
copy of the FASTA scanner, the vote formatter, the rank-specific search and
the xtree engine of `utree_tpu/native.py`).

The sources are `utree_tpu_torch/csrc/host/{fasta,vote,shallow,xtree}.cpp`.
Each compiles with g++ at first use into `.cuda_build/` beside the package,
named by a hash of its source, so an edited source never loads a stale
build.  A failed build raises: the port has no Python path for what these
do (`utree_tpu` returns None there and takes its Python paths).

  FastaScanner  record table of a FASTA piece; batch packing to 2 bits
                (PACKSIZE=32) or to an ASCII matrix (PACKSIZE=64)
  VoteEngine    the aufbau vote and line formatting of a batch: from CSR
                histograms, from packed (B, cap+1) rows, or from the
                device's 12 B vote rows
  shallow_lib   the rank-specific (non-GG) search: the literal word state
                machine of the shallow scan, alone (shallow_scan_batch) or
                fused with the vote and the formatter over a whole file
                (shallow_classify_file)
  xtree_lib     the xtree ALIGN engine: query scan, LBS_k hit scan (alone
                or fused with the ref vote), ref and taxon tallies, the
                deep taxonomy call and the perq formatter (xt_* below)
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess

import numpy as np

from utree_tpu_torch.utils import trace

PKG = pathlib.Path(__file__).resolve().parent
HOST_SRC = PKG / "csrc" / "host"
BUILD_DIR = PKG.parent / ".cuda_build"


def _compile(src: str) -> pathlib.Path:
    """Build csrc/host/<src> into a shared library unless a build of these
    exact bytes exists.  With OpenMP where the toolchain has it.  A build
    counts in `build.compiles` and runs in the span `build:g++` of the
    process record (`utils.trace.process()`)."""
    cpp = HOST_SRC / src
    digest = hashlib.sha1(cpp.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{cpp.stem}_{digest}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    base = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"]
    errors = []
    rec = trace.process()
    rec.count("build.compiles", 1)
    with rec.phase("build:g++"):
        for flags in (["-fopenmp"], []):
            r = subprocess.run([*base, *flags, str(cpp), "-o", str(tmp)],
                               capture_output=True, text=True)
            if r.returncode == 0:
                os.replace(tmp, so)  # atomic: a concurrent build never loads a torn file
                return so
            errors.append(r.stderr)
    tmp.unlink(missing_ok=True)
    raise RuntimeError(f"g++ could not build {cpp}:\n" + "\n".join(errors))


def _nd(dtype):
    return np.ctypeslib.ndpointer(dtype)


@functools.cache
def vote_lib() -> ctypes.CDLL:
    """libvote (native vote + formatter), built first if needed."""
    lib = ctypes.CDLL(str(_compile("vote.cpp")))
    I64, I32, CHR = ctypes.c_int64, ctypes.c_int32, ctypes.c_char_p
    tail = [CHR, _nd(np.int64), CHR, _nd(np.int64), I32, CHR, I64]
    override = [_nd(np.int64), _nd(np.int64), _nd(np.int32), _nd(np.int32)]
    lib.utree_vote_batch.argtypes = [I64, _nd(np.int64), _nd(np.int32), _nd(np.int32),
                                     *tail]
    lib.utree_vote_packed.argtypes = [I64, _nd(np.uint32), I64, I64, *override, *tail]
    lib.utree_format_device_vote.argtypes = [I64, _nd(np.uint32), I64, *override, *tail]
    for fn in (lib.utree_vote_batch, lib.utree_vote_packed, lib.utree_format_device_vote):
        fn.restype = I64
    return lib


@functools.cache
def fasta_lib() -> ctypes.CDLL:
    """libfasta (record scan and batch packing), built first if needed."""
    lib = ctypes.CDLL(str(_compile("fasta.cpp")))
    I64, CHR = ctypes.c_int64, ctypes.c_char_p
    lib.utree_scan_fasta.argtypes = [CHR, I64, _nd(np.int64), I64]
    lib.utree_pack_batch.argtypes = [CHR, _nd(np.int64), I64, I64, I64, _nd(np.uint8),
                                     _nd(np.int32), CHR, I64, _nd(np.int64)]
    lib.utree_pack_batch_2bit.argtypes = [CHR, _nd(np.int64), I64, I64, I64,
                                          _nd(np.uint8), _nd(np.uint8), _nd(np.int32),
                                          CHR, I64, _nd(np.int64)]
    for fn in (lib.utree_scan_fasta, lib.utree_pack_batch, lib.utree_pack_batch_2bit):
        fn.restype = I64
    return lib


@functools.cache
def shallow_lib() -> ctypes.CDLL:
    """libshallow (the literal non-GG word state machine, itree.c:903-951,
    at C speed), built first if needed."""
    lib = ctypes.CDLL(str(_compile("shallow.cpp")))
    I64, U64, CHR = ctypes.c_int64, ctypes.c_uint64, ctypes.c_char_p
    A = _nd(np.int64)
    index = [A, _nd(np.uint64), A, I64, U64, I64, I64, I64, I64, I64]
    lib.utree_shallow_scan_batch.restype = None
    lib.utree_shallow_scan_batch.argtypes = [*index, _nd(np.uint8), A, I64, A, A, A]
    lib.utree_shallow_classify_batch.restype = I64
    lib.utree_shallow_classify_batch.argtypes = [*index, CHR, A, I64, I64, I64, CHR, A,
                                                 I64, I64, A, I64, CHR, I64]
    return lib


def shallow_classify_file(index, reads_path: str, out_path: str,
                          do_rc: bool, chunk: int = 65536) -> int:
    """Whole-file shallow search with zero per-read Python: native FASTA
    scan + fused scan/vote/format batches (utree_shallow_classify_batch).
    Raises ValueError if the file is not linearized FASTA (the caller then
    drives the batches from Python)."""
    lib = shallow_lib()
    cfg = index.config
    with open(reads_path, "rb") as f:
        data = f.read()
    sc = FastaScanner(data)
    n = sc.num_records
    recs_flat = np.ascontiguousarray(sc.recs.reshape(-1))
    seq_lens = sc.seq_lengths()
    ext = 2 * seq_lens + 1 if do_rc else seq_lens
    max_wins = int(max(0, int((ext - (cfg.packsize - 1)).max()))) if n else 0
    # persistent AllTheKingsHorses analog: zero-init ONCE per file; the
    # phantom-slot semantics then survive batch boundaries (see shallow.cpp)
    vote_buffer = np.zeros(max_wins + 2, np.int64)
    label_pool = b"".join(index.strings)
    label_offsets = np.zeros(len(index.strings) + 1, np.int64)
    np.cumsum([len(s) for s in index.strings], out=label_offsets[1:])
    max_label = max((len(s) for s in index.strings), default=0)
    with open(out_path, "wb") as fo:
        for f0 in range(0, n, chunk):
            count = min(chunk, n - f0)
            name_bytes = int((sc.recs[f0:f0 + count, 1]
                              - sc.recs[f0:f0 + count, 0]).sum())
            cap = name_bytes + count * (max_label + 48) + 64
            out = ctypes.create_string_buffer(cap)
            used = lib.utree_shallow_classify_batch(
                index.bin_ix, index.s_lo, index.ixs,
                cfg.ctr_suffix_bits, cfg.suffix_mask, cfg.bad_ix,
                cfg.packsize, cfg.sparsity, cfg.word_bits, index.num_labels,
                data, recs_flat, f0, count, 1 if do_rc else 0,
                label_pool, label_offsets, cfg.tolerance, cfg.slack,
                vote_buffer, len(vote_buffer), out, cap)
            if used < 0:
                raise RuntimeError(f"shallow classify batch failed: {used}")
            fo.write(out.raw[:used])
    return n


def shallow_scan_batch(index, ext_codes: list[np.ndarray]) -> list[list[int]]:
    """Batch scan_shallow over pre-extended encoded reads (seq [+N+rc]).
    `index` is a search_host.HostIndex with packsize <= 32 (s_hi all zero)."""
    lib = shallow_lib()
    cfg = index.config
    n = len(ext_codes)
    lens = np.array([len(c) for c in ext_codes], np.int64)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    codes = np.concatenate(ext_codes) if n else np.zeros(0, np.uint8)
    wins = np.maximum(lens - (cfg.packsize - 1), 0)
    hit_offsets = np.zeros(n + 1, np.int64)
    np.cumsum(wins, out=hit_offsets[1:])
    hits = np.zeros(max(1, int(hit_offsets[-1])), np.int64)
    counts = np.zeros(max(1, n), np.int64)
    lib.utree_shallow_scan_batch(
        index.bin_ix, index.s_lo, index.ixs,
        cfg.ctr_suffix_bits, cfg.suffix_mask, cfg.bad_ix,
        cfg.packsize, cfg.sparsity, cfg.word_bits, index.num_labels,
        codes, offsets, n, hits, hit_offsets, counts,
    )
    return [hits[hit_offsets[r] : hit_offsets[r] + counts[r]].tolist()
            for r in range(n)]


class FastaScanner:
    """Whole-piece record table + batch packing (C++)."""

    def __init__(self, data: bytes):
        self.lib = fasta_lib()
        self.data = data
        max_recs = max(16, data.count(b">") + 1)
        recs = np.zeros(max_recs * 4, np.int64)
        n = self.lib.utree_scan_fasta(data, len(data), recs, max_recs)
        if n < 0:
            raise ValueError(f"malformed FASTA at byte {-n - 1}")
        self.num_records = int(n)
        self.recs = recs[: n * 4].reshape(n, 4)

    def seq_lengths(self) -> np.ndarray:
        return self.recs[:, 3] - self.recs[:, 2]

    def _name_pool(self, first: int, count: int):
        cap = int((self.recs[first:first + count, 1]
                   - self.recs[first:first + count, 0]).sum() + count + 16)
        return ctypes.create_string_buffer(cap), cap, np.zeros(count + 1, np.int64)

    def pack(self, first: int, count: int, lmax: int):
        """(reads (count, lmax) u8, lens i32, name_pool bytes, name_offsets)."""
        reads = np.zeros((count, lmax), np.uint8)
        lens = np.zeros(count, np.int32)
        pool, cap, name_offsets = self._name_pool(first, count)
        used = self.lib.utree_pack_batch(self.data, self.recs.reshape(-1), first, count,
                                         lmax, reads, lens, pool, cap, name_offsets)
        if used < 0:
            raise ValueError(f"pack error {used}")
        return reads, lens, pool.raw[:used], name_offsets

    def pack_2bit(self, first: int, count: int, lmax: int):
        """(packed (count, lmax/4) u8, vbits (count, lmax/8) u8, lens i32,
        name_pool bytes, name_offsets), bit-identical to
        lookup.pack_reads_host over the ASCII matrix."""
        if lmax % 8:
            raise ValueError(f"lmax {lmax} is not a multiple of 8")
        packed = np.zeros((count, lmax // 4), np.uint8)
        vbits = np.zeros((count, lmax // 8), np.uint8)
        lens = np.zeros(count, np.int32)
        pool, cap, name_offsets = self._name_pool(first, count)
        used = self.lib.utree_pack_batch_2bit(self.data, self.recs.reshape(-1), first,
                                              count, lmax, packed, vbits, lens, pool,
                                              cap, name_offsets)
        if used < 0:
            raise ValueError(f"pack error {used}")
        return packed, vbits, lens, pool.raw[:used], name_offsets

    def record_seq(self, i: int) -> bytes:
        a, b = int(self.recs[i, 2]), int(self.recs[i, 3])
        return self.data[a:b]

    def record_name(self, i: int) -> bytes:
        a, b = int(self.recs[i, 0]), int(self.recs[i, 1])
        return self.data[a:b]


def pool_names(names: list[bytes]) -> tuple[bytes, np.ndarray]:
    """Read names as the formatters take them: one NUL-terminated pool and
    each name's start offset."""
    offsets = np.zeros(len(names), np.int64)
    if len(names) > 1:
        np.cumsum([len(nm) + 1 for nm in names[:-1]], out=offsets[1:])
    return (b"\x00".join(names) + b"\x00" if names else b"\x00"), offsets


class VoteEngine:
    """Batch aufbau vote + formatting in C++ (exact peer of classify.py at
    support_ranges=1)."""

    def __init__(self, strings: list[bytes], taxacut: int):
        self.taxacut = taxacut
        self.lib = vote_lib()
        offs = np.zeros(len(strings) + 1, np.int64)
        for i, s in enumerate(strings):
            offs[i + 1] = offs[i] + len(s) + 1
        self.string_pool = b"\x00".join(strings) + b"\x00"
        self.string_offsets = offs
        self.max_label = max((len(s) for s in strings), default=0)

    def _call(self, fn, n: int, name_pool: bytes, name_offsets, *args) -> bytes:
        """Run one formatter; its output buffer starts at the bound for n
        lines (name + one label + ~48 digits/tabs each) and grows 4x while
        the C side reports it full (-1)."""
        cap = max(1 << 20, len(name_pool) + n * (self.max_label + 48))
        while True:
            out = ctypes.create_string_buffer(cap)
            wrote = fn(n, *args, self.string_pool, self.string_offsets, name_pool,
                       np.ascontiguousarray(name_offsets, np.int64), self.taxacut,
                       out, cap)
            if wrote == -1:
                cap *= 4
                continue
            if wrote < 0:
                raise RuntimeError(f"{fn.__name__} error {wrote}")
            return out.raw[:wrote]

    @staticmethod
    def _override(over_rows, over_offsets, over_labels, over_counts):
        return (len(over_rows), np.ascontiguousarray(over_rows, np.int64),
                np.ascontiguousarray(over_offsets, np.int64),
                np.ascontiguousarray(over_labels, np.int32),
                np.ascontiguousarray(over_counts, np.int32))

    @property
    def available(self) -> bool:
        """Always true: the library was built (or the constructor raised)."""
        return True

    def vote_batch(self, names: list[bytes], hist_offsets: np.ndarray,
                   labels: np.ndarray, counts: np.ndarray) -> bytes:
        """vote_batch_pooled over a list of read names."""
        name_pool, name_offsets = pool_names(names)
        return self.vote_batch_pooled(len(names), name_pool, name_offsets,
                                      hist_offsets, labels, counts)

    def vote_batch_pooled(self, n: int, name_pool: bytes, name_offsets: np.ndarray,
                          hist_offsets: np.ndarray, labels: np.ndarray,
                          counts: np.ndarray) -> bytes:
        """CSR histograms -> concatenated output lines (reads with empty
        histograms omitted), in read order."""
        return self._call(self.lib.utree_vote_batch, n, name_pool, name_offsets,
                          np.ascontiguousarray(hist_offsets, np.int64),
                          np.ascontiguousarray(labels, np.int32),
                          np.ascontiguousarray(counts, np.int32))

    def vote_packed(self, n: int, name_pool: bytes, name_offsets: np.ndarray,
                    packed: np.ndarray, cap_cols: int, over_rows, over_offsets,
                    over_labels, over_counts) -> bytes:
        """Vote straight off packed (count<<16 | label+1, tail) u32 rows.
        Rows whose nuniq exceeds cap_cols must be listed (ascending) in the
        override CSR (the host-exact recompute)."""
        over_n, *over = self._override(over_rows, over_offsets, over_labels, over_counts)
        return self._call(self.lib.utree_vote_packed, n, name_pool, name_offsets,
                          np.ascontiguousarray(packed, np.uint32), cap_cols, over_n,
                          *over)

    def format_device_vote(self, n: int, name_pool: bytes, name_offsets: np.ndarray,
                           rows: np.ndarray, over_rows, over_offsets, over_labels,
                           over_counts) -> bytes:
        """Lines from the device-voted (B, 3) u32 rows
        (lookup.search_step_vote_compact); flagged rows take the override
        CSR through the full host walk in C."""
        return self._call(self.lib.utree_format_device_vote, n, name_pool, name_offsets,
                          np.ascontiguousarray(rows, np.uint32),
                          *self._override(over_rows, over_offsets, over_labels,
                                          over_counts))


# ---- xtree ALIGN engine (csrc/host/xtree.cpp) -------------------------------

@functools.cache
def xtree_lib() -> ctypes.CDLL:
    """libxtree (the ALIGN scan, tallies and formatter), built first if
    needed.  `utree_tpu.native.xtree_lib` returns None when g++ fails and
    its aligner falls back to NumPy; the port's raises instead."""
    lib = ctypes.CDLL(str(_compile("xtree.cpp")))
    I64, I32, D, CHR, VP = (ctypes.c_int64, ctypes.c_int32, ctypes.c_double,
                            ctypes.c_char_p, ctypes.c_void_p)
    A = _nd(np.int64)
    lib.xt_scan_hits.argtypes = [I64, CHR, A, A, I32, I32, A, A, A, A, A, A]
    lib.xt_scan_queries.argtypes = [CHR, I64, A, I64]
    lib.xt_scan_queries.restype = I64
    lib.xt_scan_hits_tally.argtypes = [I64, CHR, A, A, I32, I32, A, A, A, A, I64,
                                       A, A, A, A, A, A, A]
    lib.xt_ref_tally.argtypes = [A, A, A, A, A, A, I64, I64, A, A, A, A, A, A, A, A, A]
    lib.xt_h_tally.argtypes = [A, A, A, A, A, A, VP, I64, I64, A, A, A, A, A, A]
    lib.xt_tally_bounds.argtypes = [A, A, A, A, I64, A, I64, A]
    lib.xt_format_perq.argtypes = [
        I64,
        CHR, A, A,            # head pool + [start, end) spans
        CHR, A,               # ref names
        CHR, A,               # h_strings[0]
        CHR, A,               # h_strings[1]
        _nd(np.uint8),
        A, A, A, A,           # mix, mx, mx2, tix
        A, A,                 # ft_ix, ft_lv (Q,2) row-major
        CHR, I64,
    ]
    lib.xt_format_perq.restype = I64
    lib.xt_deep_call.argtypes = [
        A, I64, A, A, A, A, A, A,
        VP, I64, VP, I64, VP, I64, VP, I64,
        I64, I64,
        A, D, I64, I64,
        A, A, A,
    ]
    for fn in (lib.xt_scan_hits, lib.xt_scan_hits_tally, lib.xt_ref_tally,
               lib.xt_h_tally, lib.xt_tally_bounds, lib.xt_deep_call):
        fn.restype = None
    return lib


def _compact_spans(qoff, counts, *arrays):
    """Each query wrote counts[q] items at qoff[q] of its pre-sized span:
    the arrays with those items only, in query order."""
    if int(counts.sum()) == int(qoff[-1]):
        return arrays
    from utree_tpu_torch.hash_index import _ranges_to_indices

    nz = counts > 0  # _ranges_to_indices assumes nonempty ranges
    idx = _ranges_to_indices(qoff[:-1][nz], counts[nz])
    return tuple(a[idx] for a in arrays)


def _hit_spans(qs, qe, k: int):
    """Per-query output offsets sized for 2 hits a window (fwd and RC)."""
    wn = np.maximum((qe - qs) - k + 1, 0)
    qoff = np.zeros(len(qs) + 1, np.int64)
    np.cumsum(2 * wn, out=qoff[1:])
    return qoff


def xt_scan_hits_tally(lib, pool, qs, qe, k: int, pl: int, bins, sfx,
                       run_end_ext, rix, R: int):
    """Fused scan + ref vote (csrc/host/xtree.cpp:xt_scan_hits_tally):
    (qid, prefix, seed, tix, mx, mx2, mix) for a query chunk — the fast
    path's whole pre-taxonomy stage in one C pass."""
    nq = len(qs)
    qoff = _hit_spans(qs, qe, k)
    pre_out = np.empty(int(qoff[-1]), np.int64)
    seed_out = np.empty(int(qoff[-1]), np.int64)
    counts, mx, mx2, mix = (np.zeros(nq, np.int64) for _ in range(4))
    lib.xt_scan_hits_tally(
        nq, pool, np.ascontiguousarray(qs, np.int64),
        np.ascontiguousarray(qe, np.int64), k, pl, bins, sfx,
        run_end_ext, rix, R, qoff, pre_out, seed_out, counts, mx, mx2, mix)
    qid = np.repeat(np.arange(nq, dtype=np.int64), counts)
    pre_out, seed_out = _compact_spans(qoff, counts, pre_out, seed_out)
    return qid, pre_out, seed_out, counts, mx, mx2, mix


def xt_scan_queries(lib, data: bytes) -> np.ndarray:
    """(n, 4) record quads [hstart, hend, sstart, send] for a FASTA/FASTQ
    buffer — the C twin of xtree/io.iter_queries (full-header names)."""
    max_recs = max(16, data.count(b"\n") // 2 + 2)
    recs = np.zeros(max_recs * 4, np.int64)
    n = lib.xt_scan_queries(data, len(data), recs, max_recs)
    if n < 0:
        raise ValueError("query record table overflow")
    return recs[: n * 4].reshape(n, 4)


def xt_scan_hits(lib, pool, qs: np.ndarray, qe: np.ndarray, k: int, pl: int,
                 bins: np.ndarray, sfx: np.ndarray):
    """(qid, prefix, seed) hit triples for a query chunk, scan order —
    the C++ twin of xtree.align.XtreeAligner._batch_hits.  `qs`/`qe` are
    per-query [start, end) spans into `pool` (the file buffer on the fast
    path — no per-query copies)."""
    nq = len(qs)
    qoff = _hit_spans(qs, qe, k)
    pre_out = np.empty(int(qoff[-1]), np.int64)
    seed_out = np.empty(int(qoff[-1]), np.int64)
    counts = np.zeros(nq, np.int64)
    lib.xt_scan_hits(nq, pool, np.ascontiguousarray(qs, np.int64),
                     np.ascontiguousarray(qe, np.int64),
                     k, pl, bins, sfx, qoff, pre_out, seed_out, counts)
    qid = np.repeat(np.arange(nq, dtype=np.int64), counts)
    return (qid, *_compact_spans(qoff, counts, pre_out, seed_out))


def _xt_spans(lib, qid, seed, pre, bins, run_end_ext, Q, cap_per_q):
    """Per-query hit bounds + output upper-bound offsets for the tally
    kernels: qstart from the qid-ascending hit order; qoff bounds distinct
    outputs by min(expanded pods of q, cap_per_q) (computed in C)."""
    qstart = np.searchsorted(qid, np.arange(Q + 1)).astype(np.int64)
    qoff = np.zeros(Q + 1, np.int64)
    lib.xt_tally_bounds(pre, seed, bins, run_end_ext, Q, qstart, cap_per_q,
                        qoff[1:])
    np.cumsum(qoff[1:], out=qoff[1:])
    return qstart, qoff


def xt_ref_tally(lib, qid, pre, seed, bins, run_end_ext, rix, Q, R):
    """C++ twin of align.py:_batch_ref_tally's tally core.  Returns
    (mx, mx2, mix, qu, rxu, counts, first, nd) with the CSR compacted and
    sorted by (query, ref)."""
    qstart, qoff = _xt_spans(lib, qid, seed, pre, bins, run_end_ext, Q, R)
    mx, mx2, mix, nd = (np.zeros(Q, np.int64) for _ in range(4))
    out_r, out_c, out_first = (np.empty(int(qoff[-1]), np.int64) for _ in range(3))
    lib.xt_ref_tally(qid, pre, seed, bins, run_end_ext, rix, Q, R,
                     qstart, qoff, mx, mx2, mix, out_r, out_c, out_first, nd)
    qu = np.repeat(np.arange(Q, dtype=np.int64), nd)
    out_r, out_c, out_first = _compact_spans(qoff, nd, out_r, out_c, out_first)
    return mx, mx2, mix, qu, out_r, out_c, out_first, nd


def xt_h_tally(lib, qid, pre, seed, bins, run_end_ext, rix, hmap, Hn, Q,
               lbin=None):
    """C++ twin of align.py:_batch_h_tally: (q2, h2, c2, ins2) CSR."""
    qstart, qoff = _xt_spans(lib, qid, seed, pre, bins, run_end_ext, Q, Hn)
    out_h, out_c, out_ins = (np.empty(int(qoff[-1]), np.int64) for _ in range(3))
    nd = np.zeros(Q, np.int64)
    lb = lbin.ctypes.data_as(ctypes.c_void_p) if lbin is not None else None
    lib.xt_h_tally(pre, seed, bins, run_end_ext, rix, hmap, lb, Q, Hn,
                   qstart, qoff, out_h, out_c, out_ins, nd)
    q2 = np.repeat(np.arange(Q, dtype=np.int64), nd)
    return (q2, *_compact_spans(qoff, nd, out_h, out_c, out_ins))


class StringPool:
    """Concatenated byte-string table + offsets for C consumption."""

    def __init__(self, strings: list[bytes]):
        self.pool = b"".join(strings)
        off = np.zeros(len(strings) + 1, np.int64)
        np.cumsum([len(s) for s in strings], out=off[1:])
        self.off = off
        self.max_len = int(np.diff(off).max()) if len(strings) else 0


def xt_format_perq(lib, head_pool, head_s, head_e, pools, matched, mix, mx,
                   mx2, tix, ft_ix, ft_lv) -> bytes:
    """Chunk perq lines, '\\n'-joined with no trailing newline — byte twin of
    align.py:_align_chunk's per-query formatting tail.  Heads come as
    [start, end) spans into `head_pool` (the file buffer on the fast path).
    `pools` = (ref_names, h_strings[0], h_strings[1]) StringPools."""
    Q = len(head_s)
    head_s = np.ascontiguousarray(head_s, np.int64)
    head_e = np.ascontiguousarray(head_e, np.int64)
    rn, h0, h1 = pools
    nmatch = int(np.count_nonzero(matched))
    cap = (int((head_e - head_s).sum()) + 75 * Q + 8
           + nmatch * (rn.max_len + h0.max_len + h1.max_len))

    def i64(a):
        return np.ascontiguousarray(a, np.int64)

    while True:
        out = ctypes.create_string_buffer(cap)
        wrote = lib.xt_format_perq(
            Q, head_pool, head_s, head_e,
            rn.pool, rn.off, h0.pool, h0.off, h1.pool, h1.off,
            np.ascontiguousarray(matched, np.uint8),
            i64(mix), i64(mx), i64(mx2), i64(tix),
            i64(ft_ix).reshape(-1), i64(ft_lv).reshape(-1),
            out, cap)
        if wrote == -1:
            cap *= 4
            continue
        if wrote < 0:
            raise RuntimeError(f"xt_format_perq error {wrote}")
        return out.raw[:wrote]


def xt_deep_call(lib, deepq, qstart, pre, seed, bins, run_end_ext, rix,
                 pack, tix, conf, full_lca, tax_out, ft_ix, ft_lv, mb):
    """Fused deep taxonomy call (csrc/host/xtree.cpp:xt_deep_call): full-string
    tally + LBins level walk per ambiguous query, writing ft_ix/ft_lv/mb
    rows in place.  `pack` = XtreeAligner._deep_pack (cached int64 hmaps +
    row-major lbins stacks)."""
    hm0, Hn0, lb0, L0, hm1, Hn1, lb1, L1, has0, has1 = pack

    def vp(a):
        return None if a is None else a.ctypes.data_as(ctypes.c_void_p)

    lib.xt_deep_call(
        np.ascontiguousarray(deepq, np.int64), len(deepq), qstart,
        np.ascontiguousarray(pre, np.int64),
        np.ascontiguousarray(seed, np.int64), bins, run_end_ext, rix,
        vp(hm0), Hn0, vp(lb0), L0, vp(hm1), Hn1, vp(lb1), L1,
        has0, has1, np.ascontiguousarray(tix, np.int64), float(conf),
        1 if full_lca else 0, 1 if tax_out else 0,
        ft_ix.reshape(-1), ft_lv.reshape(-1), mb.reshape(-1))
