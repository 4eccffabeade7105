"""ctypes bridge to the host C++ of the search (the port's copy of the FASTA
scanner and vote formatter of `utree_tpu/native.py`).

The sources are `utree_tpu_torch/csrc/host/{fasta,vote}.cpp`.  Each compiles
with g++ at first use into `.cuda_build/` beside the package, named by a
hash of its source, so an edited source never loads a stale build.  A failed
build raises: the port has no Python path for what these do.

  FastaScanner  record table of a FASTA piece; batch packing to 2 bits
                (PACKSIZE=32) or to an ASCII matrix (PACKSIZE=64)
  VoteEngine    the aufbau vote and line formatting of a batch: from CSR
                histograms, from packed (B, cap+1) rows, or from the
                device's 12 B vote rows
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import subprocess

import numpy as np

PKG = pathlib.Path(__file__).resolve().parent
HOST_SRC = PKG / "csrc" / "host"
BUILD_DIR = PKG.parent / ".cuda_build"


def _compile(src: str) -> pathlib.Path:
    """Build csrc/host/<src> into a shared library unless a build of these
    exact bytes exists.  With OpenMP where the toolchain has it."""
    cpp = HOST_SRC / src
    digest = hashlib.sha1(cpp.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{cpp.stem}_{digest}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    base = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"]
    errors = []
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
