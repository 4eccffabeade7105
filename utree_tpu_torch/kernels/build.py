"""Build and load the hand-written CUDA kernels (`utree_tpu_torch/csrc/*.cu`).

Each source compiles with its own `nvcc -c`, all started together, and one
more `nvcc` links the objects into a shared library with a plain C
interface, loaded with `ctypes` (no PyTorch headers, so a build takes
seconds).  The library lands in `.cuda_build/` at the repository root, named
by a hash of the sources, so an edited source never loads a stale build.  A
failed build raises: nothing degrades to the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parent / ".cuda_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I32 = ctypes.c_int32
I64 = ctypes.c_int64
U32 = ctypes.c_uint32


class VoteTablesArg(ctypes.Structure):
    """K3's vote tables, pointers and shapes (`UtreeVoteTables` in
    csrc/aufbau.cu), passed by address."""

    _fields_ = [("rank", P), ("st", P), ("nlev", I32), ("L", I32), ("slen", P),
                ("semi", P), ("und", P), ("wm", I32), ("spos", P), ("R", I32)]


# C entry point -> argtypes.  Every pointer and the stream are c_void_p (a
# plain int would be cut to 32 bits); each returns cudaGetLastError().
_SCAN = [P, P, P, I64, I64, I64, I32,     # packed, vbits, lens, B, row4, row8, W
         P, I64, P, I64, P, I64, I32,     # d1, nslots, ds, nseed, d3, n3, s3
         I32, I32, P, P]                  # do_rc, bad_ix, out, stream
_LADDER = [P, P, P, I64, I64, I64, I32,
           P, I64, I32, P, I64, I32, P, I64, I32,  # (rows, nrows, slots) x 3
           I32, I32, P, P]
_HIST_ROWS = [P, I64, I32, I32, I32, P, P]  # ids, B, n, num_labels, cap, rows, stream
_OWNER = [P, I64, I64, I64, P, I64, P, P, P]
_FINISH = [P, P, I64, I32, P, I64, I32, I32, I32, P, P]
_CANON_OWNER = [P, I64, I64, I64, P, I32, P, P]
_CANON_FINISH = [P, P, I64, I32, P, I64, I32, P, I64, I32, I32, I32, P, P]
SIGNATURES = {
    "utree_scan_probe": _SCAN,
    "utree_scan_probe_wide": _SCAN,
    "utree_ladder_probe": _LADDER,
    "utree_ladder_probe_wide": _LADDER,
    "utree_bsearch_probe": [P, P, P, I64, I64, I64, I32,
                            P, P, I64,  # bin_ix, rec (n + 1, 4), n
                            I32, I32, P, P],
    # K15: the K7 front, then one slice (bin_ix, rec (n + 1, 4), n), its
    # first prefix and bin count; do_rc, ix out, found out, stream
    "utree_bsearch_probe_shard": [P, P, P, I64, I64, I64, I32,
                                  P, P, I64, I64, I64,
                                  I32, P, P, P],
    # reads, lens, B, L, row8, rc; packed, vbits, stream
    "utree_ascii_pack": [P, P, I64, I64, I64, I32, P, P, P],
    # ids, n, num_labels, hist, stream
    "utree_label_histogram": [P, I64, I32, P, P],
    "utree_hash_probe": [P, P, P, I64, I64, I64, I32,
                         P, I64, P, I64,  # t1, b1, t2, b2
                         I32, I32, P, P],
    # ASCII reads, lens, B, L, W; the tables as K1 / K4; do_rc, miss, out, stream
    "utree_scan_probe64": [P, P, I64, I64, I32, P, I64, P, I64, P, I64, I32,
                           I32, I32, P, P],
    "utree_ladder_probe64": [P, P, I64, I64, I32,
                             P, I64, I32, P, I64, I32, P, I64, I32,
                             I32, I32, P, P],
    "utree_histogram": [P, I64, I32, I32, I32, P, P, P, P, P],
    "utree_histogram_packed": _HIST_ROWS,
    "utree_histogram_unpacked": _HIST_ROWS,
    # rows, B, cap, over_cap, the look-back's ticket and flags (scratch
    # kept across calls), epoch, out, stream
    "utree_hist_compact": [P, I64, I32, I32, P, U32, P, P],
    # labels, counts, nuniq, found, B, C, the vote tables (a VoteTablesArg's
    # address), taxacut, max_iters, out, stream
    "utree_aufbau_vote": [P, P, P, P, I64, I32, P, I32, I32, P, P],
    # ASCII queries, lens, B, T, W, k, sl; d1, nslots, ds, nseed, d3, n3, s3;
    # out (4, B, W), stream
    "utree_xtree_probe": [P, P, I64, I64, I32, I32, I32,
                          P, I64, P, I64, P, I64, I32, P, P],
    # packed, vbits, lens, B, row4, row8, W, nseed, S, C; the look-back's
    # flags and ticket (scratch), send, rec, counts, stream
    "utree_route_displaced": [P, P, P, I64, I64, I64, I32, I64, I32, I32,
                              P, P, P, P, P],
    # lanes, N, base, per_seed, d1, nslots, ds, out, stream
    "utree_owner_probe": _OWNER,
    "utree_owner_probe_wide": _OWNER,
    # rec, reply, B, W, d3, n3, s3, do_rc, bad_ix, out, stream
    "utree_routed_finish": _FINISH,
    "utree_routed_finish_wide": _FINISH,
    # lanes, N, base, per_shard, t1, slots, out, stream
    "utree_canonical_owner_probe": _CANON_OWNER,
    "utree_canonical_owner_probe_wide": _CANON_OWNER,
    # rec, reply, B, W, c2, n2, s2, c3, n3, s3, do_rc, bad_ix, out, stream
    "utree_routed_canonical_finish": _CANON_FINISH,
    "utree_routed_canonical_finish_wide": _CANON_FINISH,
}


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(install the CUDA toolkit or put nvcc on PATH)")


@functools.cache
def build() -> tuple[pathlib.Path, float, str]:
    """Compile the kernels if no build of these exact sources exists.
    Returns (library path, seconds spent compiling, nvcc's ptxas report,
    kept beside the library for a later call)."""
    srcs = _sources()
    digest = hashlib.sha1()
    for s in srcs:
        digest.update(s.name.encode() + b"\0" + s.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"libutree_kernels_{digest.hexdigest()[:16]}.so"
    report = so.with_suffix(".ptxas.txt")
    if so.exists():
        return so, 0.0, report.read_text() if report.exists() else ""
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    t0 = time.perf_counter()
    jobs = []
    for src in (s for s in srcs if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True)))
    reports, failed = [], []
    for obj, proc in jobs:  # wait for every job, so none outlives the build
        out, err = proc.communicate()
        reports.append(out + err)
        if proc.returncode != 0:
            failed.append(f"nvcc -c {obj.name} failed ({proc.returncode}):\n{err}")
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *(str(o) for o, _ in jobs)],
            capture_output=True, text=True)
        if link.returncode != 0:
            failed.append(f"nvcc -shared failed ({link.returncode}):\n{link.stderr}")
    for obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("\n".join(failed))
    report.write_text("".join(reports))
    os.replace(tmp, so)  # atomic: a concurrent build never loads a torn file
    return so, time.perf_counter() - t0, "".join(reports)


def ptxas_usage(report: str) -> list[tuple[str, str]]:
    """(kernel, usage) for each entry function of nvcc's `-Xptxas -v` report
    (`build`'s third value): its mangled name, and its registers, barriers
    and shared and constant memory with its spill stores and loads."""
    out, name, spill = [], None, ""
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            name, spill = ln.split("'")[1], ""
        elif "spill stores" in ln:
            spill = ln.strip()
        elif name and "Used" in ln:
            out.append((name, f"{ln.split(':', 1)[1].strip()}; {spill}"))
            name = None
    return out


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    so, _, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.utree_error_string.argtypes = [ctypes.c_int]
    lib.utree_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = library().utree_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg}) at launch")
