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

# C entry point -> argtypes.  Every pointer and the stream are c_void_p (a
# plain int would be cut to 32 bits); each returns cudaGetLastError().
_SCAN = [P, P, P, I64, I64, I64, I32,     # packed, vbits, lens, B, row4, row8, W
         P, I64, P, I64, P, I64, I32,     # d1, nslots, ds, nseed, d3, n3, s3
         I32, I32, P, P]                  # do_rc, bad_ix, out, stream
_LADDER = [P, P, P, I64, I64, I64, I32,
           P, I64, I32, P, I64, I32, P, I64, I32,  # (rows, nrows, slots) x 3
           I32, I32, P, P]
_HIST_ROWS = [P, I64, I32, I32, I32, P, P]  # ids, B, n, num_labels, cap, rows, stream
SIGNATURES = {
    "utree_scan_probe": _SCAN,
    "utree_scan_probe_wide": _SCAN,
    "utree_ladder_probe": _LADDER,
    "utree_ladder_probe_wide": _LADDER,
    "utree_bsearch_probe": [P, P, P, I64, I64, I64, I32,
                            P, P, P, P, I64,  # bin_ix, suf_hi, suf_lo, ix, n
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
    "utree_aufbau_vote": [P, P, P, P, I64, I32,
                          P, P, I32, I32, P, P, P, I32, P, I32,
                          I32, I32, P, P],
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
    Returns (library path, seconds spent compiling, nvcc's ptxas report)."""
    srcs = _sources()
    digest = hashlib.sha1()
    for s in srcs:
        digest.update(s.name.encode() + b"\0" + s.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    so = BUILD_DIR / f"libutree_kernels_{digest.hexdigest()[:16]}.so"
    if so.exists():
        return so, 0.0, ""
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
    os.replace(tmp, so)  # atomic: a concurrent build never loads a torn file
    return so, time.perf_counter() - t0, "".join(reports)


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
