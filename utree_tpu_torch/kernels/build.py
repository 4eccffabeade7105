"""Build and load the hand-written CUDA kernels (`utree_tpu_torch/csrc/*.cu`).

The sources compile with `nvcc` into one shared library with a plain C
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P = ctypes.c_void_p
I32 = ctypes.c_int32
I64 = ctypes.c_int64

# C entry point -> argtypes.  Every pointer and the stream are c_void_p (a
# plain int would be cut to 32 bits); each returns cudaGetLastError().
SIGNATURES = {
    "utree_scan_probe": [P, P, P, I64, I64, I64, I32,
                         P, I64, P, I64, P, I64, I32, I32, I32, P, P],
    "utree_histogram": [P, I64, I32, I32, I32, P, P, P, P, P],
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
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in srcs if s.suffix == ".cu"]]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent build never loads a torn file
    return so, dt, r.stderr


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
