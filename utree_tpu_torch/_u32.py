"""Unsigned 32-bit arithmetic for the plain PyTorch versions.

PyTorch's CPU kernels implement no `>>`, `%`, `<` or `minimum` for
`torch.uint32`, and `>>` on `int32` shifts arithmetically.  The plain
versions therefore hold every u32 lane as an int64 tensor in [0, 2^32) and
mask after each operation that can leave that range.  The CUDA kernels use
true `uint32_t` arithmetic; these helpers are the reference they are held to.
"""

from __future__ import annotations

import torch

M = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """Reinterpret int32 bits (or any integer tensor) as a u32 lane in int64."""
    return x.to(torch.int64) & M


def i32(x: torch.Tensor) -> torch.Tensor:
    """A u32 lane (int64) -> its int32 bit pattern (JAX's u32 -> i32 cast)."""
    x = x & M
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def mul32(a: torch.Tensor, b) -> torch.Tensor:
    """(a * b) mod 2^32 for u32 lanes a, b.  b is split into 16-bit halves so
    no int64 partial product exceeds 2^49 (a full 32x32-bit product can pass
    2^63, and signed overflow is not relied upon)."""
    return (a * (b & 0xFFFF) + (((a * ((b >> 16) & 0xFFFF)) & 0xFFFF) << 16)) & M


def floor_log2(n: torch.Tensor) -> torch.Tensor:
    """floor(log2(n)) for integer n >= 1, i.e. `31 - clz(n)` of a 32-bit n.
    Exact: frexp of a float64 holding an integer below 2^53 is exact."""
    _, e = torch.frexp(n.to(torch.float64))
    return (e - 1).to(torch.int64)


def jax_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's gather index semantics: a negative index wraps once (idx + n),
    then clamps to [0, n-1].  JAX gathers never fault; torch's raise and a
    CUDA kernel would read wild memory, so every gather that JAX may issue
    out of range goes through this."""
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
