"""Hand-written Hopper kernels of the search step and their launch counts.

Three kernels carry the main path (sources in `utree_tpu_torch/csrc/`):

  scan_probe   packed reads -> per-window label ids    (lookup.window_ids)
  histogram    ids -> compact per-read histograms      (lookup.histogram)
  aufbau_vote  histograms -> 12 B/read vote rows       (classify_device.vote_rows)

Each wrapper calls `launch`, which adds one to the kernel's entry in
`launches` after a launch that CUDA accepted; nothing else touches
the counts except `reset_launches`.
"""

from __future__ import annotations

from utree_tpu_torch.kernels.build import build, check, library

KERNELS = ("scan_probe", "histogram", "aufbau_vote")
launches: dict[str, int] = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for k in KERNELS:
        launches[k] = 0


def require(t, name: str, dtype, ndim: int, device) -> None:
    """Raise unless `t` is a contiguous `ndim`-d `dtype` tensor on `device`:
    a kernel reads raw pointers and checks nothing itself."""
    if t.dtype != dtype or t.dim() != ndim:
        raise ValueError(f"{name}: want {ndim}-d {dtype}, got {t.dim()}-d {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(name: str, *args) -> None:
    """Call the C entry point `utree_<name>` and count the launch."""
    err = getattr(library(), "utree_" + name)(*args)
    check(err, name)
    launches[name] += 1


__all__ = ["KERNELS", "build", "launch", "launches", "library", "require",
           "reset_launches"]
