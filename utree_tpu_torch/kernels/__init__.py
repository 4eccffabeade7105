"""Hand-written Hopper kernels of the search step and their launch counts.

Seven kernels in eleven entry points (sources in `utree_tpu_torch/csrc/`):

  K1 scan_probe[_wide]    packed reads -> ids, displaced table (lookup.window_ids)
  K4 ladder_probe[_wide]  packed reads -> ids, canonical ladder (lookup.window_ids)
  K7 bsearch_probe        packed reads -> ids, bsearch replay  (lookup.window_ids)
  K5 scan_probe64         ASCII reads -> ids, 64-mer displaced (lookup.window_ids64)
  K6 ladder_probe64       ASCII reads -> ids, 64-mer ladder    (lookup.window_ids64)
  K2 histogram            ids -> compact histograms        (lookup.histogram)
     histogram_packed     ids -> (B, cap+1) packed rows    (lookup.histogram_packed)
     histogram_unpacked   ids -> (B, 2*cap+2) rows         (lookup.histogram_unpacked)
  K3 aufbau_vote          histograms -> 12 B/read votes    (classify_device.vote_rows)

`_wide` takes 4-column slots (IXTYPE=u32 label ids).  Each wrapper calls
`launch`, which adds one to the entry point's count in `launches` after a
launch that CUDA accepted; nothing else touches the counts except
`reset_launches`.
"""

from __future__ import annotations

from utree_tpu_torch.kernels.build import build, check, library

KERNELS = ("scan_probe", "scan_probe_wide", "ladder_probe", "ladder_probe_wide",
           "bsearch_probe", "scan_probe64", "ladder_probe64",
           "histogram", "histogram_packed", "histogram_unpacked", "aufbau_vote")
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
