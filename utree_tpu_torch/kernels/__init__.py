"""Hand-written Hopper kernels of the search step and of xtree ALIGN, and
their launch counts.

Eighteen kernels in twenty-six entry points (sources in `utree_tpu_torch/csrc/`):

  K14 ascii_pack          ASCII reads -> packed reads + validity bits, or
                          append_rc's layout         (lookup.ascii_pack)
  K1 scan_probe[_wide]    packed reads -> ids, displaced table (lookup.window_ids)
  K4 ladder_probe[_wide]  packed reads -> ids, canonical ladder (lookup.window_ids)
  K7 bsearch_probe        packed reads -> ids, bsearch replay  (lookup.window_ids)
  K10 hash_probe          packed reads -> ids, legacy hash     (lookup.window_ids)
  K5 scan_probe64         ASCII reads -> ids, 64-mer displaced (lookup.window_ids64)
  K6 ladder_probe64       ASCII reads -> ids, 64-mer ladder    (lookup.window_ids64)
  K2 histogram            ids -> compact histograms        (lookup.histogram)
     histogram_packed     ids -> (B, cap+1) packed rows    (lookup.histogram_packed)
     histogram_unpacked   ids -> (B, 2*cap+2) rows         (lookup.histogram_unpacked)
  K8 hist_compact         packed rows -> compact readback  (lookup.hist_compact)
  K3 aufbau_vote          histograms -> 12 B/read votes    (classify_device.vote_rows)
  K9 xtree_probe          ASCII queries -> xtree seeds and prefix bins
                          (xtree.device.xtree_step)
  K11 route_displaced     packed reads -> routed lanes, send buffer, owner
                          counts, for both routed tables
                          (parallel.routed.route_displaced)
  K12 owner_probe[_wide]  routed lanes -> raw values in one shard's table
                          slice                 (parallel.routed.owner_probe)
  K13 routed_finish[_wide] lane records + routed values -> ids
                          (parallel.routed.routed_finish)
  K17 canonical_owner_probe[_wide] routed lanes -> raw values in one
                          shard's canonical t1 slice
                          (parallel.routed.canonical_owner_probe)
  K18 routed_canonical_finish[_wide] lane records + routed values -> ids
                          through the replicated c2/c3 tail
                          (parallel.routed.routed_canonical_finish)
  K15 bsearch_probe_shard packed reads -> where(found, ix, 0) and found in one
                          prefix slice of the records
                          (parallel.sharded.shard_probe)
  K16 label_histogram     ids -> one per-label hit count
                          (parallel.sharded.label_histogram)

`_wide` takes 4-column slots (IXTYPE=u32 label ids).  Each wrapper calls
`launch`, which adds one to the entry point's count in `launches` after a
launch that CUDA accepted; nothing else touches the counts except
`reset_launches`.
"""

from __future__ import annotations

from utree_tpu_torch.kernels.build import build, check, library, ptxas_usage

KERNELS = ("ascii_pack", "scan_probe", "scan_probe_wide", "ladder_probe",
           "ladder_probe_wide", "bsearch_probe", "hash_probe", "scan_probe64", "ladder_probe64",
           "histogram", "histogram_packed", "histogram_unpacked", "hist_compact",
           "aufbau_vote", "xtree_probe", "route_displaced", "owner_probe",
           "owner_probe_wide", "routed_finish", "routed_finish_wide",
           "bsearch_probe_shard", "label_histogram", "canonical_owner_probe",
           "canonical_owner_probe_wide", "routed_canonical_finish",
           "routed_canonical_finish_wide")
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


def stream(device) -> int:
    """The handle of `device`'s current CUDA stream, for a launch: what
    `torch.cuda.current_stream(device).cuda_stream` gives, without making a
    Stream object (a few us of host time a call)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)


def launch(name: str, *args) -> None:
    """Call the C entry point `utree_<name>` and count the launch."""
    err = getattr(library(), "utree_" + name)(*args)
    check(err, name)
    launches[name] += 1


__all__ = ["KERNELS", "build", "launch", "launches", "library", "ptxas_usage",
           "require", "reset_launches", "stream"]
