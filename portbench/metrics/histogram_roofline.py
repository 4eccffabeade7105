"""K2's share of its bound, in percent.

Kernels: K2 `histogram*` by name.  Bytes, PERF.md's rule for K2 (its ids in,
its (B, cap+1) rows out), counted for the cell's work: each valid window's
label id (both strands with RC) at the DB's label width (IXTYPE, 2 B for
u16), plus 4 B for each of a batch's (cap + 1) row slots.  Bound: bytes over
the HBM bandwidth; share: bound over the kernels' summed device time.
None of the kernels in the trace: no reading, and a run on a card fails."""

KERNELS = r"\bhistogram(_kernel|_rows)\b"


def read(ctx):
    t = ctx.kernel_s(KERNELS)
    if not t:
        return None
    w = ctx.work
    need = w["ids"] * w["id_bytes"] + 4 * (w["hist_cap"] + 1) * w["rows"]
    return 100.0 * need / ctx.peaks["hbm_bytes_per_s"] / t
