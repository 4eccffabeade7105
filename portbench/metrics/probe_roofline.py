"""The probe kernels' share of their bound, in percent.

Kernels: the 32-mer probes a `lookup_mode` resolves to, by name (K1 scan_probe, K4
ladder_probe, K7 bsearch_probe, K10 hash_probe).  Bytes: what the cell's
lookups need whatever implements them: for each batch, one 32 B sector for
each read position with a valid 32-mer (a canonical lookup answers both
strands), or the CTR table read once where that is less (7 B a record and
the 2^24 + 1 four-byte bin offsets), plus the reads at 3 bits a base (2-bit
code and validity).  Bound: bytes over the HBM bandwidth; share: bound over
the kernels' summed device time.  None of the kernels in the trace: no
reading, and a run on a card fails."""

KERNELS = r"\b(scan_probe|ladder_probe|bsearch_probe|hash_probe)_kernel\b"


def read(ctx):
    t = ctx.kernel_s(KERNELS)
    if not t:
        return None
    w = ctx.work
    need = sum(min(32 * n, w["ctr_bytes"]) for n in w["batch_positions"]) + w["read_bytes"]
    return 100.0 * need / ctx.peaks["hbm_bytes_per_s"] / t
