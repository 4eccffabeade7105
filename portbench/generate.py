"""The inputs of a cell, made from `--seed`: a reference database and a sample
of reads.

The recipe is bench.py's and chip_smoke.py's (`tier_kmers`, `make_reads`),
copied here and moved onto the device:

- genomes: uniform random bases, one genome a leaf label, concatenated;
- database: every k-mer window whose `complevel` preceding bases spell
  "AGCT"[:complevel], as the reference build samples them (itree.c:603-623),
  sorted and de-duplicated (first occurrence kept), labelled by the genome it
  starts in; a seeded share of fixed-length segments carries the label of the
  genome's ancestor at one rank instead, standing for sequence that related
  genomes share (the build folds such k-mers to their common ancestor);
- reads: `read_len` bases from uniform positions over all genomes, a share of
  bases substituted, a share of reads replaced by random bases.

The genome is made in chunks on the device, so a 16 Gbp set of genomes never
lives in memory at once.  Everything else is a handful of large calls.
"""

from __future__ import annotations

import time

import numpy as np
import torch

K = 32
PRE_BITS = 24  # the CTR's bin prefix (itree.c:690)
SUF_BITS = K * 2 - PRE_BITS
GATE = (0, 2, 1, 3)  # "AGCT" as 2-bit codes (A0 C1 G2 T3, itree.c:110-121)
ACGT = b"ACGT"
CHUNK = 1 << 30  # genome bases made at a time on the device


def taxonomy(labels: dict, rng: np.random.Generator):
    """Label strings of `labels["leaves"]` leaves of len(ranks) ranks, and for
    each leaf (one genome each) its own label id and the id of its ancestor's
    label at rank `shared_rank`.  A node's name is 4 seeded letters and its
    number, so names are distinct."""
    ranks = labels["ranks"].encode()
    per_node = labels["leaves_per_node"]
    n_leaves = labels["leaves"]
    shared_rank = labels["shared_rank"]
    if len(per_node) != len(ranks) or per_node[-1] != 1:
        raise ValueError("leaves_per_node needs one entry a rank, 1 at the leaves")
    names = []
    for r, per in enumerate(per_node):
        nodes = -(-n_leaves // per)
        letters = rng.integers(97, 123, size=(nodes, 4), dtype=np.uint8)
        names.append([ranks[r:r + 1] + b"__" + bytes(letters[i]) + b"%d" % i
                      for i in range(nodes)])
    leaf = [b";".join(names[r][i // per] for r, per in enumerate(per_node))
            for i in range(n_leaves)]
    per = per_node[shared_rank]
    ancestors = [b";".join(names[r][a * per // p] for r, p in
                           enumerate(per_node[:shared_rank + 1]))
                 for a in range(-(-n_leaves // per))]
    leaf_id = np.arange(n_leaves, dtype=np.int64)
    shared_id = n_leaves + leaf_id // per
    return leaf + ancestors, leaf_id, shared_id


def _windows(text: torch.Tensor, first: int, lv: int):
    """Start offsets in `text` (2-bit codes) of the k-mer windows from `first`
    on whose lv preceding codes are the gate, and each window's CTR prefix
    and suffix (int64: 24 and 40 bits)."""
    last = len(text) - K  # last start with a whole window
    first = max(first, lv)
    if last < first:
        z = torch.zeros(0, dtype=torch.int64, device=text.device)
        return z, z, z
    ok = torch.ones(last - first + 1, dtype=torch.bool, device=text.device)
    for t in range(lv):
        ok &= text[first - lv + t:last - lv + t + 1] == GATE[t]
    s = torch.nonzero(ok).squeeze(1) + first
    pre = torch.zeros_like(s)
    suf = torch.zeros_like(s)
    for t in range(K):
        code = text[s + t].long()
        if t < PRE_BITS // 2:
            pre = (pre << 2) | code
        else:
            suf = (suf << 2) | code
    return s, pre, suf


def make_inputs(config: dict, traffic: dict, seed: int, device, chunk: int = CHUNK) -> dict:
    """The database and the sample of one run.  Returns host arrays:
    `words` (uint64, sorted, unique), `ixs` (int64 label ids), `strings`
    (label strings), `reads` ((n, read_len) uint8 ASCII), and `gen_s`."""
    t0 = time.perf_counter()
    device = torch.device(device)
    lv = config["complevel"]
    genome = config["kmers"] * 4 ** lv  # about `kmers` gated windows
    L, n_reads = traffic["read_len"], traffic["reads"]
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    strings, leaf_id, shared_id = taxonomy(config["labels"], rng)
    n_gen = len(leaf_id)
    leaf_t = torch.as_tensor(leaf_id, device=device)
    shared_t = torch.as_tensor(shared_id, device=device)
    seg = config["shared"]["segment_bp"]
    shared = torch.rand(-(-genome // seg), generator=g, device=device) < config["shared"]["share"]
    starts = torch.randint(0, genome - L + 1, (n_reads,), generator=g, device=device)
    starts, order = torch.sort(starts, stable=True)
    reads = torch.empty((n_reads, L), dtype=torch.uint8, device=device)
    keep = max(L, K + lv)  # bases carried into the next chunk
    carry = torch.zeros(0, dtype=torch.uint8, device=device)
    keys, labs = [], []
    pos = 0  # global position of the next new base
    while pos < genome:
        n = min(chunk, genome - pos)
        text = torch.cat([carry, torch.randint(0, 4, (n,), dtype=torch.uint8,
                                               generator=g, device=device)])
        base = pos - len(carry)  # global position of text[0]
        # windows ending in the new bases; the carried ones were taken before
        s, pre, suf = _windows(text, max(0, len(carry) - K + 1), lv)
        s += base
        gen_of = torch.clamp(s * n_gen // genome, max=n_gen - 1)
        labs.append(torch.where(shared[torch.clamp(s // seg, max=len(shared) - 1)],
                                shared_t[gen_of], leaf_t[gen_of]))
        keys.append(((pre - (1 << (PRE_BITS - 1))) << SUF_BITS) | suf)
        # reads ending in the new bases
        a, b = torch.searchsorted(starts, torch.tensor(
            [pos - L + 1, pos + n - L + 1], device=device)).tolist()
        if b > a:
            off = (starts[a:b] - base)[:, None] + torch.arange(L, device=device)
            reads[a:b] = text[off]
        pos += n
        carry = text[-keep:]
    del text, carry, shared
    # sort by the unsigned word: the prefix is offset by 2^23, so the signed
    # key orders as the word does
    key, perm = torch.sort(torch.cat(keys), stable=True)
    lab = torch.cat(labs)[perm]
    del keys, labs, perm
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    key, lab = key[first], lab[first]
    out = torch.empty_like(reads)
    out[order] = reads
    del reads
    mut = torch.rand((n_reads, L), generator=g, device=device) < traffic["substitution"]
    out = torch.where(mut, torch.randint(0, 4, (n_reads, L), dtype=torch.uint8,
                                         generator=g, device=device), out)
    rand_rows = torch.rand(n_reads, generator=g, device=device) < traffic["random_share"]
    out = torch.where(rand_rows[:, None], torch.randint(0, 4, (n_reads, L), dtype=torch.uint8,
                                                        generator=g, device=device), out)
    lut = torch.frombuffer(bytearray(ACGT), dtype=torch.uint8).to(device)
    words = key.cpu().numpy().view(np.uint64) ^ np.uint64(1 << 63)
    result = dict(words=words, ixs=lab.cpu().numpy().astype(np.int64), strings=strings,
                  reads=lut[out.long()].cpu().numpy(), genome_bp=genome)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    result["gen_s"] = time.perf_counter() - t0
    return result


def fasta_bytes(reads: np.ndarray) -> bytes:
    """The sample as FASTA: `>r%07d` names, one line of sequence each."""
    n, L = reads.shape
    if n > 10_000_000:
        raise ValueError("names hold 7 digits")
    rec = np.empty((n, L + 11), np.uint8)
    rec[:, 0], rec[:, 1], rec[:, 9], rec[:, -1] = ord(">"), ord("r"), 10, 10
    i = np.arange(n)
    for d in range(7):
        rec[:, 8 - d] = 48 + (i // 10 ** d) % 10
    rec[:, 10:10 + L] = reads
    return rec.tobytes()


def read_name(i: int) -> bytes:
    return b"r%07d" % i
