#!/usr/bin/env python3
"""Time the probes K1 scan_probe[_wide], K4 ladder_probe[_wide], K7
bsearch_probe, K15 bsearch_probe_shard, K10 hash_probe, K5 scan_probe64,
K6 ladder_probe64, K9 xtree_probe, K2's histograms, K11 route_displaced,
the routed owner probes K12 owner_probe[_wide] and K17
canonical_owner_probe[_wide], K3 aufbau_vote and K8 hist_compact of one or
more checkouts of this repository on one NVIDIA GPU, on the same inputs,
at chip_smoke.py's shapes, with each call's device time split by launch.

    python3 kernel_ab.py [TREE ...] [--out FILE] [--only RE]

Each TREE is the root of a checkout (default: this one); give the same tree
more than once to interleave, e.g. `kernel_ab.py old . . old` for an A/B
(old, new, new, old).  The inputs are made once, by this checkout's code on
the card, and only those the selected calls need: chip_smoke's 20M-k-mer
tier (4096 labels) with its CTR records, its legacy hash (t1/t2), its
displaced table and its canonical ladder, phase 7's 2M-k-mer tier of
70,000 labels (IXTYPE=u32) with both tables, and phase 9's 20M 64-mer tier
of 70,000 labels (chip_smoke.tier64) with its 64-mer ladder and displaced
table, phase 12's xtree table, and both tiers' tables cut four ways for
the routed owner probes;

- K1 and K4 at phase 3's and phase 6's shape (65,536 reads of 150 bp,
  true_len 152, 121 windows, RC) on the 20M tier's tables, and their
  `_wide` entry points at that shape on the 2M tier's (phase 7's wide
  displaced batch); with the count of 32 B sectors the valid windows'
  first-level rows touch (a narrow row of 24 B straddles two for half the
  row indices), and, as a yardstick, torch.index_select of those rows;
- K7 at phase 10's shape (the same batch over the 20M tier's records),
  with the count of words whose prefix bin is empty, holds one record or
  more; as a yardstick, not K7's function (the replay differs on merged
  bins), torch.searchsorted of the valid windows' 64-bit words of both
  strands over the records' sorted 64-bit keys;
- K15 at phase 18's (2, 4) and (1, 8) shapes: slice 0 of the 20M tier's
  records cut four and eight ways (its 16 B records `rec`, as
  ShardedIndex.to_devices places them, and the three arrays as contiguous
  copies, which K15 read before it took `rec`), the batch's reads packed
  by K14 at width 150, RC; with the count of words in the slice's range
  and the share of each warp's lanes whose word is in range (a warp of 32
  consecutive (read, window) lanes);
- K10 at phase 13's shape (the same batch, true_len 152, RC) on the 20M
  tier's t1/t2, with the count of valid words t1 does not answer; as a
  yardstick, not K10's function, torch.index_select of the valid words'
  t1 rows, forward and RC (96 B a row, each also written out);
- K6 and K5 at phase 9's shape (65,536 ASCII reads of 150 bp in rows of
  192, 129 windows of which 87 valid, RC) on the 64-mer ladder and
  displaced table, with the count of valid windows whose key reaches
  c64_2 and c64_3 and the size of K5's seed table d64_s; as yardsticks,
  torch.index_select of the valid windows' c64_1 rows and of their d64_1
  rows;
- K9 at phase 12's shape (8192 queries of 150 bp in rows of 192, k=29)
  on the xtree table of phase 12's 64 references of 312,500 bp
  (XtreeAligner(db).tables); as a yardstick, not K9's function,
  torch.index_select of the valid windows' d1 rows;
- K2 `histogram_packed` at each of phase 8's 16 long reads' chunk shapes
  (2-64 rows of 16,834-31,250 ids, as SearchPipeline.classify_long_read
  cuts them; calls `histogram_packed long read 0` to `15`, their shapes
  in the inputs line), and K2 `histogram` and `histogram_packed` at phase 3's
  shape (65,536 reads of 150 bp, 242 ids a read: the register branch);
- K11 `route_displaced` at phase 15's shard shape (16,384 reads of 192
  positions, 161 windows, 4 owners, capacity 857,344) at the displaced
  table's seed count and at the ladder's b1 (phase 19);
- K12 and K17 on owner 0's receive buffer at that shape (four senders of
  16,384 reads each routing by K11, 4 x 857,344 lanes, base 0): narrow on
  shard 0 of the 20M tier's displaced table built four ways
  (ShardedDisplacedIndex) and of its ladder cut four ways
  (ShardedCanonicalIndex.from_canonical), wide on the 2M tier's of 70,000
  labels; with the count of the lanes the senders wrote (the rest are
  K11's zeroed tail, bucket 0 and key 0); as a yardstick, not the
  function, torch.index_select of the written lanes' first-level rows
  (K17: the t1 slice's row at the lane's bucket; K12: the d1 row at the
  seeded slot, by the plain version's seed and slot);
- K3 `aufbau_vote` at phase 3's shape (65,536 reads, cap 8, the 20M
  tier's displaced window ids through K2 `histogram`, the tier's vote
  tables, SearchPipeline's max_iters), with the batch's count of reads of
  two or more labels and of those that walk; K8 `hist_compact` at phase
  11's shape (K2 `histogram_packed` rows of the same ids, over_cap 8,192)
  and on the first 1024 of those rows (over_cap 64).

Then each tree runs in a process of its own (its `utree_tpu_torch` first on
sys.path, its kernels built into its own .cuda_build/): every call's mean
time over 200 launches from CUDA events after a warm-up, the host's time
to enqueue one (the wrapper's Python and the launches; where it exceeds
the device time the events measure the host), as the mean of the 200 and
as the least of 25 rounds of 40 calls (the host shares its cores, so the
least is the steadier), the device time of 50 calls
queued behind a device sleep (no host time), and, from torch.profiler,
the mean device time of each kernel and memset that the call launches
(so a tree whose entry point launches a split of its kernel, kept under
`.ab/` and never committed, reports each part), and ptxas's registers,
shared memory and spills of the probes.  The outputs of every tree must
be byte-identical.  Prints one JSON line per tree run and writes them all
to FILE (.bench_cache/kernel_ab.json by default).  --only times the calls
whose names match a regular expression, and makes only their inputs,
e.g. 'bsearch' (K7, K15 and the searchsorted yardstick), 'hash_probe'
(K10 and its t1 yardstick), 'probe64' (K5, K6 and their yardsticks),
'scan_probe64|hash_probe' (K5 and K10), '^(scan|ladder)_probe ' (K1 and
K4 narrow), 'histogram', 'route', 'xtree' (K9 and its d1 yardstick),
'xtree_probe|bsearch_probe_shard' (K9 and K15), 'owner_probe' (K12, K17
and their yardsticks) or 'aufbau_vote|hist_compact' (K3 and K8).

    python3 kernel_ab.py [TREE ...] --e2e [--rounds N] [--out FILE]

times instead the `search` passes whose device step is K3 or K8, all
trees in this one process, pass by pass in turn, on the same index and
reads.  The first tree's code builds chip_smoke's 20M-k-mer tier, its
displaced table and its 262,144 reads once; each tree's `utree_tpu_torch`
is imported on its own (its kernels built into its own .cuda_build/) and
builds its pipelines for three passes: `displaced` (phase 4, the main
path: K1, K2 histogram, K3; layout `vote`) and `bsearch` (phase 10: K7,
K2, K3; layout `vote`) over the 262,144 reads, and `support 8` (phase
11(b): K1, K2 histogram_packed, K8; layout `compact`, the vote on the
host) over the first 131,072.  A round runs every tree's three passes in
the order given, each tree's modules put in place of the others' in
sys.modules just before its pass, and every output must be byte-identical
to the first tree's.  Prints per pass and tree the median and best reads/s
of the rounds and the median of each pipeline phase (host seconds,
`pipe.tracer.phases`), one JSON line a tree, and, for two distinct trees,
each pass's pooled medians and quartiles and in how many pairs (A's and
B's runs of a round, in order) the second was the faster
(`e2e_compare`); writes the runs to FILE (.bench_cache/e2e_ab.json by
default).  The host shares its cores, so a round's rates vary by tens of
percent: compare medians over many rounds.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import importlib
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time
from collections.abc import Callable

import chip_smoke as cs

ROOT = pathlib.Path(__file__).resolve().parent
ITERS = 200
HOST_ROUNDS, HOST_CALLS = 25, 40  # the least enqueue time a call of 25 rounds of 40
TRUE_LEN = 152  # chip_smoke's true_len for 150 bp reads: W = 121 windows
QUEUED = 50  # calls queued behind a device sleep of QUEUE_CYCLES (> 50 ms)
QUEUE_CYCLES = 100_000_000
HIST_CAP = 8
PKG = "utree_tpu_torch"
E2E_PASSES = ("displaced", "bsearch", "support 8")  # --e2e's passes
L2_BYTES = 50 << 20  # an H100's L2 cache (NVIDIA's data sheet)


def _first_rows(table: dict, packed, vbits, lens) -> tuple:
    """The first-level row (d1 or c1) of each valid window of the batch, by
    the plain functions, and the table's row width in bytes."""
    from utree_tpu_torch import lookup as lk

    p, v = lk._trim(packed, vbits, TRUE_LEN)
    qpre, qhi, qlo, valid = lk.extract_windows(lk.base_codes_packed(p, v, lens))
    klo, khi, _ = lk.canonical_keys(qpre, qhi, qlo)
    if "d1" in table:
        t1, ds = table["d1"], table["ds"]
        bkt = lk.displaced_bucket(klo, khi, valid, 4 * ds.shape[0])
        slot = lk.displaced_slot(klo, khi, lk.displaced_seed(ds, bkt), valid,
                                 2 * t1.shape[0])
        rows = slot >> 1
    else:
        t1 = table["c1"]
        rows = lk.canonical_buckets(klo, khi, valid, t1.shape[0], 8)[0]
    return rows[valid], t1.shape[1] * 4


def _sectors(rows, nb: int) -> dict:
    """32 B sectors the valid windows' first-level rows touch: a row of
    `nb` bytes at offset row * nb spans one sector or two."""
    start = (rows * nb) % 32
    touched = (start + nb + 31) // 32
    return {"valid_windows": int(rows.numel()), "row_bytes": nb,
            "sectors": int(touched.sum()), "straddling": int((touched > 1).sum())}


def _bsearch_words(bs: dict, packed, vbits, lens):
    """The searchsorted yardstick's operands: the records' 64-bit words
    (prefix << 40 | suffix), sorted, and the valid windows' words of both
    strands."""
    import torch

    from utree_tpu_torch import lookup as lk

    bin_ix = bs["bin_ix"].long()
    n = bs["suf_hi"].shape[0] - 1
    pre = torch.repeat_interleave(torch.arange(bin_ix.shape[0] - 1, device=bin_ix.device),
                                  bin_ix[1:] - bin_ix[:-1])
    keys = ((pre << 40) | (bs["suf_hi"][:n].long() << 32)
            | (bs["suf_lo"][:n].long() & 0xFFFFFFFF)).sort().values
    p, v = lk._trim(packed, vbits, TRUE_LEN)
    qpre, qhi, qlo, valid = lk.extract_windows(lk.base_codes_packed(p, v, lens))
    words = [((a << 40) | (h << 32) | lo)[valid] for a, h, lo in
             ((qpre, qhi, qlo), lk.rc_word_lanes(qpre, qhi, qlo))]
    return keys, torch.cat(words)


def _t1_rows(t1, packed, vbits, lens):
    """The t1 row of each valid word of the batch, forward words then RC
    words, by the plain functions (lookup_kmers_hash's t1 bucket)."""
    import torch

    from utree_tpu_torch import lookup as lk

    p, v = lk._trim(packed, vbits, TRUE_LEN)
    qpre, qhi, qlo, valid = lk.extract_windows(lk.base_codes_packed(p, v, lens))
    return torch.cat([(lk.mix(*w) & (t1.shape[0] - 1))[valid]
                      for w in ((qpre, qhi, qlo), lk.rc_word_lanes(qpre, qhi, qlo))])


def _d64_1_rows(tab: dict, reads, lens):
    """The d64_1 row of each valid window of an ASCII batch, by the plain
    functions (lookup_kmers_displaced64's seed and slot)."""
    from utree_tpu_torch import lookup as lk

    k0, k1, k2, k3, valid = lk.extract_windows64(lk.base_codes(reads, lens))
    *c, _ = lk.canonicalize64(k0, k1, k2, k3)
    seeds, t1 = tab["d64_s"], tab["d64_1"]
    seed = lk.displaced_seed(seeds, lk._fold64(c) & (4 * seeds.shape[0] - 1))
    h = (lk.mul32(lk.mix4(*c, 0x94D049BB) ^ lk.mul32(seed, 0x85EBCA6B), 0xC2B2AE35)
         ^ lk.mul32(lk.mix4(*c, 0x7FEB352D) ^ lk.mul32(seed, 0xC2B2AE35), 0x85EBCA6B))
    return ((h % (2 * t1.shape[0])) >> 1)[valid]


def _c64_1_rows(tab: dict, reads, lens):
    """The c64_1 row of each valid window of an ASCII batch, by the plain
    functions."""
    from utree_tpu_torch import lookup as lk

    k0, k1, k2, k3, valid = lk.extract_windows64(lk.base_codes(reads, lens))
    *c, _ = lk.canonicalize64(k0, k1, k2, k3)
    return (lk._fold64(c) & (tab["c64_1"].shape[0] - 1))[valid]


def _slice_trips(packed, vbits, lens, lo: int, nbins: int) -> dict:
    """K15's words in one slice's range at width READ_LEN, by the plain
    functions: their count, the lanes (threads of the parent's kernel,
    one a (read, window)) whose forward or RC word is in range, and the
    mean share of a warp's 32 lanes whose forward (RC) word is."""
    import torch

    from utree_tpu_torch import lookup as lk

    codes = lk.base_codes_packed(packed, vbits, lens)[:, :cs.READ_LEN]
    qpre, qhi, qlo, valid = lk.extract_windows(codes)
    out = {"lanes": int(valid.numel()), "valid_words": 2 * int(valid.sum())}
    for tag, pre in (("fwd", qpre), ("rc", lk.rc_word_lanes(qpre, qhi, qlo)[0])):
        hit = (valid & (pre >= lo) & (pre < lo + nbins)).reshape(-1)
        pad = torch.zeros((-hit.numel()) % 32, dtype=torch.bool, device=hit.device)
        warps = torch.cat([hit, pad]).view(-1, 32)
        out[f"{tag}_in_range"] = int(hit.sum())
        out[f"{tag}_warp_share"] = round(float(warps.float().mean(1).mean()), 4)
        out[f"{tag}_warps_with_a_trip"] = round(float(warps.any(1).float().mean()), 4)
    return out


def _xtree_d1_rows(tables: dict, reads, lens, k: int):
    """The d1 row of each valid window of an xtree batch, by the plain
    functions (xtree_step_plain's canonical key, displaced_probe_raw's
    seed and slot)."""
    import torch

    from utree_tpu_torch import lookup as lk
    from utree_tpu_torch.xtree import device as xd

    w_hi, w_lo, valid = xd.extract_windows_k(lk.base_codes(reads, lens), k)
    r_hi, r_lo = xd.rc_lanes_k(w_hi, w_lo, k)
    fwd_le = (w_hi < r_hi) | ((w_hi == r_hi) & (w_lo <= r_lo))
    c_hi, c_lo = torch.where(fwd_le, w_hi, r_hi), torch.where(fwd_le, w_lo, r_lo)
    d1, ds = tables["d1"], tables["ds"]
    seed = lk.displaced_seed(ds, lk.displaced_bucket(c_lo, c_hi, valid, 4 * ds.shape[0]))
    slot = lk.displaced_slot(c_lo, c_hi, seed, valid, 2 * d1.shape[0])
    return (slot >> 1)[valid]


def _owner_buffer(packed, vbits, lens, nbkt: int, shards: int) -> tuple:
    """Owner 0's receive buffer at the routed step's shapes: each of
    `shards` senders routes its B/S rows by K11 (the step's capacity C)
    and owner 0 receives its block of each.  Returns the (S*C, 3) lanes,
    the mask of the slots a sender wrote (the rest are K11's zeroed tail)
    and C."""
    import torch

    from utree_tpu_torch.parallel import routed as R

    b, w = packed.shape[0] // shards, packed.shape[1] * 4 - 31
    c = max(128, -(-int(b * w / shards * R.CAPACITY_FACTOR) // 128) * 128)
    blocks, written = [], []
    for s in range(shards):
        rows = slice(s * b, (s + 1) * b)
        send, _, counts = R.route_displaced(packed[rows], vbits[rows], lens[rows],
                                            nseed=nbkt, num_shards=shards, capacity=c)
        blocks.append(send[0])
        written.append(torch.arange(c, device=send.device) < min(int(counts[0]), c))
    return torch.cat(blocks), torch.cat(written), c


def _owner_rows(kind: str, table: dict, lanes, written):
    """The first-level row of each written lane, by the plain versions'
    functions: K17's t1 row at the lane's bucket, K12's d1 row at the
    seeded slot (base 0)."""
    import torch

    from utree_tpu_torch import lookup as lk
    from utree_tpu_torch.parallel import routed as R

    t1 = table["t1"]
    _, local, klo, khi = R._lane_fields(lanes, 0, t1.shape[0] if "ds" not in table
                                        else 4 * table["ds"].shape[0])
    if kind == "owner_probe":
        seed = lk.displaced_seed(table["ds"], local)
        local = lk.displaced_slot(klo, khi, seed, torch.ones_like(written),
                                  2 * t1.shape[0]) >> 1
    return local[written]


def _inputs(path: pathlib.Path, dev, want: set[str], kmers: int = 20_000_000) -> str:
    """Make the inputs of the groups in `want` with this checkout's code on
    `dev`; save to path.  Returns what it made, as a line."""
    import numpy as np
    import torch

    from utree_tpu_torch import lookup
    from utree_tpu_torch.hash_index import (_canonical_groups, bsearch_to_device,
                                            build_canonical_hash_index,
                                            build_displaced_index, build_hash_index,
                                            canonical64_to_device,
                                            canonical_to_device, displaced64_to_device,
                                            displaced_nseed, displaced_to_device,
                                            hash_to_device)
    from utree_tpu_torch.hash_index64 import (build_canonical_hash_index64,
                                              build_displaced_index64)
    from utree_tpu_torch.parallel import sharded as S
    from utree_tpu_torch.parallel.routed import CAPACITY_FACTOR
    from utree_tpu_torch.pipeline import SearchPipeline

    def cpu(tab):
        return {k: v.cpu() for k, v in tab.items()}

    t = time.perf_counter()
    out, notes = {"groups": sorted(want)}, []
    if want & {"tier", "routed", "vote"}:
        index, genome, rng = cs.make_tier(kmers, cs.LABELS)
        L = index.num_labels
        reads = cs.make_reads(genome, rng, cs.BATCH)
        packed, vbits, lens = batch = cs.batch_tensors(dev, reads)
    if "tier" in want:
        tb = time.perf_counter()
        bs = bsearch_to_device(index, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        bins = cs.bsearch_bins(bs["bin_ix"], *batch, TRUE_LEN)
        keys, words = _bsearch_words(bs, *batch)
        # K15 at phase 18's (2, 4) and (1, 8) shapes: slice 0, the reads
        # packed by K14
        rt = torch.from_numpy(np.ascontiguousarray(reads)).to(dev)
        rl = torch.full((rt.shape[0],), cs.READ_LEN, dtype=torch.int32, device=dev)
        spk, svb = lookup.ascii_pack(rt, rl)
        shards = {}
        for s in (4, 8):
            sh = S.ShardedIndex.from_index(index, s)
            s0 = {k: torch.from_numpy(np.ascontiguousarray(a[0]).view(np.int32))
                  for k, a in (("bin_ix", sh.bin_ix), ("suf_hi", sh.suf_hi),
                               ("suf_lo", sh.suf_lo), ("ix", sh.ix))}
            s0["rec"] = torch.from_numpy(sh.slice_records(0))
            shards[s] = dict(table=s0, prefix_lo=int(sh.prefix_lo[0]), width=cs.READ_LEN,
                             trips=_slice_trips(spk, svb, rl, int(sh.prefix_lo[0]),
                                                sh.bin_ix.shape[1] - 1))
        # K10 at phase 13's shape: the 20M tier's legacy hash; the words t1
        # does not answer read a t2 row (the plain version over t1 alone)
        th = time.perf_counter()
        hashed = hash_to_device(build_hash_index(index), dev)
        hash_s = time.perf_counter() - th
        t1_rows = _t1_rows(hashed["t1"], *batch)
        t1_only = {"t1": hashed["t1"], "t2": torch.full((8, 24), -1, dtype=torch.int32,
                                                        device=dev)}
        t1_miss = int((lookup.window_ids_plain(
            t1_only, *batch, do_rc=True, bad_ix=0xFFFF, num_labels=L, true_len=TRUE_LEN)
            == 0xFFFF).sum()) - (2 * packed.shape[0] * (TRUE_LEN - 31) - t1_rows.numel())
        out.update(num_labels=L, probe_iters=index.probe_iters,
                   batch=[x.cpu() for x in batch], bsearch=cpu(bs), bins=bins,
                   bs_keys=keys.cpu(), bs_words=words.cpu(),
                   shard_batch=[x.cpu() for x in (spk, svb, rl)], shards=shards,
                   hash=cpu(hashed), t1_rows=t1_rows.cpu())
        notes.append(f"K7: {kmers:,} records on the card in {time.perf_counter() - tb:.2f} s "
                     f"({', '.join(f'{k} {tuple(v.shape)}' for k, v in bs.items())}); "
                     f"words by bin size {json.dumps(bins)}; searchsorted "
                     f"{words.numel():,} words over {keys.numel():,} keys; K15 slice 0 "
                     + "; ".join(f"of {s}, {v['table']['suf_hi'].shape[0]:,} records, "
                                 f"{json.dumps(v['trips'])}" for s, v in shards.items()))
        notes.append(f"K10: t1/t2 built and placed in {hash_s:.1f} s (" + ", ".join(
            f"{k} {tuple(v.shape)} {v.numel() * 4:,} B" for k, v in hashed.items())
                     + f"); {t1_rows.numel():,} valid words, {t1_miss:,} missing t1 "
                     f"({t1_miss / t1_rows.numel():.4f})")
    if "vote" in want:
        from utree_tpu_torch.classify_device import aufbau_tables_to_device, build_aufbau_tables

        disp = displaced_to_device(
            cs.load_or_build_displaced(index, kmers, cs.LABELS, ROOT / ".bench_cache"), dev)
        ids = lookup.window_ids(disp, packed, vbits, lens, do_rc=True, bad_ix=0xFFFF,
                                num_labels=L, true_len=(cs.READ_LEN + 7) & ~7)
        hist = lookup.histogram(ids, L, HIST_CAP)
        vt = build_aufbau_tables(index.strings)
        nuniq, found = hist[2].long(), hist[3].long()
        two = int((nuniq >= 2).sum())
        walk = int(((nuniq >= 2) & (nuniq <= HIST_CAP) & (found >= 2)).sum())
        out.update(vote={"hist": [x.cpu() for x in hist],
                         "tables": cpu(aufbau_tables_to_device(vt, dev)),
                         "taxacut": index.config.taxacut,
                         "max_iters": (vt.max_len + 4) * (HIST_CAP + 2) + 16,
                         "rows": lookup.histogram_packed(ids, L, HIST_CAP).cpu()})
        del disp
        notes.append(f"K3/K8: {packed.shape[0]:,} reads, cap {HIST_CAP}: {two:,} of two or "
                     f"more labels, {walk:,} walk; vote tables of {L} labels, max_len "
                     f"{vt.max_len}, max_iters {out['vote']['max_iters']}")
    if "tables" in want:
        canon = build_canonical_hash_index(index)
        ladder = canonical_to_device(canon, dev)
        disp = displaced_to_device(
            cs.load_or_build_displaced(index, kmers, cs.LABELS, ROOT / ".bench_cache"), dev)
        k = index.config.packsize
        firsts = {name: _first_rows(tab, *batch) for name, tab in (
            ("scan_probe", disp), ("ladder_probe", ladder))}
        kw = dict(do_rc=True, bad_ix=0xFFFF, num_labels=L)
        main = lookup.window_ids(ladder, packed, vbits, lens,
                                 true_len=(cs.READ_LEN + 7) & ~7, **kw)
        long_ids = [lookup.window_ids(ladder, *cs.long_read_chunks(
            dev, seq, k, SearchPipeline.long_chunk), **kw) for seq in cs.long_reads(genome)]
        shards, b = cs.ROUTED_SHARDS, cs.BATCH // cs.ROUTED_SHARDS
        w = packed.shape[1] * 4 - 31
        nseed = displaced_nseed(_canonical_groups(index)[-1])
        while nseed % shards:
            nseed *= 2
        cap = max(128, -(-int(b * w / shards * CAPACITY_FACTOR) // 128) * 128)
        out.update(main=main.cpu(), long=[x.cpu() for x in long_ids],
                   route=[x[:b].cpu() for x in batch], nseed=nseed,
                   b1=int(canon.t1.shape[0]), shards=shards, capacity=cap,
                   displaced=cpu(disp), ladder=cpu(ladder))
        notes.append(f"K1/K4/K2/K11: long reads 0-{len(long_ids) - 1} "
                     f"{[tuple(x.shape) for x in long_ids]}, main {tuple(main.shape)}, "
                     f"K11 {b} reads x {w} windows, nseed {nseed}, b1 {canon.t1.shape[0]}, "
                     f"capacity {cap}; d1 {tuple(disp['d1'].shape)}, c1 "
                     f"{tuple(ladder['c1'].shape)}")
    if "wide" in want or "routed" in want:
        windex, wgenome, wrng = cs.make_tier(cs.WIDE_DISPLACED_KMERS, cs.WIDE_LABELS,
                                             ixtype_bytes=4)
        wbatch = cs.batch_tensors(dev, cs.make_reads(wgenome, wrng, cs.BATCH))
    if "wide" in want:
        wtables = {"displaced": displaced_to_device(build_displaced_index(windex), dev),
                   "ladder": canonical_to_device(build_canonical_hash_index(windex), dev)}
        firsts = {**(firsts if "tables" in want else {}),
                  **{name: _first_rows(tab, *wbatch) for name, tab in (
                      ("scan_probe_wide", wtables["displaced"]),
                      ("ladder_probe_wide", wtables["ladder"]))}}
        out.update(wide_labels=windex.num_labels, wide_batch=[x.cpu() for x in wbatch],
                   wide={k: cpu(v) for k, v in wtables.items()})
        notes.append("wide " + ", ".join(f"{k} {tuple(v.shape)}" for tab in wtables.values()
                                         for k, v in tab.items()))
    if "tables" in want or "wide" in want:
        sectors = {name: _sectors(*f) for name, f in firsts.items()}
        out.update(sectors=sectors, first_rows={name: f[0].cpu() for name, f in firsts.items()})
        notes.append(f"first-level sectors {json.dumps(sectors)}")
    if "routed" in want:
        from utree_tpu_torch.parallel.routed import (ShardedCanonicalIndex,
                                                     ShardedDisplacedIndex)

        tr, S, routed = time.perf_counter(), cs.ROUTED_SHARDS, {}
        for width, ix, bt in (("narrow", index, batch), ("wide", windex, wbatch)):
            dsh = ShardedDisplacedIndex.build(ix, S)
            csh = ShardedCanonicalIndex.from_canonical(
                canon if width == "narrow" and "tables" in want
                else build_canonical_hash_index(ix), S)
            for kind, sh, nbkt, table in (
                    ("owner_probe", dsh, dsh.nseed,
                     {"t1": dsh.t1[0], "ds": dsh.seeds[0]}),
                    ("canonical_owner_probe", csh, csh.b1, {"t1": csh.t1[0]})):
                table = {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                         for k, a in table.items()}
                lanes, written, c = _owner_buffer(*bt, nbkt, S)
                rows = _owner_rows(kind, table, lanes, written)
                routed[width, kind] = dict(
                    table=cpu(table), lanes=lanes.cpu(), rows=rows.cpu(), per=nbkt // S,
                    capacity=c, written=int(written.sum()),
                    unwritten=int((~written).sum()), row_bytes=table["t1"].shape[1] * 4,
                    sectors=_sectors(rows, table["t1"].shape[1] * 4)["sectors"])
                del table
            del dsh, csh
        out.update(routed={f"{w} {k}": v for (w, k), v in routed.items()})
        notes.append("K12/K17: owner 0's receive buffer, " + "; ".join(
            f"{k} {w}: {v['lanes'].shape[0]:,} lanes (C {v['capacity']:,}), "
            f"{v['written']:,} written, {v['unwritten']:,} unwritten; t1 slice "
            f"{tuple(v['table']['t1'].shape)}"
            + (f", ds {tuple(v['table']['ds'].shape)}" if "ds" in v["table"] else "")
            + f"; the written lanes' rows touch {v['sectors']:,} sectors"
            for (w, k), v in routed.items()) + f" ({time.perf_counter() - tr:.1f} s)")
    if "k64" in want:
        index64, genome64, rng64 = cs.tier64(kmers, cs.WIDE_LABELS)
        reads64 = cs.make_reads(genome64, rng64, cs.BATCH)
        ascii_ = np.zeros((reads64.shape[0], 192), np.uint8)  # phase 9's rows
        ascii_[:, :cs.READ_LEN] = reads64
        rt = torch.from_numpy(ascii_).to(dev)
        rl = torch.full((rt.shape[0],), cs.READ_LEN, dtype=torch.int32, device=dev)
        t64 = {"ladder64": canonical64_to_device(build_canonical_hash_index64(index64), dev),
               "displaced64": displaced64_to_device(build_displaced_index64(index64), dev)}
        rows64 = _c64_1_rows(t64["ladder64"], rt, rl)
        d64_rows = _d64_1_rows(t64["displaced64"], rt, rl)
        reach = {"lanes": rt.shape[0] * (rt.shape[1] - 63), "valid": int(rows64.numel()),
                 **cs.ladder64_reach(t64["ladder64"], rt, rl)}
        seed_bytes = t64["displaced64"]["d64_s"].numel() * 4
        out.update(k64={"labels": index64.num_labels, "reads": rt.cpu(), "lens": rl.cpu(),
                        "rows": rows64.cpu(), "d64_rows": d64_rows.cpu(), "reach": reach,
                        **{k: cpu(v) for k, v in t64.items()}})
        notes.append(f"K5/K6: {index64.num_records:,} 64-mers, " + ", ".join(
            f"{k} {tuple(v.shape)}" for tab in t64.values() for k, v in tab.items())
                     + f"; windows {json.dumps(reach)}; K5's seed table d64_s "
                     f"{seed_bytes:,} B, {'within' if seed_bytes <= L2_BYTES else 'above'} "
                     "the card's 50 MB L2")
    if "xtree" in want:
        from utree_tpu_torch.xtree.align import XtreeAligner
        from utree_tpu_torch.xtree.build import build_xtree_db

        work = path.parent / "kernel_ab_xtree"
        work.mkdir(exist_ok=True)
        tx = time.perf_counter()
        genomes = cs.xtree_refs(work / "refs.fa", work / "tax.map", cs.XT_REFS, cs.XT_REF_LEN)
        queries = cs.xtree_queries(work / "queries.fa", genomes, cs.XT_QUERIES)
        al = XtreeAligner(build_xtree_db(str(work / "refs.fa"), str(work / "tax.map"),
                                         k=cs.XT_K, comp=0), device=dev)
        b = al.chunk_queries  # phase 12's K9 batch: the first chunk, rows of 192
        rows = np.zeros((b, 192), np.uint8)
        rows[:, :cs.READ_LEN] = queries[:b]
        xr = torch.from_numpy(rows).to(dev)
        xl = torch.full((b,), cs.READ_LEN, dtype=torch.int32, device=dev)
        d1_rows = _xtree_d1_rows(al.tables, xr, xl, al.k)
        out.update(xtree={"reads": xr.cpu(), "lens": xl.cpu(), "k": al.k, "sl": al.sl,
                          "tables": cpu(al.tables), "rows": d1_rows.cpu()})
        notes.append(f"K9: {al._dev_index.num_entries:,} entries at k={al.k}, " + ", ".join(
            f"{k} {tuple(v.shape)}" for k, v in al.tables.items())
                     + f"; {b} queries x {192 - al.k + 1} windows, {d1_rows.numel():,} "
                     f"valid ({time.perf_counter() - tx:.1f} s)")
        del al
    torch.save(out, path)
    note = "inputs: " + "; ".join(notes) + f" ({time.perf_counter() - t:.1f} s)"
    print(note, flush=True)
    return note


def _digest(outs) -> str:
    h = hashlib.sha1()
    for o in outs if isinstance(outs, (tuple, list)) else (outs,):
        h.update(o.cpu().numpy().tobytes())
    return h.hexdigest()


def _calls(inp: dict | None, dev) -> list[tuple[str, str, Callable]]:
    """Every call this script times, as (input group, name, make): make()
    moves the call's saved inputs from `inp` to `dev` (each once) and
    returns the call.  The names need no inputs, so main() makes the input
    groups of the calls that --only selects from this list alone (a long
    read's shape is in its inputs line, not its name)."""
    import torch

    from utree_tpu_torch import lookup
    from utree_tpu_torch.parallel import routed as R
    from utree_tpu_torch.parallel import sharded as S
    from utree_tpu_torch.xtree import device as XD

    held = {}

    def get(*keys):
        """inp[keys[0]][keys[1]]..., moved to dev once."""
        if keys not in held:
            x = inp
            for k in keys:
                x = x[k]
            held[keys] = ({k: v.to(dev) for k, v in x.items()} if isinstance(x, dict)
                          else [v.to(dev) for v in x] if isinstance(x, list) else x.to(dev))
        return held[keys]

    pkw = dict(do_rc=True, true_len=TRUE_LEN)

    def k7():
        bs, batch = get("bsearch"), get("batch")
        return lambda: lookup.window_ids(bs, *batch, bad_ix=0xFFFF, num_labels=inp["num_labels"],
                                         probe_iters=inp["probe_iters"], **pkw)

    def searchsorted():
        # a yardstick, not K7's function: a binary search of the same words
        keys, words = get("bs_keys"), get("bs_words")
        return lambda: torch.searchsorted(keys, words)

    def k15(s):
        sh, s0, sb = inp["shards"][s], get("shards", s, "table"), get("shard_batch")
        return lambda: S.shard_probe(s0, *sb, prefix_lo=sh["prefix_lo"], width=sh["width"],
                                     do_rc=True, probe_iters=inp["probe_iters"])

    def k9():
        x = inp["xtree"]
        tab, reads, lens = get("xtree", "tables"), get("xtree", "reads"), get("xtree", "lens")
        return lambda: XD.xtree_step(tab, reads, lens, k=x["k"], sl=x["sl"])

    def xtree_rows():
        # a yardstick, not K9's function: the valid windows' d1 rows
        d1, r = get("xtree", "tables")["d1"], get("xtree", "rows")
        return lambda: torch.index_select(d1, 0, r)

    def probe(tab, batch, labels, bad):
        table, args = get(*tab), get(batch)
        return lambda: lookup.window_ids(table, *args, bad_ix=bad, num_labels=inp[labels],
                                         **pkw)

    def rows(name, tab):
        # a yardstick, not the probe's function: the same first-level rows
        # gathered by torch.index_select (and written out, rows x row bytes)
        table, r = get(*tab), get("first_rows", name)
        first = table["d1" if "d1" in table else "c1"]
        return lambda: torch.index_select(first, 0, r)

    def hist(fn, *ids):
        x = get(*ids)
        return lambda: fn(x, inp["num_labels"], HIST_CAP)

    def route(tag):
        packed, vbits, lens = get("route")
        kw = dict(num_shards=inp["shards"], capacity=inp["capacity"], nseed=inp[tag])
        return lambda: R.route_displaced(packed, vbits, lens, **kw)

    def probe64(key):
        tab, reads, lens = get("k64", key), get("k64", "reads"), get("k64", "lens")
        return lambda: lookup.window_ids64(tab, reads, lens, do_rc=True, bad_ix=0x7FFFFFFF)

    def c64_rows():
        # a yardstick, not K6's function: the valid windows' c64_1 rows
        c1, r = get("k64", "ladder64")["c64_1"], get("k64", "rows")
        return lambda: torch.index_select(c1, 0, r)

    def d64_rows():
        # a yardstick, not K5's function: the valid windows' d64_1 rows
        d1, r = get("k64", "displaced64")["d64_1"], get("k64", "d64_rows")
        return lambda: torch.index_select(d1, 0, r)

    def k10():
        tab, batch = get("hash"), get("batch")
        return lambda: lookup.window_ids(tab, *batch, bad_ix=0xFFFF,
                                         num_labels=inp["num_labels"], **pkw)

    def t1_rows():
        # a yardstick, not K10's function: the valid words' t1 rows (96 B
        # each, written out too), forward then RC
        t1, r = get("hash")["t1"], get("t1_rows")
        return lambda: torch.index_select(t1, 0, r)

    def owner(key):
        r, wide = inp["routed"][key], key.startswith("wide")
        table, lanes = get("routed", key, "table"), get("routed", key, "lanes")
        if "ds" in table:
            return lambda: R.owner_probe(table["t1"], table["ds"], lanes, base=0,
                                         per_seed=r["per"], wide=wide)
        return lambda: R.canonical_owner_probe(table["t1"], lanes, base=0,
                                               per_shard=r["per"], wide=wide)

    def owner_rows(key):
        # a yardstick, not the function: the written lanes' first-level rows
        t1, r = get("routed", key, "table")["t1"], get("routed", key, "rows")
        return lambda: torch.index_select(t1, 0, r)

    def k3():
        from utree_tpu_torch import classify_device as cd

        v, hist, tab = inp["vote"], get("vote", "hist"), get("vote", "tables")
        # a tree that takes its vote tables prepared gets them prepared once,
        # as SearchPipeline places them
        prepared = getattr(cd, "VoteTables", None)
        tab = prepared(tab) if prepared else tab
        return lambda: cd.vote_rows(tab, *hist, taxacut=v["taxacut"], max_iters=v["max_iters"])

    def k8(b, over_cap):
        rows = get("vote", "rows")[:b].contiguous()
        return lambda: lookup.hist_compact(rows, over_cap)

    out = [("tier", "bsearch_probe main", k7),
           ("tier", "bsearch_probe words by searchsorted", searchsorted),
           ("tier", "bsearch_probe_shard (2, 4) slice 0", lambda: k15(4)),
           ("tier", "bsearch_probe_shard (1, 8) slice 0", lambda: k15(8)),
           ("tier", "hash_probe main", k10),
           ("tier", "hash_probe rows by index_select", t1_rows)]
    for group, sfx, batch, labels, bad, tabs in (
            ("tables", "", "batch", "num_labels", 0xFFFF, (("displaced",), ("ladder",))),
            ("wide", "_wide", "wide_batch", "wide_labels", 0x7FFFFFFF,
             (("wide", "displaced"), ("wide", "ladder")))):
        for kind, tab in zip(("scan_probe", "ladder_probe"), tabs):
            out += [(group, f"{kind}{sfx} main",
                     lambda tab=tab, batch=batch, labels=labels, bad=bad:
                     probe(tab, batch, labels, bad)),
                    (group, f"{kind}{sfx} rows by index_select",
                     lambda name=kind + sfx, tab=tab: rows(name, tab))]
    out += [("tables", "histogram main", lambda: hist(lookup.histogram, "main")),
            ("tables", "histogram_packed main", lambda: hist(lookup.histogram_packed, "main"))]
    out += [("tables", f"histogram_packed long read {i}",
             lambda i=i: hist(lookup.histogram_packed, "long", i))
            for i in range(cs.LONG_READS)]
    out += [("tables", f"route_displaced {tag}", lambda tag=tag: route(tag))
            for tag in ("nseed", "b1")]
    out += [("k64", "ladder_probe64 main", lambda: probe64("ladder64")),
            ("k64", "scan_probe64 main", lambda: probe64("displaced64")),
            ("k64", "ladder_probe64 rows by index_select", c64_rows),
            ("k64", "scan_probe64 rows by index_select", d64_rows),
            ("xtree", "xtree_probe main", k9),
            ("xtree", "xtree_probe rows by index_select", xtree_rows)]
    for kind in ("owner_probe", "canonical_owner_probe"):
        for width in ("narrow", "wide"):
            key = f"{width} {kind}"
            out += [("routed", f"{kind} {width}", lambda key=key: owner(key)),
                    ("routed", f"{kind} {width} rows by index_select",
                     lambda key=key: owner_rows(key))]
    out += [("vote", "aufbau_vote main", k3),
            ("vote", "hist_compact main", lambda: k8(cs.BATCH, cs.BATCH // 8)),
            ("vote", "hist_compact B=1024", lambda: k8(1024, 64))]
    return out


def groups(only: str) -> set[str]:
    """The input groups of the calls `only` selects ('tables' needs the
    tier's)."""
    want = {group for group, name, _ in _calls(None, None) if re.search(only, name)}
    return want | ({"tier"} if "tables" in want else set())


def _worker(tree: pathlib.Path, inputs: pathlib.Path, dev, only: str) -> dict:
    """Time one tree's kernels on the saved inputs, on `dev`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(tree))
    import utree_tpu_torch
    from utree_tpu_torch.kernels.build import build, ptxas_usage

    if pathlib.Path(utree_tpu_torch.__file__).resolve().parent.parent != tree:
        raise SystemExit(f"imported {utree_tpu_torch.__file__}, not {tree}'s package")
    inp = torch.load(inputs)
    _, secs, report = build()
    calls = {name: make() for group, name, make in _calls(inp, dev)
             if group in inp["groups"] and re.search(only, name)}
    res = {}
    for name, fn in calls.items():
        digest = _digest(fn())
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        t = time.perf_counter()
        for _ in range(ITERS):
            fn()
        host = time.perf_counter() - t  # the enqueue: launches queue, no sync
        end.record()
        torch.cuda.synchronize()
        least = float("inf")  # the host shares its cores: the least round is the steadier
        for _ in range(HOST_ROUNDS):
            t = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            least = min(least, (time.perf_counter() - t) / HOST_CALLS)
            torch.cuda.synchronize()
        torch.cuda.synchronize()
        # the device time: the calls queued behind a device sleep run back
        # to back (chip_smoke.device_ms)
        q0, q1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(QUEUE_CYCLES)
        q0.record()
        for _ in range(QUEUED):
            fn()
        q1.record()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        split = {}  # the device's events only: kernels, memsets, copies
        for e in prof.key_averages():
            us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
            if e.device_type == DeviceType.CUDA and us > 0:
                split[e.key[:90]] = {"count": e.count, "mean_us": us / e.count}
        res[name] = {"ms": start.elapsed_time(end) / ITERS,
                     "host_us": host / ITERS * 1e6, "host_us_min": least * 1e6,
                     "device_ms": q0.elapsed_time(q1) / QUEUED, "sha1": digest,
                     "split": split}
    usage = {k: v for k, v in ptxas_usage(report)
             if re.search(r"probe|route|aufbau|compact|pairs|scatter|k\d+_", k)}
    return {"tree": str(tree), "build_s": secs, "ptxas": usage, "calls": res}


def _modules() -> dict:
    """The imported modules of utree_tpu_torch, by name."""
    return {k: v for k, v in sys.modules.items() if k == PKG or k.startswith(PKG + ".")}


@contextlib.contextmanager
def using(mods: dict):
    """The tree's modules in sys.modules, so that its lazy imports find them
    (a submodule not yet imported comes from its package's own directory);
    what the tree imports meanwhile joins `mods`."""
    for k in _modules():
        del sys.modules[k]
    sys.modules.update(mods)
    try:
        yield
    finally:
        mods.update(_modules())


def load_tree(tree: pathlib.Path) -> dict:
    """Import tree's package on its own and build its kernels."""
    for k in _modules():
        del sys.modules[k]
    sys.path.insert(0, str(tree))
    try:
        pkg = importlib.import_module(PKG)
        for sub in ("kernels", "lookup", "classify_device", "hash_index", "pipeline"):
            importlib.import_module(f"{PKG}.{sub}")
    finally:
        sys.path.remove(str(tree))
    if pathlib.Path(pkg.__file__).resolve().parent.parent != tree:
        raise SystemExit(f"imported {pkg.__file__}, not {tree}'s package")
    mods = _modules()
    import torch

    if torch.cuda.is_available():
        mods[f"{PKG}.kernels"].build()
    return mods


def e2e_tier(dev, kmers: int, nreads: int, work: pathlib.Path) -> dict:
    """chip_smoke.run's tier, table and reads, for --e2e."""
    from utree_tpu_torch.classify_device import aufbau_tables_to_device, build_aufbau_tables
    from utree_tpu_torch.hash_index import displaced_to_device

    index, genome, rng = cs.make_tier(kmers, cs.LABELS)
    disp = cs.load_or_build_displaced(index, kmers, cs.LABELS, ROOT / ".bench_cache")
    vtab = build_aufbau_tables(index.strings)
    table = displaced_to_device(disp, dev)
    table.update({"vt_" + k: v for k, v in aufbau_tables_to_device(vtab, dev).items()})
    reads = cs.make_reads(genome, rng, nreads)
    work.mkdir(parents=True, exist_ok=True)
    reads_fa, sub_fa = work / "e2e_ab_reads.fa", work / "e2e_ab_compact.fa"
    cs.write_fasta(reads_fa, reads)
    cs.write_fasta(sub_fa, reads[:min(cs.COMPACT_READS, nreads)])
    return {"index": index, "table": table, "reads_fa": reads_fa, "sub_fa": sub_fa,
            "nreads": nreads, "nsub": min(cs.COMPACT_READS, nreads)}


def e2e_pipelines(dev, t: dict) -> dict:
    """The three passes' pipelines, built by the tree whose modules are in
    place: pass -> (pipeline, reads FASTA, reads)."""
    from utree_tpu_torch.pipeline import SearchPipeline

    kw = dict(device=dev, do_rc=True, batch_size=cs.BATCH, hist_cap=cs.HIST_CAP)
    bare = {k: v for k, v in t["table"].items() if not k.startswith("vt_")}
    out = {
        "displaced": (SearchPipeline(t["index"], lookup_mode="displaced", _table=t["table"],
                                     **kw), t["reads_fa"], t["nreads"]),
        "bsearch": (SearchPipeline(t["index"], lookup_mode="bsearch", **kw), t["reads_fa"],
                    t["nreads"]),
        "support 8": (SearchPipeline(t["index"], lookup_mode="displaced", _table=bare,
                                     support_ranges=8, **kw), t["sub_fa"], t["nsub"]),
    }
    for name, want in (("displaced", "vote"), ("bsearch", "vote"), ("support 8", "compact")):
        if out[name][0].layout != want:
            raise SystemExit(f"{name}: layout {out[name][0].layout}, not {want}")
    return out


def e2e_run(dev, trees: list[pathlib.Path], rounds: int, kmers: int, nreads: int,
        work: pathlib.Path) -> list[dict]:
    """--e2e: every tree's passes, `rounds` times in turn; one result a tree."""
    import torch

    mods = {tree: load_tree(tree) for tree in dict.fromkeys(trees)}
    with using(mods[trees[0]]):
        t = e2e_tier(dev, kmers, nreads, work)
    pipes = {}
    for tree in mods:
        with using(mods[tree]):
            pipes[tree] = e2e_pipelines(dev, t)
    res = [{"tree": str(tree), "passes": {p: {"reads_per_s": [], "phases": []}
                                          for p in E2E_PASSES}} for tree in trees]
    want = {}
    for r in range(rounds):
        for i, tree in enumerate(trees):
            with using(mods[tree]):
                from utree_tpu_torch.utils.trace import PhaseTimer

                for p in E2E_PASSES:
                    pipe, fa, n = pipes[tree][p]
                    pipe.tracer = PhaseTimer(quiet=True)
                    out = work / f"e2e_ab_{i}_{p.replace(' ', '')}.txt"
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got = pipe.search_file(str(fa), str(out))
                    dt = time.perf_counter() - t0
                    if got != n:
                        raise SystemExit(f"{tree} {p}: {got} of {n} reads")
                    data = out.read_bytes()
                    if want.setdefault(p, data) != data:
                        raise SystemExit(f"{tree} {p}: output differs from {trees[0]}'s")
                    res[i]["passes"][p]["reads_per_s"].append(n / dt)
                    res[i]["passes"][p]["phases"].append(dict(pipe.tracer.phases))
    for r in res:
        for p in r["passes"].values():
            rps = p["reads_per_s"]
            p["median"], p["best"] = statistics.median(rps), max(rps)
            keys = dict.fromkeys(k for ph in p["phases"] for k in ph)
            p["phase_median"] = {k: statistics.median(ph.get(k, 0.0) for ph in p["phases"])
                                 for k in keys}
            del p["phases"]
    return res


def e2e_compare(res: list[dict]) -> list[str]:
    """With two distinct trees (the first A, the other B, e.g. A B B A):
    each pass's pooled median and quartiles of either tree, and in how many
    pairs B was the faster, pairing A's and B's runs of a round in order."""
    trees = list(dict.fromkeys(r["tree"] for r in res))
    if len(trees) != 2:
        return []
    at = [[i for i, r in enumerate(res) if r["tree"] == t] for t in trees]
    lines = []
    for p in E2E_PASSES:
        rps = [r["passes"][p]["reads_per_s"] for r in res]
        pooled = [[x for i in ix for x in rps[i]] for ix in at]
        pairs = [(rps[a][k], rps[b][k]) for a, b in zip(*at) for k in range(len(rps[a]))]
        wins = sum(b > a for a, b in pairs)
        med = [statistics.median(v) for v in pooled]
        qs = [statistics.quantiles(v, n=4) for v in pooled]
        lines.append(f"{p}: " + "; ".join(
            f"{t} median {m:,.0f} (quartiles {q[0]:,.0f}-{q[2]:,.0f})"
            for t, m, q in zip(trees, med, qs))
            + f"; the second faster in {wins} of {len(pairs)} pairs, median "
            f"{100 * (med[1] / med[0] - 1):+.1f}%")
    return lines


def e2e_main(trees: list[str], rounds: int, out: str) -> int:
    """--e2e on the card: run, print and write the passes' rates."""
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    res = e2e_run(torch.device("cuda"), [pathlib.Path(t).resolve() for t in trees], rounds,
                  20_000_000, 262_144, ROOT / ".bench_cache")
    for r in res:
        r["card"] = card
        print(json.dumps(r), flush=True)
    for p in E2E_PASSES:
        print(f"{p}: median " + ", ".join(f"{r['passes'][p]['median']:,.0f}" for r in res)
              + " reads/s; best " + ", ".join(f"{r['passes'][p]['best']:,.0f}" for r in res)
              + "; phases (median s) " + " | ".join(
                  ", ".join(f"{k} {v:.4f}" for k, v in r["passes"][p]["phase_median"].items())
                  for r in res), flush=True)
    for line in e2e_compare(res):
        print(line, flush=True)
    pathlib.Path(out).parent.mkdir(exist_ok=True)
    pathlib.Path(out).write_text(json.dumps({"card": card, "runs": res}, indent=1))
    print(f"outputs byte-identical across {len(res)} trees x {rounds} rounds; on {card}",
          flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("trees", nargs="*", default=[str(ROOT)])
    ap.add_argument("--out", help="default .bench_cache/kernel_ab.json (--e2e: e2e_ab.json)")
    ap.add_argument("--only", default="", help="time only the calls this matches")
    ap.add_argument("--e2e", action="store_true", help="time the K3 and K8 search passes")
    ap.add_argument("--rounds", type=int, default=8, help="--e2e: rounds of passes")
    ap.add_argument("--worker", nargs=2, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.e2e:
        return e2e_main(a.trees, a.rounds, a.out or str(ROOT / ".bench_cache" / "e2e_ab.json"))
    a.out = a.out or str(ROOT / ".bench_cache" / "kernel_ab.json")
    if a.worker:
        print(json.dumps(_worker(pathlib.Path(a.worker[0]).resolve(),
                                 pathlib.Path(a.worker[1]), "cuda", a.only)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip()
    print(card, flush=True)
    cache = ROOT / ".bench_cache"
    cache.mkdir(exist_ok=True)
    inputs = cache / "kernel_ab_inputs.pt"
    note = _inputs(inputs, torch.device("cuda"), groups(a.only))
    runs, failed = [], []
    for tree in a.trees:
        p = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()),
                            "--worker", str(pathlib.Path(tree).resolve()), str(inputs),
                            "--only", a.only], capture_output=True, text=True)
        if p.returncode != 0:  # the other trees still run; the call fails
            print(f"kernel_ab: {tree} failed\n{p.stdout[-4000:]}\n{p.stderr[-8000:]}",
                  file=sys.stderr, flush=True)
            failed.append(tree)
            continue
        run = json.loads(p.stdout.strip().splitlines()[-1])
        run["card"] = card
        runs.append(run)
        print(json.dumps(run), flush=True)
    if not runs:
        return 1
    digests = {json.dumps({k: v["sha1"] for k, v in r["calls"].items()}) for r in runs}
    for r in runs:
        for k, v in r["ptxas"].items():
            print(f"ptxas {r['tree']}: {k}: {v}", flush=True)
    for name in runs[0]["calls"]:
        print(f"{name}: " + ", ".join(f"{r['calls'][name]['ms']:.4f}" for r in runs)
              + " ms; enqueue " + ", ".join(f"{r['calls'][name]['host_us']:.1f}" for r in runs)
              + " us, least round " + ", ".join(
                  f"{r['calls'][name].get('host_us_min', float('nan')):.1f}" for r in runs)
              + " us; device " + ", ".join(f"{r['calls'][name]['device_ms'] * 1e3:.2f}"
                                           for r in runs)
              + " us; profiler " + ", ".join(
                  f"{sum(v['mean_us'] for v in r['calls'][name]['split'].values()):.2f}"
                  for r in runs) + " us", flush=True)
        for i, r in enumerate(runs):
            parts = r["calls"][name]["split"]
            if len(parts) > 1:  # a split tree's kernels, or a call's memsets
                print(f"  run {i}: " + "; ".join(f"{k} {v['mean_us']:.2f} us x{v['count']}"
                                                 for k, v in parts.items()), flush=True)
    pathlib.Path(a.out).parent.mkdir(exist_ok=True)
    print(note, flush=True)  # again, beside the times
    pathlib.Path(a.out).write_text(json.dumps({"card": card, "inputs": note, "runs": runs},
                                              indent=1))
    if len(digests) != 1:
        print("kernel_ab: the trees' outputs differ", file=sys.stderr)
        return 1
    if failed:
        return 1
    print(f"outputs byte-identical across {len(runs)} runs; on {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
