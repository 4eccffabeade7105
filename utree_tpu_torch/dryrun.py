"""The dry-run entry points of the port: the counterpart of `__graft_entry__.py`.

  entry(device)             -> (fn, example_args): the single-device search
                               step (`lookup.search_step`, ASCII reads ->
                               per-window label ids; K14 then K7 on a card)
                               on a synthetic bsearch index.
  dryrun_multichip(n, ...)  -> one pass of each multi-device mode on n
                               devices laid out (n/T, T), T = 2 for even n:
                               the prefix-sharded step, the replicated step
                               on the bsearch and the canonical tables, the
                               sequence-parallel long-read histogram, the
                               routed canonical-table step and its fallback,
                               the routed displaced step and its fallback,
                               and `SearchPipeline(devices=n)` against one
                               device.

Each block is held to the single-device step or to its fallback and raises
AssertionError where they differ; the routed displaced rows must equal the
routed canonical rows, as `__graft_entry__.py` (:177) asserts.
"""

from __future__ import annotations

import functools
import pathlib
import tempfile

import numpy as np
import torch

from utree_tpu_torch.config import UTreeConfig
from utree_tpu_torch.index import DeviceIndexArrays


def _toy_index(num_labels: int = 8, num_kmers: int = 4096, seed: int = 0):
    """A small synthetic CTR index (sorted words + labels)."""
    rng = np.random.default_rng(seed)
    cfg = UTreeConfig()
    words = np.unique(rng.integers(0, 1 << 63, size=num_kmers, dtype=np.uint64))
    ixs = rng.integers(0, num_labels, size=len(words)).astype(np.int64)
    labels = [b"k__a;p__%d" % i for i in range(num_labels)]
    return DeviceIndexArrays.from_build(words, ixs, labels, cfg), cfg


def _toy_reads(batch: int, length: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    reads = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(batch, length))
    lens = np.full(batch, length, np.int32)
    return reads.astype(np.uint8), lens


def entry(device="cuda"):
    """(fn, example_args): fn(*example_args) is the single-device step."""
    from utree_tpu_torch.hash_index import bsearch_to_device
    from utree_tpu_torch.lookup import search_step

    index, cfg = _toy_index()
    reads, lens = _toy_reads(batch=64, length=128)
    fn = functools.partial(search_step, k=cfg.packsize, do_rc=True,
                           probe_iters=index.probe_iters, bad_ix=cfg.bad_ix,
                           num_labels=index.num_labels)
    return fn, (bsearch_to_device(index, device), torch.from_numpy(reads).to(device),
                torch.from_numpy(lens).to(device))


def _same(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    if a.shape != b.shape or not torch.equal(a, b.to(a.device)):
        raise AssertionError(f"dryrun: {what} differs from the single-device step")


def dryrun_multichip(n_devices: int, device="cuda", shard_devices=None) -> None:
    """Run every multi-device mode once on `n_devices` devices: cuda:0..n-1
    (fewer cards raise), n entries of the CPU for device="cpu", or the given
    `shard_devices` (several may be one card)."""
    from utree_tpu_torch.hash_index import (bsearch_to_device, build_canonical_hash_index,
                                            canonical_to_device)
    from utree_tpu_torch.lookup import pack_reads_host, search_step
    from utree_tpu_torch.parallel import (ShardedCanonicalIndex, ShardedDisplacedIndex,
                                          ShardedIndex, long_read_histogram, make_mesh,
                                          replicated_search_step,
                                          routed_canonical_search_step,
                                          routed_displaced_fallback_step,
                                          routed_displaced_search_step,
                                          routed_fallback_step, sharded_search_step,
                                          split_long_read)
    from utree_tpu_torch.pipeline import SearchPipeline

    n = n_devices
    if shard_devices is not None:
        if len(shard_devices) != n:
            raise ValueError(f"{len(shard_devices)} shard devices for {n} devices")
        devs = [torch.device(d) for d in shard_devices]
    elif torch.device(device).type == "cuda":
        present = torch.cuda.device_count()
        if present < n:
            raise ValueError(f"dryrun_multichip({n}) needs {n} cards, {present} present")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = [torch.device(device)] * n
    home = devs[0]
    index, cfg = _toy_index()
    table_axis = 2 if n % 2 == 0 else 1
    mesh = make_mesh(data=n // table_axis, table=table_axis, devices=devs)
    kw = dict(k=cfg.packsize, probe_iters=index.probe_iters, bad_ix=cfg.bad_ix,
              num_labels=index.num_labels)

    # DP x TP: prefix-sharded table, rows over `data`, sum over `table`
    sharded = ShardedIndex.from_index(index, num_shards=table_axis)
    reads, lens = _toy_reads(batch=mesh.shape[0] * 8, length=96)
    r, ln = torch.from_numpy(reads), torch.from_numpy(lens)
    repl = bsearch_to_device(index, home)
    out = sharded_search_step(mesh, sharded, do_rc=True)(sharded.to_devices(mesh), r, ln)
    _same(out, search_step(repl, r.to(home), ln.to(home), do_rc=True, **kw),
          "the prefix-sharded step")

    # pure DP, the records replicated
    tables = mesh.replicate(repl)
    out2 = replicated_search_step(mesh, index, do_rc=False)(tables, r, ln)
    _same(out2, search_step(repl, r.to(home), ln.to(home), do_rc=False, **kw),
          "the replicated step (bsearch)")

    # pure DP with the canonical fast-path table
    canon_arrays = build_canonical_hash_index(index)
    canon = canonical_to_device(canon_arrays, home)
    out2c = replicated_search_step(mesh, index, do_rc=False)(mesh.replicate(canon), r, ln)
    _same(out2c, search_step(canon, r.to(home), ln.to(home), do_rc=False, **kw),
          "the replicated step (canonical)")

    # SP: one long read, positions over the whole mesh
    rng = np.random.default_rng(3)
    long_read = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=4096).tobytes()
    chunks, clens = split_long_read(long_read, n, cfg.packsize)
    hist = long_read_histogram(mesh, index, num_labels=index.num_labels, do_rc=True)(
        tables, torch.from_numpy(chunks), torch.from_numpy(clens))
    if hist.shape != (index.num_labels,):
        raise AssertionError(f"dryrun: long-read histogram of shape {tuple(hist.shape)}")

    # routed canonical hash over the whole mesh, and its fallback
    rsharded = ShardedCanonicalIndex.from_canonical(canon_arrays, table_axis)
    rtables = rsharded.to_devices(mesh)
    packed = [torch.from_numpy(a) for a in pack_reads_host(reads, lens)]
    rk = dict(do_rc=True, num_labels=index.num_labels, cap=8, bad_ix=cfg.bad_ix)
    rout = torch.cat([o.to(home) for o in routed_canonical_search_step(
        mesh, rsharded, **rk)(rtables, *packed)])
    if rout.shape != (reads.shape[0], 10):
        raise AssertionError(f"dryrun: routed canonical rows of shape {tuple(rout.shape)}")
    fout = torch.cat([o.to(home) for o in routed_fallback_step(
        mesh, rsharded, **rk)(rtables, *packed)])
    _same(rout[:, :-1], fout, "the routed canonical step's fallback")

    # routed displaced shards over the whole mesh, and their fallback
    dsharded = ShardedDisplacedIndex.build(index, table_axis)
    dtables = dsharded.to_devices(mesh)
    dout = torch.cat([o.to(home) for o in routed_displaced_search_step(
        mesh, dsharded, **rk)(dtables, *packed)])
    if dout.shape != (reads.shape[0], 10):
        raise AssertionError(f"dryrun: routed rows of shape {tuple(dout.shape)}")
    dfout = torch.cat([o.to(home) for o in routed_displaced_fallback_step(
        mesh, dsharded, **rk)(dtables, *packed)])
    _same(dout[:, :-1], dfout, "the routed step's fallback")
    _same(dout[:, :-1], rout[:, :-1], "the routed displaced step (canonical rows)")

    # the product pipeline over the devices against one device, through
    # search_file on a FASTA of the same reads
    seqs, slens = _toy_reads(n * 8, 96, 5)
    with tempfile.TemporaryDirectory() as tmp:
        fa = pathlib.Path(tmp) / "reads.fa"
        fa.write_bytes(b"".join(b">q%d\n" % i + bytes(s[:int(m)]) + b"\n"
                                for i, (s, m) in enumerate(zip(seqs, slens))))
        pipe = SearchPipeline(index, device=home, do_rc=True, batch_size=n * 8,
                              devices=n, _shard_devices=devs)
        one = SearchPipeline(index, device=home, do_rc=True, batch_size=len(seqs))
        outs = []
        for p, name in ((pipe, "mesh.txt"), (one, "one.txt")):
            p.search_file(str(fa), str(pathlib.Path(tmp) / name))
            outs.append((pathlib.Path(tmp) / name).read_bytes())
    if outs[0] != outs[1]:
        raise AssertionError(f"dryrun: SearchPipeline(devices={n}) differs from one device")
    if pipe.layout == "vote" and one.layout != "vote":
        raise AssertionError("dryrun: the one-device pipeline lost the device vote")
