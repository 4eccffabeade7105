"""The CUDA kernels against their plain PyTorch versions, on a GPU.

Every test here is marked `cuda` and skips without a CUDA device: a CUDA
kernel has no CPU mode.  The plain versions are held to the JAX package by
tests/test_torch_{lookup,aufbau,pipeline}.py on the CPU.  This file imports
no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from bench import make_tier_index
from test_classify_device import _random_strings
from utree_tpu.classify_device import build_aufbau_tables
from utree_tpu.hash_index import build_displaced_index
from utree_tpu_torch import kernels
from utree_tpu_torch import lookup as tl
from utree_tpu_torch.classify_device import (aufbau_tables_to_device,
                                             aufbau_walk, pack_vote, vote_rows)
from utree_tpu_torch.hash_index import displaced_to_device

pytestmark = pytest.mark.cuda
BAD = 65535


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tier(dev):
    index, sw, ixs, labels, genome, cfg, rng = make_tier_index(40_000, 64)
    disp = build_displaced_index(index, load=0.98, spill_budget=len(sw))
    assert disp.t3.shape[0] > 8  # the d3 tail is exercised too
    return dict(index=index, genome=genome, table=displaced_to_device(disp, dev))


def _packed_reads(genome, n, seed, dev, read_len=150, width=192):
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    starts = rng.integers(0, len(genome) - read_len, n)
    reads = np.zeros((n, width), np.uint8)
    reads[:, :read_len] = genome[starts[:, None] + np.arange(read_len)]
    reads[rng.random(reads.shape) < 0.01] = ord("N")
    rand = rng.random(n) < 0.1
    reads[rand, :read_len] = rng.choice(acgt, (int(rand.sum()), read_len))
    lens = np.full(n, read_len, np.int32)
    lens[::3] = rng.integers(20, read_len, len(lens[::3]))
    reads[np.arange(width)[None, :] >= lens[:, None]] = 0
    return [torch.from_numpy(a).to(dev) for a in tl.pack_reads_host(reads, lens)]


def test_k1_scan_probe_and_k2_histogram_match_plain(tier, dev):
    packed, vbits, lens = _packed_reads(tier["genome"], 3000, 1, dev)
    for do_rc in (True, False):
        for true_len in (152, None):
            kw = dict(do_rc=do_rc, bad_ix=BAD, true_len=true_len)
            n0 = kernels.launches["scan_probe"]
            ids = tl.window_ids(tier["table"], packed, vbits, lens, **kw)
            assert kernels.launches["scan_probe"] == n0 + 1
            want = tl.window_ids_plain(tier["table"], packed, vbits, lens, **kw)
            assert torch.equal(ids, want)
            for cap in (1, 8, 30):
                got = tl.histogram(ids, 64, cap)
                want = tl.compact_histogram(ids, 64, cap)
                assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_k2_histogram_long_rows(dev):
    """Rows wider than the register path (32*64 ids) stream from memory."""
    rng = np.random.default_rng(2)
    for n in (7, 300, 2048, 3000):
        ids = torch.from_numpy(rng.integers(0, 40, (257, n)).astype(np.int32)).to(dev)
        ids[ids > 30] = BAD
        for cap in (1, 8, 30):
            got = tl.histogram(ids, 30, cap)
            want = tl.compact_histogram(ids, 30, cap)
            assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("seed,cap", [(0, 8), (5, 12), (7, 30), (3, 1)])
def test_k3_aufbau_vote_matches_plain(dev, seed, cap):
    rng = np.random.default_rng(seed)
    strings = _random_strings(rng, int(rng.integers(8, 80)))
    tab = build_aufbau_tables(strings)
    n = 2000
    labels = np.full((n, cap), -1, np.int32)
    counts = np.zeros((n, cap), np.int32)
    nuniq = rng.integers(0, cap + 2, n).astype(np.int32)
    for b in range(n):
        k = min(int(nuniq[b]), cap, len(strings))
        labels[b, :k] = np.sort(rng.choice(len(strings), k, replace=False))
        counts[b, :k] = rng.integers(1, 12, k)
    found = counts.sum(1).astype(np.int32)
    arrays = [torch.from_numpy(a).to(dev) for a in (labels, counts, nuniq, found)]
    dtab = aufbau_tables_to_device(tab, dev)
    for max_iters in ((tab.max_len + 4) * (cap + 2) + 16, 2):
        kw = dict(taxacut=4, max_iters=max_iters)
        want = pack_vote(*aufbau_walk(dtab, *arrays, **kw), arrays[2], arrays[3])
        assert torch.equal(vote_rows(dtab, *arrays, **kw), want)


def test_cuda_pipeline_equals_cpu_pipeline(tmp_path, dev):
    """The whole search through the kernels equals the plain versions' run,
    and every kernel of the path was launched."""
    from utree_tpu.build import build_database
    from utree_tpu.config import UTreeConfig
    from utree_tpu.index import DeviceIndexArrays
    from utree_tpu.testdata import make_toy_db, make_toy_reads
    from utree_tpu_torch.pipeline import SearchPipeline

    recs = make_toy_db(str(tmp_path / "refs.fa"), str(tmp_path / "tax.map"), seed=23)
    make_toy_reads(str(tmp_path / "reads.fa"), recs, num_reads=900, seed=29)
    cfg = UTreeConfig()
    res = build_database(str(tmp_path / "refs.fa"), str(tmp_path / "tax.map"), cfg)
    index = DeviceIndexArrays.from_build(res.words, res.ixs, res.labels.strings, cfg)
    outs = {}
    for device in ("cpu", "cuda"):
        kernels.reset_launches()
        pipe = SearchPipeline(index, device=device, do_rc=True, batch_size=128,
                              hist_cap=2)
        pipe.search_file(str(tmp_path / "reads.fa"), str(tmp_path / f"{device}.txt"))
        outs[device] = (tmp_path / f"{device}.txt").read_bytes()
        launched = all(kernels.launches[k] > 0 for k in kernels.KERNELS)
        assert launched == (device == "cuda")
    assert outs["cuda"] == outs["cpu"] and outs["cpu"].count(b"\n") > 500
