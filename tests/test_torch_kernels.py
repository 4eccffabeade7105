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
from chip_smoke import u32_index
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
            kw = dict(do_rc=do_rc, bad_ix=BAD, true_len=true_len, num_labels=64)
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


def _ladder(index, geometry):
    from utree_tpu.hash_index import (_canonical_groups, _place_canonical,
                                      build_canonical_hash_index)

    if geometry == "chain":  # tier B's three-level shape, c3 in use
        built = _place_canonical(*_canonical_groups(index), 4, 4.0, 2, 1 << 27,
                                 slots3=16)
        assert built.t2.shape[0] > 8 and built.t3.shape[0] > 8
        return built
    return build_canonical_hash_index(index)


def _wide_index(index, sw, ixs):
    strings = list(index.strings) + [b"pad%d" % i for i in range(70_000)]
    return u32_index(sw, ixs, strings)


def _probe_and_hists(table, packed, vbits, lens, num_labels, probe):
    """Every probe variant and histogram layout against its plain version."""
    bad = 0x7FFFFFFF if num_labels >= 0xFFFF else BAD
    for do_rc in (True, False):
        for true_len in (152, None):
            kw = dict(do_rc=do_rc, bad_ix=bad, true_len=true_len, num_labels=num_labels)
            n0 = kernels.launches[probe]
            ids = tl.window_ids(table, packed, vbits, lens, **kw)
            assert kernels.launches[probe] == n0 + 1
            assert torch.equal(ids, tl.window_ids_plain(table, packed, vbits, lens, **kw))
            assert int((ids < num_labels).sum()) > 1000
            for cap in (1, 8, 30):
                assert torch.equal(tl.histogram_packed(ids, num_labels, cap),
                                   tl.pack_hist(ids, num_labels, cap))
                assert torch.equal(tl.histogram_unpacked(ids, num_labels, cap),
                                   tl.unpacked_hist(ids, num_labels, cap))


@pytest.mark.parametrize("geometry", ["default", "chain"])
def test_k4_ladder_probe_matches_plain(tier, dev, geometry):
    from utree_tpu_torch.hash_index import canonical_to_device

    table = canonical_to_device(_ladder(tier["index"], geometry), dev)
    packed, vbits, lens = _packed_reads(tier["genome"], 3000, 3, dev)
    _probe_and_hists(table, packed, vbits, lens, 64, "ladder_probe")


@pytest.mark.parametrize("kind", ["ladder", "displaced"])
def test_wide_probes_match_plain(dev, kind):
    from utree_tpu_torch.hash_index import canonical_to_device

    index, sw, ixs, labels, genome, cfg, rng = make_tier_index(40_000, 64)
    wide = _wide_index(index, sw, ixs)
    if kind == "ladder":
        table, probe = canonical_to_device(_ladder(wide, "default"), dev), "ladder_probe_wide"
    else:
        disp = build_displaced_index(wide, load=0.98, spill_budget=len(sw))
        assert disp.wide and disp.t3.shape[0] > 8
        table, probe = displaced_to_device(disp, dev), "scan_probe_wide"
    packed, vbits, lens = _packed_reads(genome, 3000, 4, dev)
    _probe_and_hists(table, packed, vbits, lens, wide.num_labels, probe)


def test_k2_layouts_at_long_read_widths(tier, dev):
    """Long-read chunks: 16,384 windows a row, so 2 x 16,384 ids with RC,
    far past the register path: every layout takes the streamed branch."""
    from utree_tpu_torch.hash_index import canonical_to_device

    table = canonical_to_device(_ladder(tier["index"], "default"), dev)
    genome = tier["genome"]
    width = 16_384 + 32
    rng = np.random.default_rng(5)
    reads = np.zeros((16, width), np.uint8)
    lens = rng.integers(width // 2, width - 1, 16).astype(np.int32)
    for r in range(16):
        s = int(rng.integers(0, len(genome) - width))
        reads[r] = genome[s:s + width]
    reads[np.arange(width)[None, :] >= lens[:, None]] = 0
    packed, vbits, lens = (torch.from_numpy(a).to(dev) for a in tl.pack_reads_host(reads, lens))
    ids = tl.window_ids(table, packed, vbits, lens, do_rc=True, bad_ix=BAD, num_labels=64)
    assert ids.shape[1] == 2 * (width - 31) > 32 * 64
    for cap in (1, 8, 30):
        assert torch.equal(tl.histogram_packed(ids, 64, cap), tl.pack_hist(ids, 64, cap))
        assert torch.equal(tl.histogram_unpacked(ids, 64, cap),
                           tl.unpacked_hist(ids, 64, cap))
        assert all(torch.equal(a, b) for a, b in zip(tl.histogram(ids, 64, cap),
                                                      tl.compact_histogram(ids, 64, cap)))


# entry points each path must launch (the histogram step of long reads adds
# histogram_packed or histogram_unpacked)
_PATHS = {
    ("narrow", "auto"): {"ladder_probe", "histogram", "aufbau_vote", "histogram_packed"},
    ("narrow", "displaced"): {"scan_probe", "histogram", "aufbau_vote", "histogram_packed"},
    ("wide", "auto"): {"ladder_probe_wide", "histogram_unpacked"},
    ("wide", "displaced"): {"scan_probe_wide", "histogram_unpacked"},
}


@pytest.mark.parametrize("labels,mode", list(_PATHS), ids=lambda x: str(x))
def test_cuda_pipeline_equals_cpu_pipeline(tmp_path, dev, labels, mode):
    """The whole search through the kernels equals the plain versions' run,
    long reads included, and every kernel of the path was launched."""
    from utree_tpu.build import build_database
    from utree_tpu.config import UTreeConfig
    from utree_tpu.index import DeviceIndexArrays
    from utree_tpu.testdata import make_toy_db, make_toy_reads
    from utree_tpu_torch.pipeline import SearchPipeline

    recs = make_toy_db(str(tmp_path / "refs.fa"), str(tmp_path / "tax.map"), seed=23)
    make_toy_reads(str(tmp_path / "reads.fa"), recs, num_reads=900, seed=29)
    with open(tmp_path / "reads.fa", "ab") as f:
        for i in range(3):
            f.write(b">long%d\n" % i + recs[i][2][: 1500 + 700 * i] + b"\n")
    res = build_database(str(tmp_path / "refs.fa"), str(tmp_path / "tax.map"), UTreeConfig())
    strings = list(res.labels.strings)
    if labels == "wide":
        index = u32_index(res.words, res.ixs, strings + [b"pad%d" % i for i in range(70_000)])
    else:
        index = DeviceIndexArrays.from_build(res.words, res.ixs, strings, UTreeConfig())
    outs = {}
    for device in ("cpu", "cuda"):
        kernels.reset_launches()
        pipe = SearchPipeline(index, device=device, do_rc=True, batch_size=128,
                              hist_cap=2, lookup_mode=mode)
        pipe.long_read_threshold, pipe.long_chunk = 1000, 256
        pipe.search_file(str(tmp_path / "reads.fa"), str(tmp_path / f"{device}.txt"))
        outs[device] = (tmp_path / f"{device}.txt").read_bytes()
        launched = {k for k, n in kernels.launches.items() if n}
        assert launched == (_PATHS[labels, mode] if device == "cuda" else set())
    assert outs["cuda"] == outs["cpu"] and outs["cpu"].count(b"\n") > 500
