"""The legacy two-table hash (`--lookup-mode hash`) of the port against the
JAX package, on the CPU: the placement (`hash_index.build_hash_index`), the
plain version of kernel K10 (`lookup.lookup_kmers_hash`, held to JAX's
`lookup_kmers_hash` and to the bsearch replay `lookup_kmers`), and
classifications.txt through `SearchPipeline(lookup_mode="hash")` and the
CLI in every readback layout.  Tolerance 0: every output is an integer or
a byte.  Databases come from make_toy_db -> build_database ->
DeviceIndexArrays.from_build (or random words, as tests/test_hash_index.py
makes them); the port gets its copy through convert.index_from_jax."""

import numpy as np
import pytest
import torch

from utree_tpu.build import build_database
from utree_tpu.config import UTreeConfig
from utree_tpu.formats import write_ctr_from_ubt, write_ubt
from utree_tpu.hash_index import build_hash_index as j_build_hash_index
from utree_tpu.index import DeviceIndexArrays
from utree_tpu.lookup import lookup_kmers as j_lookup_kmers
from utree_tpu.lookup import lookup_kmers_hash as j_lookup_kmers_hash
from utree_tpu.pipeline import SearchPipeline as JaxPipeline
from utree_tpu.testdata import make_toy_db, make_toy_reads
from utree_tpu_torch import hash_index as th
from utree_tpu_torch import lookup as tl
from utree_tpu_torch.convert import index_from_jax, tables_from_jax
from utree_tpu_torch.pipeline import SearchPipeline

BATCH = 128


def _random_case():
    rng = np.random.default_rng(0)
    words = np.unique(rng.integers(0, 1 << 63, size=50_000, dtype=np.uint64))
    q = np.concatenate([rng.choice(words, 2000),
                        rng.integers(0, 1 << 63, size=2000, dtype=np.uint64)])
    return words, rng.integers(0, 900, size=len(words)), 900, UTreeConfig(), q


def _singleton_first_bin():
    """The first populated bin holds one record: the compressor's quirk
    makes it unreachable and lets the next bin's range swallow it."""
    rng = np.random.default_rng(1)
    w0 = np.uint64(5) << np.uint64(40) | np.uint64(1234)
    rest = (np.uint64(9) << np.uint64(40)) | rng.integers(0, 1 << 40, 50, dtype=np.uint64)
    more = (np.uint64(700) << np.uint64(40)) | rng.integers(0, 1 << 40, 50, dtype=np.uint64)
    words = np.unique(np.concatenate([[w0], rest, more]))
    cross = np.uint64(9) << np.uint64(40) | np.uint64(1234)
    q = np.concatenate([[w0, cross], words,
                        rng.integers(0, 1 << 63, size=500, dtype=np.uint64)])
    return words, np.arange(len(words)) % 7, 7, UTreeConfig(), q


def _contaminated_bin0():
    """Bin 0 populated: its start stays quirky and early bins merge."""
    rng = np.random.default_rng(2)
    parts = [(np.uint64(p) << np.uint64(40))
             | np.sort(rng.integers(0, 1 << 40, size=20, dtype=np.uint64)) for p in (0, 1, 9)]
    words = np.unique(np.concatenate(parts))
    q = np.concatenate([words, rng.integers(0, 1 << 42, size=1000, dtype=np.uint64)])
    return words, np.arange(len(words)) % 5, 5, UTreeConfig(), q


def _u32_case():
    """IXTYPE=u32 (70,000 labels): ids past 2^16, the sentinel record -1."""
    rng = np.random.default_rng(21)
    words = np.unique(rng.integers(0, 1 << 64, size=30_000, dtype=np.uint64))
    q = np.concatenate([rng.choice(words, 3000),
                        rng.integers(0, 1 << 64, size=1000, dtype=np.uint64)])
    return (words, rng.integers(0, 70_000, size=len(words)), 70_000,
            UTreeConfig(ixtype_bytes=4), q)


CASES = {"random": _random_case, "singleton-first-bin": _singleton_first_bin,
         "contaminated-bin0": _contaminated_bin0, "u32": _u32_case}


@pytest.fixture(scope="module")
def built():
    """Each case's JAX index, both packages' hash tables and its queries."""
    out = {}
    for name, make in CASES.items():
        words, ixs, nlab, cfg, q = make()
        index = DeviceIndexArrays.from_build(words, np.asarray(ixs, np.int64),
                                             [b"l%d" % i for i in range(nlab)], cfg)
        out[name] = dict(index=index, cfg=cfg, q=q, jax=j_build_hash_index(index),
                         port=th.build_hash_index(index_from_jax(index)))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_build_hash_index_equals_jax(built, case):
    """t1 and t2 element for element, the slot count and the entry count."""
    j, t = built[case]["jax"], built[case]["port"]
    assert np.array_equal(t.t1, j.t1) and np.array_equal(t.t2, j.t2)
    assert t.t1.dtype == t.t2.dtype == np.int32 and t.t1.shape[1] == 24
    assert (t.slots, t.num_entries) == (j.slots, j.num_entries)
    dev = th.hash_to_device(t, "cpu")
    assert sorted(dev) == ["t1", "t2"]
    assert torch.equal(dev["t1"], torch.from_numpy(j.t1))


def _lanes(words):
    return ((words >> np.uint64(40)).astype(np.int32),
            ((words >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int32),
            (words & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def _port_lookup(tables, lanes, valid, bad_ix):
    qpre, qhi, qlo = (torch.from_numpy(a.astype(np.int64)) for a in lanes)
    return tl.lookup_kmers_hash(tables, qpre, qhi, qlo, torch.from_numpy(valid),
                                slots=8, bad_ix=bad_ix).numpy()


@pytest.mark.parametrize("bad", ["cfg", "int32-max"])
@pytest.mark.parametrize("case", list(CASES))
def test_lookup_kmers_hash_equals_jax(built, case, bad):
    """The plain K10 against JAX's lookup_kmers_hash and the replay, with a
    fifth of the windows invalid; bad_ix as the config has it (JAX's
    tests/test_hash_index.py) and as the pipeline passes it.  JAX cannot take
    the IXTYPE=u32 config's 2^32-1 (its int32 lanes overflow): that case
    checks the port alone, where it wraps to -1."""
    b = built[case]
    index, cfg = b["index"], b["cfg"]
    bad_ix = cfg.bad_ix if bad == "cfg" else 0x7FFFFFFF
    lanes = _lanes(b["q"])
    valid = np.random.default_rng(3).random(len(b["q"])) >= 0.2
    got = _port_lookup(th.hash_to_device(b["port"], "cpu"), lanes, valid, bad_ix)
    if bad_ix > 0x7FFFFFFF:
        want = _port_lookup(th.hash_to_device(b["port"], "cpu"), lanes, valid,
                            0x7FFFFFFF)
        assert np.array_equal(got, np.where(want == 0x7FFFFFFF, -1, want))
        return
    want = np.asarray(j_lookup_kmers_hash(b["jax"].device_put(), *lanes, valid,
                                          slots=8, bad_ix=bad_ix))
    ref = np.asarray(j_lookup_kmers(index.device_put(), *lanes, valid,
                                    index.probe_iters, bad_ix))
    assert got.dtype == np.int32
    assert np.array_equal(got, want) and np.array_equal(got, ref)
    assert (got[~valid] == bad_ix).all()
    if case != "singleton-first-bin":
        assert (got[valid] != bad_ix).sum() >= len(CASES[case]()[0]) // 100


def test_negative_ix_slots_never_match(built):
    """A slot whose ix is negative matches no word, and a row holding one
    is still read to its end: the random case's tables with every third
    entry's ix set to -1 (as an IXTYPE=u32 bad_ix is stored), the plain K10
    against JAX's on the same tables."""
    b = built["random"]
    t1, t2 = b["port"].t1.copy(), b["port"].t2.copy()
    for t in (t1, t2):
        flat = t.reshape(-1)  # a view: the tables are contiguous
        live = np.flatnonzero(flat[2::3] >= 0)
        flat[2 + 3 * live[::3]] = -1
    lanes = _lanes(b["q"])
    valid = np.ones(len(b["q"]), bool)
    tables = {"t1": torch.from_numpy(t1), "t2": torch.from_numpy(t2)}
    got = _port_lookup(tables, lanes, valid, 0xFFFF)
    want = np.asarray(j_lookup_kmers_hash({"t1": t1, "t2": t2}, *lanes, valid,
                                          slots=8, bad_ix=0xFFFF))
    assert np.array_equal(got, want)
    full = _port_lookup(th.hash_to_device(b["port"], "cpu"), lanes, valid, 0xFFFF)
    lost = (full != 0xFFFF) & (got == 0xFFFF)
    assert lost.sum() > 100 and (got[~lost] == full[~lost]).all()


# ---- the pipeline ----------------------------------------------------------------

@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A toy DB, short reads with chimeras (3 labels a read: hist_cap=2
    overflows) and a file of short and long reads."""
    wd = tmp_path_factory.mktemp("hash")
    recs = make_toy_db(str(wd / "refs.fa"), str(wd / "tax.map"), seed=83, num_refs=12)
    make_toy_reads(str(wd / "short.fa"), recs, num_reads=400, seed=89)
    rng = np.random.default_rng(97)

    def chimera(n_parts, part_len):
        parts = []
        for r in rng.choice(len(recs), n_parts):
            s = int(rng.integers(0, len(recs[r][2]) - part_len))
            parts.append(recs[r][2][s:s + part_len])
        return b"".join(parts)

    with open(wd / "short.fa", "ab") as f:
        for i in range(40):
            f.write(b">chimera%d\n" % i + chimera(3, 50) + b"\n")
    shorts = (wd / "short.fa").read_bytes().split(b">")[1:]
    with open(wd / "long.fa", "wb") as f:
        for i, rec in enumerate(shorts[:90]):
            f.write(b">" + rec)
            if i % 30 == 7:
                f.write(b">long%d\n" % i + chimera(12, 120) + b"\n")
    cfg = UTreeConfig()
    res = build_database(str(wd / "refs.fa"), str(wd / "tax.map"), cfg)
    write_ubt(str(wd / "db.ubt"), res.words, res.ixs, res.labels.strings, cfg)
    write_ctr_from_ubt(str(wd / "db.ubt"), str(wd / "db.ctr"), cfg)
    return {"dir": wd, "res": res, "ctr": str(wd / "db.ctr")}


def _index(env, wide: bool):
    """The toy labels, or padded past 70,000 labels (IXTYPE=u32)."""
    res = env["res"]
    strings = list(res.labels.strings)
    cfg = UTreeConfig()
    if wide:
        strings += [b"pad%d" % i for i in range(70_000 - len(strings))]
        cfg = UTreeConfig(ixtype_bytes=4)
    return DeviceIndexArrays.from_build(res.words, res.ixs, strings, cfg)


# layout -> (wide labels, keywords for both pipelines)
_LAYOUTS = {
    "vote": (False, {}),
    "compact": (False, dict(device_vote=False)),
    "packed": (False, dict(device_vote=False, compact_readback=False)),
    "unpacked": (True, {}),
}
_CASES = [("vote", True, "short.fa", 8), ("vote", False, "short.fa", 8),
          ("vote", True, "short.fa", 2), ("compact", True, "short.fa", 8),
          ("compact", False, "short.fa", 2), ("packed", True, "short.fa", 2),
          ("packed", False, "short.fa", 8), ("unpacked", True, "short.fa", 2),
          ("unpacked", False, "short.fa", 8), ("vote", True, "long.fa", 2),
          ("unpacked", True, "long.fa", 2)]


@pytest.mark.parametrize("layout,do_rc,reads,hist_cap", _CASES,
                         ids=lambda x: str(x))
def test_hash_pipeline_equals_jax(env, tmp_path, layout, do_rc, reads, hist_cap):
    """SearchPipeline(lookup_mode="hash") builds the JAX pipeline's t1/t2
    itself and writes its bytes in each readback layout, with and without
    RC; hist_cap=2 replays reads of 3+ labels on the host, and long reads
    (over a 400 bp threshold, 128-window chunks) take the histogram step."""
    wide, kw = _LAYOUTS[layout]
    index = _index(env, wide)
    jp = JaxPipeline(index, do_rc=do_rc, batch_size=BATCH, hist_cap=hist_cap,
                     lookup_mode="hash", **kw)
    pipe = SearchPipeline(index_from_jax(index), device="cpu", do_rc=do_rc,
                          batch_size=BATCH, hist_cap=hist_cap, lookup_mode="hash", **kw)
    assert jp.table_kind == pipe.table_kind == "hash" and pipe.layout == layout
    want_tab = tables_from_jax(jp._table)
    assert sorted(pipe._tables[0]) == sorted(want_tab)
    assert all(torch.equal(pipe._tables[0][k], want_tab[k]) for k in want_tab)
    if reads == "long.fa":
        for p in (jp, pipe):
            p.long_read_threshold, p.long_chunk = 400, 128
    outs = []
    for p in (jp, pipe):
        out = tmp_path / f"{type(p).__module__}.txt"
        p.search_file(str(env["dir"] / reads), str(out))
        outs.append(out.read_bytes())
    assert outs[1] == outs[0]
    assert outs[0].count(b"\n") > (60 if reads == "long.fa" else 200)
    if reads == "long.fa":
        assert sum(ln.startswith(b"long") for ln in outs[0].splitlines()) == 3


def test_cli_lookup_mode_hash(env, tmp_path, capsys):
    """`search --lookup-mode hash` on the .ctr of the DB: the JAX pipeline's
    bytes on the same index."""
    from utree_tpu_torch.cli import main

    out = tmp_path / "cli.txt"
    main(["search", env["ctr"], str(env["dir"] / "short.fa"), str(out), "--rc",
          "--device", "cpu", "--batch", str(BATCH), "--lookup-mode", "hash", "--trace"])
    assert "table_kind: hash, layout: vote" in capsys.readouterr().out
    jp = JaxPipeline(DeviceIndexArrays.from_ctr(env["ctr"], UTreeConfig()), do_rc=True,
                     batch_size=BATCH, lookup_mode="hash")
    jp.search_file(str(env["dir"] / "short.fa"), str(tmp_path / "jax.txt"))
    assert out.read_bytes() == (tmp_path / "jax.txt").read_bytes()


def test_hash_at_packsize_64_raises(env):
    """`hash` is PACKSIZE=32 only: both pipelines raise the same ValueError."""
    import dataclasses

    k64 = dataclasses.replace(_index(env, False), config=UTreeConfig(packsize=64))
    for make in (lambda: JaxPipeline(k64, lookup_mode="hash"),
                 lambda: SearchPipeline(index_from_jax(k64), device="cpu",
                                        lookup_mode="hash")):
        with pytest.raises(ValueError, match="'hash' is unsupported for PACKSIZE=64"):
            make()


def test_window_ids_on_cpu_takes_the_plain_version():
    """On CPU tensors the wrapper is window_ids_plain and launches nothing:
    empty tables (every slot ix -1) give bad_ix in [fwd | rc] rows of 2W."""
    from utree_tpu_torch import kernels

    packed = torch.zeros((2, 16), dtype=torch.uint8)
    vbits = torch.full((2, 8), 255, dtype=torch.uint8)
    lens = torch.tensor([64, 40], dtype=torch.int32)
    empty = {"t1": torch.full((8, 24), -1, dtype=torch.int32),
             "t2": torch.full((8, 24), -1, dtype=torch.int32)}
    before = dict(kernels.launches)
    ids = tl.window_ids(empty, packed, vbits, lens, do_rc=True, bad_ix=7, num_labels=5)
    assert ids.shape == (2, 66) and (ids == 7).all()
    assert kernels.launches == before
