"""The port's list-of-reads API (SearchPipeline._pack, dispatch, finalize,
classify_batch, finalize_bytes) and VoteEngine.vote_batch against
utree_tpu's, exact: the lines and bytes of both on the same reads and table.

Each case runs both pipelines on 512 reads (RC) of mixed lengths, chimeras
of three references among them, in batches of 128.  The DBs come from
make_toy_db -> build_database -> DeviceIndexArrays.from_build; the port gets
its own copy of the index (convert.index_from_jax) and the JAX pipeline's
table (convert.tables_from_jax)."""

import numpy as np
import pytest

from utree_tpu.build import build_database
from utree_tpu.classify import aufbau_vote_counts
from utree_tpu.config import UTreeConfig
from utree_tpu.index import DeviceIndexArrays
from utree_tpu.native import VoteEngine as JaxVoteEngine
from utree_tpu.pipeline import SearchPipeline as JaxPipeline
from utree_tpu.testdata import make_toy_db, make_toy_reads
from utree_tpu_torch.convert import index_from_jax, tables_from_jax
from utree_tpu_torch.io.fasta import read_linearized_fasta
from utree_tpu_torch.native import VoteEngine
from utree_tpu_torch.pipeline import SearchPipeline

BATCH = 128
NREADS = 512


def _reads(path, recs, rng, n_toy: int):
    """make_toy_reads' reads, 3-ref chimeras (hist_cap=2 overflows), reads
    of 40-400 bp (the batch width buckets) and one shorter than k."""
    make_toy_reads(str(path), recs, num_reads=n_toy, seed=int(rng.integers(1000, 2000)))
    with open(path, "ab") as f:
        for i in range(NREADS - n_toy - 21):
            parts = []
            for r in rng.choice(len(recs), 3, replace=False):
                s = int(rng.integers(0, len(recs[r][2]) - 80))
                parts.append(recs[r][2][s:s + 80])
            f.write(b">chimera%d\n" % i + b"".join(parts) + b"\n")
        for i in range(20):
            r = recs[int(rng.integers(0, len(recs)))][2]
            n = int(rng.integers(40, 400))
            s = int(rng.integers(0, len(r) - n))
            f.write(b">len%d\n" % i + r[s:s + n] + b"\n")
        f.write(b">short\nACGTACGTACGTACGTACGT\n")
    recs_out = read_linearized_fasta(str(path))
    assert len(recs_out) == NREADS
    return [h.split(b" ")[0] for h, _ in recs_out], [s for _, s in recs_out]


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    wd = tmp_path_factory.mktemp("torchapi")
    rng = np.random.default_rng(353)
    recs = make_toy_db(str(wd / "refs.fa"), str(wd / "tax.map"), seed=359, num_refs=12)
    res = build_database(str(wd / "refs.fa"), str(wd / "tax.map"), UTreeConfig())
    out = {"dir": wd, "res": res, "reads32": _reads(wd / "reads32.fa", recs, rng, 440)}
    # PACKSIZE=64: a seed whose lowest prefix bin the 64-mer table builders
    # accept (a DB whose lowest bin holds one record sorting after the next
    # bin's first makes both packages' builders raise; that fault is pinned
    # by test_lowest_bin_fault_matches_jax in tests/test_torch_pack64.py)
    recs64 = make_toy_db(str(wd / "refs64.fa"), str(wd / "tax64.map"), seed=53,
                         num_refs=8, ref_len=3000)
    cfg64 = UTreeConfig(packsize=64, ixtype_bytes=4)
    r64 = build_database(str(wd / "refs64.fa"), str(wd / "tax64.map"), cfg64)
    out["k64"] = DeviceIndexArrays.from_build(r64.words, r64.ixs, r64.labels.strings, cfg64)
    out["reads64"] = _reads(wd / "reads64.fa", recs64, rng, 450)
    return out


def _index(env, kind):
    res = env["res"]
    if kind == "k64":
        return env["k64"]
    if kind == "wide":  # padded past 70,000 labels (IXTYPE=u32): unpacked rows
        strings = list(res.labels.strings) + [b"pad%d" % i for i in range(70_000 - len(res.labels))]
        return DeviceIndexArrays.from_build(res.words, res.ixs, strings,
                                            UTreeConfig(ixtype_bytes=4))
    return DeviceIndexArrays.from_build(res.words, res.ixs, res.labels.strings, UTreeConfig())


# case -> (index kind, lookup_mode, hist_cap, keyword arguments, the layout)
_CASES = {
    "displaced": ("narrow", "displaced", 8, {}, "vote"),
    "canonical": ("narrow", "canonical", 8, {}, "vote"),
    "bsearch": ("narrow", "bsearch", 8, {}, "vote"),
    "hash": ("narrow", "hash", 8, {}, "vote"),
    "compact": ("narrow", "displaced", 8, {"device_vote": False}, "compact"),
    "hist-cap-2": ("narrow", "displaced", 2, {}, "vote"),
    "compact-cap-2": ("narrow", "canonical", 2, {"device_vote": False}, "compact"),
    "support-8": ("narrow", "displaced", 8, {"support_ranges": 8}, "compact"),
    "wide": ("wide", "canonical", 8, {}, "unpacked"),
    "wide-cap-2": ("wide", "displaced", 2, {}, "unpacked"),
    "pack64": ("k64", "auto", 8, {}, "unpacked"),
    "pack64-cap-2": ("k64", "displaced", 2, {}, "unpacked"),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_list_of_reads_api_equal_jax(env, tmp_path, case):
    """classify_batch, finalize(dispatch(...)) and finalize_bytes(dispatch(
    ...)) give utree_tpu's lines and bytes batch by batch; finalize_bytes
    joins finalize's lines, and all batches together are the bytes the
    port's search_file writes for the same reads."""
    kind, mode, cap, kw, layout = _CASES[case]
    index = _index(env, kind)
    names, seqs = env["reads64" if kind == "k64" else "reads32"]
    jp = JaxPipeline(index, do_rc=True, batch_size=BATCH, hist_cap=cap, lookup_mode=mode, **kw)
    pipe = SearchPipeline(index_from_jax(index), device="cpu", do_rc=True, batch_size=BATCH,
                          hist_cap=cap, lookup_mode=mode, _table=tables_from_jax(jp._table),
                          **kw)
    assert pipe.layout == layout and pipe.table_kind == jp.table_kind
    replayed = []
    host_hits = pipe._host_hits
    pipe._host_hits = lambda seq: replayed.append(seq) or host_hits(seq)
    got_bytes = []
    for a in range(0, NREADS, BATCH):
        n, q = names[a:a + BATCH], seqs[a:a + BATCH]
        lines = pipe.classify_batch(n, q)
        assert lines == jp.classify_batch(n, q)
        assert pipe.finalize(n, q, pipe.dispatch(q)) == lines
        assert jp.finalize(n, q, jp.dispatch(q)) == lines
        fb = pipe.finalize_bytes(n, q, pipe.dispatch(q))
        assert fb == jp.finalize_bytes(n, q, jp.dispatch(q))
        assert fb == b"".join(ln + b"\n" for ln in lines if ln is not None)
        if b"short" in n:  # no window of k bases: no line
            assert lines[n.index(b"short")] is None
        got_bytes.append(fb)
    out = tmp_path / "search.txt"
    pipe.search_file(str(env["dir"] / ("reads64.fa" if kind == "k64" else "reads32.fa")),
                     str(out))
    assert out.read_bytes() == b"".join(got_bytes) and out.read_bytes().count(b"\n") > 250
    # a cap of 2 flags the chimeras (3 labels): the host replay ran
    assert bool(replayed) == (cap == 2)


def test_pack_buckets_like_jax(env):
    """_pack's ASCII matrix and lengths equal utree_tpu's for any length mix."""
    names, seqs = env["reads32"]
    index = _index(env, "narrow")
    jp = JaxPipeline(index, do_rc=True, batch_size=BATCH, lookup_mode="displaced")
    pipe = SearchPipeline(index_from_jax(index), device="cpu", do_rc=True, batch_size=BATCH,
                          lookup_mode="displaced", _table=tables_from_jax(jp._table))
    for batch in (seqs[:3], seqs[-21:], [b"A" * 3000, b""], [b"C" * 2049], []):
        got, want = pipe._pack(batch), jp._pack(batch)
        assert all(np.array_equal(g, w) and g.dtype == w.dtype for g, w in zip(got, want))
    assert pipe._pack([b"C" * 2049])[0].shape == (1, 4096)


def test_vote_batch_equal_jax():
    """VoteEngine.vote_batch: utree_tpu.native's bytes on random CSR
    histograms (tests/test_native_vote.py's property), and a batch whose
    middle read has an empty histogram (no line)."""
    rng = np.random.default_rng(367)
    ranks = b"kpcofgst"
    strings = list(dict.fromkeys(
        b";".join(ranks[d:d + 1] + b"__" + bytes(rng.integers(97, 100, 2, dtype=np.uint8))
                  for d in range(int(rng.integers(1, 9))))
        for _ in range(80)))
    eng, jeng = VoteEngine(strings, 4), JaxVoteEngine(strings, 4)
    assert eng.available and jeng.available
    names, offs, ids, cnts = [], [0], [], []
    for trial in range(300):
        nu = int(rng.integers(0, min(12, len(strings))))
        ids.append(rng.choice(len(strings), size=nu, replace=False).astype(np.int32))
        cnts.append(rng.integers(1, 30, size=nu).astype(np.int32))
        names.append(b"q%d" % trial)
        offs.append(offs[-1] + nu)
    offs, ids, cnts = np.array(offs, np.int64), np.concatenate(ids), np.concatenate(cnts)
    got = eng.vote_batch(names, offs, ids, cnts)
    assert got == jeng.vote_batch(names, offs, ids, cnts)
    want = [aufbau_vote_counts(nm, ids[offs[i]:offs[i + 1]], cnts[offs[i]:offs[i + 1]],
                               strings, 4) for i, nm in enumerate(names)]
    assert got == b"".join(ln + b"\n" for ln in want if ln is not None)
    assert got.count(b"\n") < 300  # the empty histograms wrote no line
    three = eng.vote_batch([b"a", b"b", b"c"], np.array([0, 2, 2, 3], np.int64),
                           np.array([0, 1, 2], np.int32), np.array([3, 2, 1], np.int32))
    assert three == jeng.vote_batch([b"a", b"b", b"c"], np.array([0, 2, 2, 3], np.int64),
                                    np.array([0, 1, 2], np.int32),
                                    np.array([3, 2, 1], np.int32))
    assert [ln.split(b"\t")[0] for ln in three.splitlines()] == [b"a", b"c"]
