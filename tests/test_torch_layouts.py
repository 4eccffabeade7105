"""The port's pipeline against utree_tpu.pipeline beyond the displaced main
path: the canonical ladder that `auto` picks below 80M records, wide labels
(IXTYPE=u32) on both tables, the narrow/wide boundary, label strings of
2048+ chars (the packed-histogram layout), long reads (chunked, merged on
the host) and the bsearch replay in each readback layout, with `auto`'s
fallback to it; and support_ranges=8 (per-rank SUPPORT;RANGE columns) in
every table and readback layout.  classifications.txt must match byte for
byte.

Every database comes from make_toy_db -> build_database ->
DeviceIndexArrays.from_build (no oracle); the port gets its own copy of the
index through convert.index_from_jax, and both pipelines search the same
table: the port receives the JAX pipeline's `_table` through
convert.tables_from_jax."""

import numpy as np
import pytest
import torch

from utree_tpu.build import build_database
from utree_tpu.config import UTreeConfig
from utree_tpu.index import DeviceIndexArrays
from utree_tpu.pipeline import SearchPipeline as JaxPipeline
from utree_tpu.testdata import make_toy_db, make_toy_reads
from utree_tpu_torch.convert import index_from_jax, tables_from_jax
from utree_tpu_torch.pipeline import SearchPipeline

BATCH = 128
SMALL_THRESHOLD, SMALL_CHUNK = 400, 128  # several chunks per long read


def _chimera(rng, recs, n_parts, part_len):
    parts = []
    for r in rng.choice(len(recs), n_parts):
        seq = recs[r][2]
        s = int(rng.integers(0, len(seq) - part_len))
        parts.append(seq[s:s + part_len])
    return b"".join(parts)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    wd = tmp_path_factory.mktemp("layouts")
    recs = make_toy_db(str(wd / "refs.fa"), str(wd / "tax.map"), seed=41,
                       num_refs=12)
    make_toy_reads(str(wd / "short.fa"), recs, num_reads=500, seed=43)
    rng = np.random.default_rng(47)
    with open(wd / "short.fa", "ab") as f:
        for i in range(40):  # 3+ labels a read: hist_cap=2 overflows
            f.write(b">chimera%d\n" % i + _chimera(rng, recs, 3, 50) + b"\n")
    # short reads mixed with long ones of 0.5-4 kbp, chimeras of ref pieces
    # (the 50 bp pieces put 3+ labels into a 128-window chunk), one with an
    # N run; at 128 windows a chunk they need 16, 28, 4 and 32 chunks, and
    # 28 rounds up to 32
    shorts = (wd / "short.fa").read_bytes().split(b">")[1:]
    longs = [_chimera(rng, recs, 40, 50), _chimera(rng, recs, 3, 1200),
             _chimera(rng, recs, 1, 520), _chimera(rng, recs, 8, 500)]
    longs[3] = longs[3][:1700] + b"N" * 60 + longs[3][1760:]
    with open(wd / "long.fa", "wb") as f:
        for i, rec in enumerate(shorts[:120]):
            f.write(b">" + rec)
            if i % 30 == 7:
                f.write(b">long%d\n" % i + longs[i // 30] + b"\n")
    # one 20 kbp read at the real threshold (16,384 bp): two chunks
    big = b"".join(recs[i][2] for i in range(4))[:20_000]
    with open(wd / "long20k.fa", "wb") as f:
        f.write(b"".join(b">s%d\n" % i + recs[i][2][100:250] + b"\n" for i in range(8)))
        f.write(b">big\n" + big + b"\n")
        f.write(b"".join(b">t%d\n" % i + recs[i][2][900:1050] + b"\n" for i in range(8)))
    res = build_database(str(wd / "refs.fa"), str(wd / "tax.map"), UTreeConfig())
    return {"dir": wd, "res": res, "golden": {}}


def _index(env, kind):
    """narrow: the toy labels; wide: padded past 70,000 labels (IXTYPE=u32),
    as tests/test_hash_index.py pads them; n65534 / n65535: exactly at the
    narrow/wide boundary; longlabel: two label strings of 2100+ chars."""
    res = env["res"]
    strings = list(res.labels.strings)
    cfg = UTreeConfig()
    if kind == "wide":
        strings += [b"pad%d" % i for i in range(70_000 - len(strings))]
        cfg = UTreeConfig(ixtype_bytes=4)
    elif kind in ("n65534", "n65535"):
        n = int(kind[1:])
        strings += [b"pad%d" % i for i in range(n - len(strings))]
        cfg = UTreeConfig(ixtype_bytes=4 if n >= 0xFFFF else 2)
    elif kind == "longlabel":
        strings[0] = strings[0] + b";x__" + b"q" * 2100
        strings[1] = strings[1] + b"_" * 2200
    return DeviceIndexArrays.from_build(res.words, res.ixs, strings, cfg)


def _run_both(env, tmp_path, kind, reads, *, mode="auto", hist_cap=8,
              threshold=None, chunk=None, port_hook=None, **kw):
    """The JAX pipeline's bytes (cached) and the port's, on one table; `kw`
    (support_ranges, compact_over_cap, device_vote) goes to both."""
    key = (kind, reads, mode, hist_cap, threshold, chunk, tuple(sorted(kw.items())))
    index = _index(env, kind)
    if key not in env["golden"]:
        jp = JaxPipeline(index, do_rc=True, batch_size=BATCH, hist_cap=hist_cap,
                         lookup_mode=mode, **kw)
        if threshold:
            jp.long_read_threshold, jp.long_chunk = threshold, chunk
        out = env["dir"] / ("jax_%d.txt" % len(env["golden"]))
        jp.search_file(str(env["dir"] / reads), str(out))
        layout = ("vote" if jp._devvote else "compact" if jp._compact
                  else "packed" if jp._packed_out else "unpacked")
        env["golden"][key] = (out.read_bytes(), tables_from_jax(jp._table),
                              jp.table_kind, layout)
    want, table, kind_j, layout = env["golden"][key]
    pipe = SearchPipeline(index_from_jax(index), device="cpu", do_rc=True,
                          batch_size=BATCH, hist_cap=hist_cap, lookup_mode=mode,
                          _table=table, **kw)
    if threshold:
        pipe.long_read_threshold, pipe.long_chunk = threshold, chunk
    assert pipe.table_kind == kind_j
    # the port's readback layout is the JAX pipeline's step choice
    assert pipe.layout == layout
    if port_hook:
        port_hook(pipe)
    out = tmp_path / "port.txt"
    pipe.search_file(str(env["dir"] / reads), str(out))
    return out.read_bytes(), want, pipe


def _replays(pipe):
    seen = []
    orig = pipe._host_hits
    pipe._host_hits = lambda seq: seen.append(seq) or orig(seq)
    return seen


@pytest.mark.parametrize("hist_cap", [8, 2])
def test_auto_resolves_to_the_ladder(env, tmp_path, hist_cap):
    """`auto` on the toy DB is the canonical ladder in both packages (the
    device vote); at hist_cap=2 the flagged reads are replayed on the host."""
    seen = []
    got, want, pipe = _run_both(env, tmp_path, "narrow", "short.fa", hist_cap=hist_cap,
                                port_hook=lambda p: seen.append(_replays(p)))
    assert pipe.table_kind == "canonical" and pipe.layout == "vote"
    assert got == want and want.count(b"\n") > 300
    assert bool(seen[0]) == (hist_cap == 2)


def test_auto_builds_the_jax_ladder(env):
    """Without _table the port places the same ladder and vote tables."""
    index = _index(env, "narrow")
    want = tables_from_jax(JaxPipeline(index, do_rc=True)._table)
    got = SearchPipeline(index_from_jax(index), device="cpu", do_rc=True)._tables[0]
    assert sorted(got) == sorted(want) and "c1" in got
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("hist_cap", [8, 2])
@pytest.mark.parametrize("mode", ["canonical", "displaced"])
def test_wide_labels(env, tmp_path, mode, hist_cap):
    """IXTYPE=u32 labels: 4-column slots and the unpacked (B, 2*cap+2)
    histogram rows, on both tables."""
    seen = []
    got, want, pipe = _run_both(env, tmp_path, "wide", "short.fa", mode=mode,
                                hist_cap=hist_cap,
                                port_hook=lambda p: seen.append(_replays(p)))
    assert pipe.layout == "unpacked" and pipe.table_kind == mode
    assert pipe._tables[0]["c1" if mode == "canonical" else "d1"].shape[1] % 4 == 0
    assert got == want and want.count(b"\n") > 300
    assert bool(seen[0]) == (hist_cap == 2)


@pytest.mark.parametrize("kind", ["n65534", "n65535"])
def test_narrow_wide_boundary(env, tmp_path, kind):
    """65,534 labels are the last narrow DB (device vote), 65,535 the first
    wide one (unpacked rows)."""
    got, want, pipe = _run_both(env, tmp_path, kind, "short.fa")
    assert pipe.layout == ("vote" if kind == "n65534" else "unpacked")
    assert got == want and want.count(b"\n") > 300


@pytest.mark.parametrize("hist_cap", [8, 2])
def test_long_label_strings(env, tmp_path, hist_cap):
    """Labels of 2048+ chars do not fit the device vote's dv lane: the
    compact readback (K8), rebuilt into the packed (B, cap+1) rows on the
    host, goes to the C vote (`vote_packed`), as JAX's `_compact` step."""
    got, want, pipe = _run_both(env, tmp_path, "longlabel", "short.fa",
                                hist_cap=hist_cap)
    assert pipe.layout == "compact"
    assert got == want and b"q" * 2100 in want


@pytest.mark.parametrize("kind", ["narrow", "wide"])
def test_long_reads_chunked(env, tmp_path, kind):
    """Long reads mixed with short ones, at a small threshold and chunk so
    that each long read takes several chunks (a power-of-two count of them),
    at hist_cap=2 so that chunks of the chimeric read overflow and are
    replayed on the host."""
    seen = []
    got, want, pipe = _run_both(env, tmp_path, kind, "long.fa", hist_cap=2,
                                threshold=SMALL_THRESHOLD, chunk=SMALL_CHUNK,
                                port_hook=lambda p: seen.append(_replays(p)))
    assert got == want
    assert sum(ln.startswith(b"long") for ln in want.splitlines()) == 4
    reads = set((env["dir"] / "long.fa").read_bytes().split(b"\n"))
    assert any(s not in reads for s in seen[0])  # an overflowed chunk replayed


@pytest.mark.parametrize("kind", ["narrow", "wide"])
def test_long_read_at_the_real_threshold(env, tmp_path, kind):
    """A 20 kbp read over the default 16,384 bp threshold: two chunks."""
    got, want, _ = _run_both(env, tmp_path, kind, "long20k.fa")
    assert got == want and any(ln.startswith(b"big\t") for ln in want.splitlines())


def test_resume_across_a_long_read(env, tmp_path):
    """The checkpoint commits after each long read: a run that dies in the
    second long read resumes to the uninterrupted bytes."""
    want = _run_both(env, tmp_path, "narrow", "long.fa", hist_cap=2,
                     threshold=SMALL_THRESHOLD, chunk=SMALL_CHUNK)[1]
    pipe = SearchPipeline(index_from_jax(_index(env, "narrow")), device="cpu",
                          do_rc=True, batch_size=BATCH, hist_cap=2,
                          _table=env["golden"][("narrow", "long.fa", "auto", 2,
                                                SMALL_THRESHOLD, SMALL_CHUNK, ())][1])
    pipe.long_read_threshold, pipe.long_chunk = SMALL_THRESHOLD, SMALL_CHUNK

    class Stop(Exception):
        pass

    orig = pipe.classify_long_read
    calls = []

    def bomb(name, seq):
        calls.append(name)
        if len(calls) == 2:
            raise Stop()
        return orig(name, seq)

    pipe.classify_long_read = bomb
    part = tmp_path / "part.txt"
    with pytest.raises(Stop):
        pipe.search_file(str(env["dir"] / "long.fa"), str(part))
    assert (tmp_path / "part.txt.ckpt").exists()
    assert calls[0] in part.read_bytes()  # the first long read was committed
    pipe.classify_long_read = orig
    pipe.search_file(str(env["dir"] / "long.fa"), str(part), resume=True)
    assert part.read_bytes() == want
    assert not (tmp_path / "part.txt.ckpt").exists()


def test_cli_lookup_mode_canonical(env, tmp_path, capsys):
    """`search --lookup-mode canonical` on the .ctr round trip of the DB;
    --trace prints the table kind."""
    from utree_tpu.formats import write_ctr_from_ubt, write_ubt
    from utree_tpu_torch.cli import main

    res, wd = env["res"], env["dir"]
    cfg = UTreeConfig()
    write_ubt(str(wd / "db.ubt"), res.words, res.ixs, res.labels.strings, cfg)
    write_ctr_from_ubt(str(wd / "db.ubt"), str(wd / "db.ctr"), cfg)
    out = tmp_path / "cli.txt"
    main(["search", str(wd / "db.ctr"), str(wd / "short.fa"), str(out), "--rc",
          "--device", "cpu", "--batch", str(BATCH), "--lookup-mode", "canonical",
          "--trace"])
    assert "table_kind: canonical" in capsys.readouterr().out
    assert out.read_bytes() == _run_both(env, tmp_path, "narrow", "short.fa",
                                         mode="canonical")[1]


def test_table_choice_follows_the_record_count(env, monkeypatch):
    """`auto` resolves by record count as utree_tpu.pipeline does: displaced
    from the crossover; past the device tables' ceiling, the bsearch replay
    below the replay ceiling and an error from it; a DB that fits neither
    table takes the replay (test_auto_falls_back_to_bsearch)."""
    import utree_tpu_torch.pipeline as P

    index = index_from_jax(_index(env, "narrow"))
    monkeypatch.setattr(P, "_DISPLACED_AUTO_MIN", 0)
    assert SearchPipeline(index, device="cpu").table_kind == "displaced"
    assert SearchPipeline(index, device="cpu", lookup_mode="canonical").table_kind == "canonical"
    monkeypatch.setattr(P, "_HASH_AUTO_MAX", 0)
    assert SearchPipeline(index, device="cpu").table_kind == "bsearch"
    monkeypatch.setattr(P, "_REPLAY_AUTO_MAX", 0)
    with pytest.raises(RuntimeError, match="exceeds the single-chip device-table ceiling"):
        SearchPipeline(index, device="cpu")
    assert SearchPipeline(index, device="cpu", lookup_mode="bsearch").table_kind == "bsearch"


def _no_fit(*a, **k):
    raise ValueError("no geometry fits")


@pytest.mark.parametrize("error", [torch.OutOfMemoryError, RuntimeError],
                         ids=["out-of-memory", "runtime-error"])
def test_device_error_in_a_tier_propagates(env, monkeypatch, error):
    """A device out of memory, or any RuntimeError that is not a budget
    refusal, raised inside a ladder tier leaves build_canonical_hash_index
    and SearchPipeline(...) as it is: no next tier, no bsearch."""
    import utree_tpu_torch.hash_index as TH

    tiers = []

    def place(*a, **k):
        tiers.append(a[7])
        raise error("CUDA out of memory")

    monkeypatch.setattr(TH, "_place_canonical", place)
    port = index_from_jax(_index(env, "narrow"))
    with pytest.raises(error, match="out of memory"):
        TH.build_canonical_hash_index(port)
    with pytest.raises(error, match="out of memory"):
        SearchPipeline(port, device="cpu", do_rc=True, batch_size=BATCH)
    assert tiers == [2, 2]  # tier A, once each


def test_budget_refusal_moves_to_next_tier(env, monkeypatch):
    """A budget refusal (TierRefused) in tier A: the pipeline places tier
    B and counts both attempts."""
    import utree_tpu_torch.hash_index as TH
    from utree_tpu_torch.utils import trace

    real = TH._place_canonical

    def place(*a, **k):
        if a[7] == 2:
            raise TH.TierRefused("canonical table would exceed the HBM budget")
        return real(*a, **k)

    monkeypatch.setattr(TH, "_place_canonical", place)
    with trace.scope() as rec:
        pipe = SearchPipeline(index_from_jax(_index(env, "narrow")), device="cpu",
                              do_rc=True, batch_size=BATCH)
    assert pipe.table_kind == "canonical" and pipe._tables[0]["c1"].shape[1] == 12
    assert rec.counts["table.attempts"] == 2 and "table.place_device" not in rec.counts


def test_auto_falls_back_to_bsearch(env, tmp_path, monkeypatch):
    """With both table builders failing (the JAX package's and the port's
    copies), `auto` takes the bsearch replay in both pipelines below 80M
    records (same bytes), and from the replay ceiling both raise the same
    RuntimeError."""
    import utree_tpu.hash_index as H
    import utree_tpu.pipeline as JP
    import utree_tpu_torch.hash_index as TH
    import utree_tpu_torch.pipeline as P

    for mod in (H, TH):
        monkeypatch.setattr(mod, "build_canonical_hash_index", _no_fit)
        monkeypatch.setattr(mod, "build_displaced_index", _no_fit)
    index, port = _index(env, "narrow"), index_from_jax(_index(env, "narrow"))
    jp = JaxPipeline(index, do_rc=True, batch_size=BATCH)
    pipe = SearchPipeline(port, device="cpu", do_rc=True, batch_size=BATCH)
    assert jp.table_kind == pipe.table_kind == "bsearch" and pipe.layout == "vote"
    jp.search_file(str(env["dir"] / "short.fa"), str(tmp_path / "jax.txt"))
    pipe.search_file(str(env["dir"] / "short.fa"), str(tmp_path / "port.txt"))
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    with pytest.raises(RuntimeError, match="canonical cannot be honored"):
        SearchPipeline(port, device="cpu", lookup_mode="canonical")
    monkeypatch.setattr(JP, "_REPLAY_AUTO_MAX", 0)
    monkeypatch.setattr(P, "_REPLAY_AUTO_MAX", 0)
    msgs = []
    for make in (lambda: JaxPipeline(index), lambda: SearchPipeline(port, device="cpu")):
        with pytest.raises(RuntimeError, match="fits no single-chip device table") as e:
            make()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("kind,hist_cap", [("narrow", 8), ("narrow", 2),
                                           ("longlabel", 2), ("wide", 2)])
def test_bsearch_layouts(env, tmp_path, kind, hist_cap):
    """`--lookup-mode bsearch` (K7's replay over the CTR records) in the
    three readback layouts: the device vote, the compact readback for long
    labels, unpacked rows for wide labels; hist_cap=2 replays flagged
    reads."""
    seen = []
    got, want, pipe = _run_both(env, tmp_path, kind, "short.fa", mode="bsearch",
                                hist_cap=hist_cap,
                                port_hook=lambda p: seen.append(_replays(p)))
    assert pipe.table_kind == "bsearch"
    assert pipe.layout == {"narrow": "vote", "longlabel": "compact", "wide": "unpacked"}[kind]
    assert got == want and want.count(b"\n") > 300
    assert bool(seen[0]) == (hist_cap == 2)


def test_bsearch_long_reads(env, tmp_path):
    """Long reads through the replay: chunks take the packed histogram step."""
    got, want, _ = _run_both(env, tmp_path, "narrow", "long.fa", mode="bsearch",
                             hist_cap=2, threshold=SMALL_THRESHOLD, chunk=SMALL_CHUNK)
    assert got == want
    assert sum(ln.startswith(b"long") for ln in want.splitlines()) == 4


def test_cli_lookup_mode_bsearch(env, tmp_path, capsys):
    """`search --lookup-mode bsearch` on the .ctr round trip of the DB."""
    from utree_tpu.formats import write_ctr_from_ubt, write_ubt
    from utree_tpu_torch.cli import main

    res, wd = env["res"], env["dir"]
    cfg = UTreeConfig()
    if not (wd / "db.ctr").exists():
        write_ubt(str(wd / "db.ubt"), res.words, res.ixs, res.labels.strings, cfg)
        write_ctr_from_ubt(str(wd / "db.ubt"), str(wd / "db.ctr"), cfg)
    out = tmp_path / "cli.txt"
    main(["search", str(wd / "db.ctr"), str(wd / "short.fa"), str(out), "--rc",
          "--device", "cpu", "--batch", str(BATCH), "--lookup-mode", "bsearch",
          "--trace"])
    assert "table_kind: bsearch" in capsys.readouterr().out
    assert out.read_bytes() == _run_both(env, tmp_path, "narrow", "short.fa",
                                         mode="bsearch")[1]


# support_ranges=8 (per-rank SUPPORT;RANGE columns): both pipelines vote
# every read in Python; (labels, lookup mode, reads, hist_cap, extra keywords)
_LONG = dict(threshold=SMALL_THRESHOLD, chunk=SMALL_CHUNK)
_SUPPORT8 = {
    "ladder": ("narrow", "auto", "short.fa", 8, {}),
    "displaced-replay": ("narrow", "displaced", "short.fa", 2, {}),
    "bsearch": ("narrow", "bsearch", "short.fa", 8, {}),
    "packed": ("narrow", "auto", "short.fa", 8, dict(compact_readback=False)),
    "longlabel": ("longlabel", "auto", "short.fa", 2, {}),
    "wide-ladder-replay": ("wide", "canonical", "short.fa", 2, {}),
    "wide-displaced": ("wide", "displaced", "short.fa", 8, {}),
    "long-reads": ("narrow", "auto", "long.fa", 2, _LONG),
    "wide-long-reads": ("wide", "auto", "long.fa", 2, _LONG),
}


@pytest.mark.parametrize("case", list(_SUPPORT8))
def test_support_ranges_8(env, tmp_path, case):
    """support_ranges=8 in every table and readback layout: the compact
    readback on narrow labels (packed rows without compact_readback),
    unpacked rows on wide labels; reads over hist_cap replayed on the host,
    long reads chunked; the JAX pipeline's bytes."""
    kind, mode, reads, hist_cap, extra = _SUPPORT8[case]
    seen = []
    got, want, pipe = _run_both(env, tmp_path, kind, reads, mode=mode, hist_cap=hist_cap,
                                support_ranges=8,
                                port_hook=lambda p: seen.append(_replays(p)), **extra)
    assert pipe.layout == ("unpacked" if kind == "wide" else
                           "packed" if "compact_readback" in extra else "compact")
    assert got == want and want.count(b"\n") > (60 if reads == "long.fa" else 300)
    assert max(ln.count(b"\t") for ln in want.splitlines()) == 11
    if reads == "long.fa":
        assert sum(ln.startswith(b"long") for ln in want.splitlines()) == 4
    assert bool(seen[0]) == (hist_cap == 2)


@pytest.mark.parametrize("support_ranges", [1, 8])
def test_compact_readback_redispatch(env, tmp_path, support_ranges):
    """compact_over_cap=1: a batch with 2+ reads of 2+ labels overflows the
    block and is dispatched again through the full rows; at support 1 the
    device vote is off (the C vote over the rebuilt rows), at 8 it is off
    anyway.  The JAX pipeline's bytes."""
    redone = []

    def hook(pipe):
        orig = pipe._step_hist
        pipe._step_hist = lambda *a, **k: redone.append(1) or orig(*a, **k)

    got, want, pipe = _run_both(env, tmp_path, "narrow", "short.fa", mode="displaced",
                                support_ranges=support_ranges, device_vote=False,
                                compact_over_cap=1, port_hook=hook)
    assert pipe.layout == "compact" and pipe._over_cap == 1
    assert got == want and want.count(b"\n") > 300
    assert redone  # a batch was redispatched
