"""The port's database build against utree_tpu's, byte for byte: the map
reader, the label table and fold, the word order and split, the .ubt/.ctr
writers and readers, build_database, the streaming build and compress, and
the CLI's build, compress and search --profile-dir.

Inputs come from utree_tpu.testdata (never the `toy` fixture, which needs
the absent C oracle); every comparison is exact (bytes or np.array_equal)."""

import json

import numpy as np
import pytest
import torch

from utree_tpu import build as j_build
from utree_tpu import build_stream as j_stream
from utree_tpu import cli as j_cli
from utree_tpu import encode as j_encode
from utree_tpu import formats as j_formats
from utree_tpu import taxonomy as j_tax
from utree_tpu.config import UTreeConfig as JConfig
from utree_tpu.io import fasta as j_fasta
from utree_tpu.io import maps as j_maps
from utree_tpu.testdata import make_toy_db, make_toy_reads
from utree_tpu_torch import build as t_build
from utree_tpu_torch import build_stream as t_stream
from utree_tpu_torch import cli as t_cli
from utree_tpu_torch import encode as t_encode
from utree_tpu_torch import formats as t_formats
from utree_tpu_torch import taxonomy as t_tax
from utree_tpu_torch.config import UTreeConfig as TConfig
from utree_tpu_torch.io import fasta as t_fasta
from utree_tpu_torch.io import maps as t_maps
from utree_tpu_torch.utils.trace import Tracer, kernel_names

# ---- maps, FASTA, taxonomy, encode ----------------------------------------

_MAPS = {
    "blank-key": b"r0\tk__a;p__b\n\tk__a\n",
    "blank-label": b"r0\tk__a;p__b\nr1\t\n",
    "one-column": b"r0\tk__a;p__b\nr1\n",
    "conflicting-duplicate": b"r0\tk__a\nr1\tk__b\nr0\tk__c\n",
    "empty": b"\n\n",
    "blank-label-before-cr": b"r0\t\rk__a\n",
}


@pytest.mark.parametrize("case", sorted(_MAPS))
def test_read_tax_map_errors_equal_jax(tmp_path, case):
    path = tmp_path / "tax.map"
    path.write_bytes(_MAPS[case])
    with pytest.raises(ValueError) as jerr:
        j_maps.read_tax_map(str(path))
    with pytest.raises(ValueError) as terr:
        t_maps.read_tax_map(str(path))
    assert str(terr.value) == str(jerr.value)


def test_read_tax_map_equal_jax(tmp_path):
    """'\\r' ends a label, a third column is ignored, a duplicate key with
    the same label is accepted, blank lines are skipped."""
    path = tmp_path / "tax.map"
    path.write_bytes(b"r0\tk__a;p__b\r\nr1\tk__a;p__c\tfunc__1\n\nr0\tk__a;p__b\n"
                     b"r2\tk__z\r\textra\n")
    got = t_maps.read_tax_map(str(path))
    assert got == j_maps.read_tax_map(str(path))
    assert list(got.items()) == [(b"r0", b"k__a;p__b"), (b"r1", b"k__a;p__c"),
                                 (b"r2", b"k__z")]


def test_read_linearized_fasta_equal_jax(tmp_path):
    path = tmp_path / "refs.fa"
    make_toy_db(str(path), str(tmp_path / "tax.map"), num_refs=5, ref_len=400, seed=311)
    assert t_fasta.read_linearized_fasta(str(path)) == j_fasta.read_linearized_fasta(str(path))


_FOLDS = [  # tests/test_taxonomy.py's cases, and the prefix case both ways
    (b"k__a;p__b;c__c;o__d", b"k__a;p__b;c__c;o__e", 2),
    (b"k__a;p__b", b"k__a;p__c", 2),
    (b"k__a;p__x", b"k__b;p__x", 2),
    (b"k__a;p__b;c__c", b"k__a;p__b;c__c;o__d", 2),
    (b"k__a;p__b;c__c;o__d", b"k__a;p__b;c__c", 2),
    (b"k__a;p__b;c__c;o__d;f__e;g__f;s__1", b"k__a;p__b;c__c;o__d;f__e;g__f;s__2", 2),
    (b"k__a;p__b;c__c;o__d;f__e;g__f", b"k__a;p__b;c__c;o__d;f__e;g__f;s__3", 2),
]


def test_fold_labels_equal_jax():
    for old, new, cc in _FOLDS:
        assert t_tax.fold_labels(old, new, cc) == j_tax.fold_labels(old, new, cc)
    assert t_tax.fold_labels(*_FOLDS[3]) == b"k__a;p__b"  # the erosion quirk
    assert t_tax.fold_labels(*_FOLDS[1]) is None and t_tax.BAD == j_tax.BAD == -1
    # seeded random pairs: shared ranks, then diverging or one a prefix
    rng = np.random.default_rng(317)
    ranks = [b"k__", b"p__", b"c__", b"o__", b"f__", b"g__", b"s__", b"t__"]
    bad = 0
    for _ in range(200):
        depth = int(rng.integers(1, 9))
        old = [r + bytes(rng.choice(list(b"ab_;"), int(rng.integers(1, 3))))
               for r in ranks[:depth]]
        keep = int(rng.integers(0, depth + 1))
        tail = int(rng.integers(0, 4))
        new = old[:keep] + [ranks[min(keep + j, 7)] + b"z%d" % j for j in range(tail)]
        old, new = b";".join(old), b";".join(new)
        if old == new:
            continue
        for cc in range(9):
            got = t_tax.fold_labels(old, new, cc)
            assert got == j_tax.fold_labels(old, new, cc), (old, new, cc)
            bad += got is None
    assert bad > 100


def test_label_table_equal_jax():
    rng = np.random.default_rng(331)
    jt, tt = j_tax.LabelTable(), t_tax.LabelTable()
    for s in (b"x%d" % v for v in rng.integers(0, 40, 300)):
        assert tt.get_or_add(s) == jt.get_or_add(s)
    assert tt.strings == jt.strings and len(tt) == len(jt)
    assert tt.get(b"nope") is None and tt.get(tt.strings[3]) == 3


def test_word_sort_key_and_split_equal_jax():
    rng = np.random.default_rng(337)
    w = rng.integers(0, 1 << 20, 5000).astype(np.uint64) << np.uint64(44)
    assert np.array_equal(t_encode.word_sort_key(w), j_encode.word_sort_key(w))
    w128 = np.zeros(5000, t_encode.W128)
    w128["hi"] = rng.integers(0, 50, 5000).astype(np.uint64)  # ties in hi
    w128["lo"] = rng.integers(0, 4, 5000).astype(np.uint64)   # and in (hi, lo)
    key = t_encode.word_sort_key(w128)
    assert np.array_equal(key, j_encode.word_sort_key(w128.view(j_encode.W128)))
    s = w128[key]
    assert np.all((s["hi"][1:] > s["hi"][:-1]) | ((s["hi"][1:] == s["hi"][:-1])
                                                   & (s["lo"][1:] >= s["lo"][:-1])))
    for got, want in zip(t_encode.split_word(w, 64, 40), j_encode.split_word(w, 64, 40)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_write_ctr_refuses_packsize_8(tmp_path):
    """PACKSIZE < 16 words cannot lose their 3 prefix bytes (itree.c:690)."""
    for mod, cfg in ((j_formats, JConfig(packsize=8, pfbits=8)),
                     (t_formats, TConfig(packsize=8, pfbits=8))):
        with pytest.raises(ValueError, match="cannot be compressed"):
            mod.write_ctr(str(tmp_path / "x.ctr"), np.zeros(1, np.uint64),
                          np.zeros(1, np.int64), [b"a"], np.ones(1, np.uint64), cfg)


# ---- build_database and the writers ---------------------------------------


def fold_refs(wd, seed: int):
    """A toy reference set whose conflicts exercise every branch of the fold:
    make_toy_db's refs of one shared six-rank lineage (each odd ref shares a
    third of the one before: the fold truncates to the lineage), every
    fourth ref relabelled into a foreign kingdom (its shared words go BAD),
    and three records spliced from refs 0 and 1 under a strain of the same
    lineage (the truncated label erodes one rank further: the prefix quirk).
    Returns make_toy_db's records."""
    fa, mp = wd / "refs.fa", wd / "tax.map"
    recs = make_toy_db(str(fa), str(mp), num_refs=12, ref_len=3000, seed=seed,
                       num_lineages=1)
    lineage = b";".join(recs[0][1].split(b";")[:6])
    lines = mp.read_bytes().splitlines()
    for i in range(3, len(lines), 4):
        lines[i] = recs[i][0] + b"\tk__x;p__y%d;c__z;o__w;f__v;g__u;s__t" % i
    with open(fa, "ab") as f:
        for j in range(3):
            f.write(b">splice%d\n" % j + recs[0][2][200 * j:200 * j + 600]
                    + recs[1][2][:300] + b"\n")
            lines.append(b"splice%d\t" % j + lineage + b";s__new;t__x%d" % j)
    mp.write_bytes(b"\n".join(lines) + b"\n")
    return recs


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    wd = tmp_path_factory.mktemp("torchbuild")
    recs = fold_refs(wd, 341)
    make_toy_reads(str(wd / "reads.fa"), recs, num_reads=300, seed=343)
    return wd


def _same_build(a, b):
    assert np.array_equal(a.words, b.words) and a.words.dtype == b.words.dtype
    assert np.array_equal(a.ixs, b.ixs)
    assert a.labels.strings == b.labels.strings
    assert np.array_equal(a.label_counts, b.label_counts)
    assert (a.num_seqs, a.num_conflicted) == (b.num_seqs, b.num_conflicted)


@pytest.mark.parametrize("packsize", [16, 32, 64])
@pytest.mark.parametrize("do_gg", [True, False], ids=["gg", "rank-specific"])
@pytest.mark.parametrize("complevel", [0, 1, 2])
def test_build_database_equal_jax(refs, tmp_path, complevel, do_gg, packsize):
    """The same nodes, labels (truncated ones numbered where the fold makes
    them) and counts; the .ubt and .ctr bytes of both writers, and both
    readers on each file."""
    ixb = 4 if packsize == 64 else 2
    jcfg = JConfig(packsize=packsize, complevel=complevel, ixtype_bytes=ixb)
    tcfg = TConfig(packsize=packsize, complevel=complevel, ixtype_bytes=ixb)
    fa, mp = str(refs / "refs.fa"), str(refs / "tax.map")
    want = j_build.build_database(fa, mp, jcfg, do_gg=do_gg)
    got = t_build.build_database(fa, mp, tcfg, do_gg=do_gg)
    _same_build(got, want)
    if do_gg:  # the fold made truncated labels
        assert len(got.labels) > len(set(j_maps.read_tax_map(mp).values()))
    files = {}
    for tag, mod, cfg, res in (("j", j_formats, jcfg, want), ("t", t_formats, tcfg, got)):
        ubt, ctr = tmp_path / f"{tag}.ubt", tmp_path / f"{tag}.ctr"
        mod.write_ubt(str(ubt), res.words, res.ixs, res.labels.strings, cfg)
        mod.write_ctr_from_ubt(str(ubt), str(ctr), cfg)
        files[tag] = (ubt.read_bytes(), ctr.read_bytes())
    assert files["t"] == files["j"]
    for tag in ("j", "t"):
        ju, tu = (mod.read_ubt(str(tmp_path / f"{tag}.ubt")) for mod in (j_formats, t_formats))
        assert (tu.wtype_bytes, tu.ixtype_bytes, tu.labels) == (ju.wtype_bytes, ju.ixtype_bytes,
                                                               ju.labels)
        for field in ("words", "ixs", "counts"):
            assert np.array_equal(getattr(tu, field), getattr(ju, field))
        jc = j_formats.read_ctr(str(tmp_path / f"{tag}.ctr"), jcfg)
        tc = t_formats.read_ctr(str(tmp_path / f"{tag}.ctr"), tcfg)
        for field in ("bin_ix", "suffixes", "ixs", "counts"):
            assert np.array_equal(getattr(tc, field), getattr(jc, field))
    assert np.array_equal(tu.words, got.words)


def test_do_gg_false_drops_conflicted_words(refs):
    """The rank-specific build keeps no conflicted word: none of those the GG
    build gave a truncated label, and no truncated label."""
    fa, mp = str(refs / "refs.fa"), str(refs / "tax.map")
    gg = t_build.build_database(fa, mp, TConfig())
    rs = t_build.build_database(fa, mp, TConfig(), do_gg=False)
    assert rs.num_conflicted == gg.num_conflicted > 0
    assert rs.labels.strings == list(dict.fromkeys(t_maps.read_tax_map(mp).values()))
    assert np.isin(rs.words, gg.words).all() and len(rs.words) < len(gg.words)
    # some conflicted words went BAD in the GG build too
    assert len(gg.words) < len(rs.words) + rs.num_conflicted
    own = set(rs.labels.strings)
    truncated = np.array([s not in own for s in gg.labels.strings])
    folded = gg.words[truncated[gg.ixs]]
    assert len(folded) and not np.isin(folded, rs.words).any()


# ---- streaming build and compress -----------------------------------------

# tests/test_build_stream.py's five cases: (complevel, do_gg, packsize,
# chunk_words, partition_bits, make_toy_db's num_refs, ref_len, seed)
_STREAM_CASES = {
    "c1": (1, True, 32, 1 << 12, 3, 12, 2500, 202),
    "c2": (2, True, 32, 997, 5, 12, 2500, 203),
    "c0": (0, True, 32, 1 << 20, 2, 12, 2500, 201),
    "no-gg": (1, False, 32, 2048, 4, 8, 1500, 209),
    "k64": (1, True, 64, 4096, 4, 8, 2000, 213),
}


@pytest.mark.parametrize("case", list(_STREAM_CASES))
def test_streaming_equals_memory_and_jax(tmp_path, case):
    """The port's streaming .ubt and .ctr equal its in-memory files and
    utree_tpu's streaming files; its spill files are gone afterwards."""
    cl, gg, k, chunk, pbits, nref, rlen, seed = _STREAM_CASES[case]
    fa, mp = str(tmp_path / "refs.fa"), str(tmp_path / "tax.map")
    make_toy_db(fa, mp, num_refs=nref, ref_len=rlen, seed=seed)
    ixb = 4 if k == 64 else 2
    tcfg = TConfig(packsize=k, complevel=cl, ixtype_bytes=ixb)
    jcfg = JConfig(packsize=k, complevel=cl, ixtype_bytes=ixb)
    res = t_build.build_database(fa, mp, tcfg, do_gg=gg)
    t_formats.write_ubt(str(tmp_path / "mem.ubt"), res.words, res.ixs, res.labels.strings, tcfg)
    t_formats.write_ctr_from_ubt(str(tmp_path / "mem.ubt"), str(tmp_path / "mem.ctr"), tcfg)
    spill = tmp_path / "spill"
    spill.mkdir()
    for tag, mod, cfg in (("t", t_stream, tcfg), ("j", j_stream, jcfg)):
        stats = mod.build_database_streaming(
            fa, mp, cfg, str(tmp_path / f"{tag}.ubt"), do_gg=gg, chunk_words=chunk,
            partition_bits=pbits, workdir=str(spill))
        mod.write_ctr_streaming(str(tmp_path / f"{tag}.ubt"), str(tmp_path / f"{tag}.ctr"),
                                cfg, chunk_records=1 << 10)
        assert (stats.num_seqs, stats.num_nodes, stats.num_conflicted, stats.num_labels) == (
            res.num_seqs, len(res.words), res.num_conflicted, len(res.labels))
        assert stats.labels.strings == res.labels.strings
        assert not any(spill.iterdir())
    for ext in ("ubt", "ctr"):
        mem = (tmp_path / f"mem.{ext}").read_bytes()
        assert (tmp_path / f"t.{ext}").read_bytes() == mem
        assert (tmp_path / f"j.{ext}").read_bytes() == mem


# ---- the CLI --------------------------------------------------------------


@pytest.mark.parametrize("rank_specific", [False, True], ids=["gg", "rank-specific"])
@pytest.mark.parametrize("complevel", [1, 2])
def test_cli_build_compress_search_equal_jax(refs, tmp_path, capsys, complevel, rank_specific):
    """build then compress through both CLIs, in process: the .ubt, .ctr
    and log bytes are equal; the port's `search --rc --device cpu` on its DB
    writes the bytes of utree_tpu's `search --rc --host` on its own."""
    flags = ["--complevel", str(complevel)] + (["--rank-specific"] if rank_specific else [])
    log = ".log" if rank_specific else ".gg.log"
    out = {}
    for tag, main in (("j", j_cli.main), ("t", t_cli.main)):
        ubt, ctr = str(tmp_path / f"{tag}.ubt"), str(tmp_path / f"{tag}.ctr")
        main(["build", str(refs / "refs.fa"), str(refs / "tax.map"), ubt, *flags])
        main(["compress", ubt, ctr])
        out[tag] = [(tmp_path / f"{tag}{ext}").read_bytes() for ext in (".ubt", ".ctr", ".ubt" + log)]
    assert out["t"] == out["j"]
    assert out["t"][2].count(b"\n") == len(out["t"][2].splitlines()) > 0
    printed = capsys.readouterr().out.splitlines()
    assert printed[0].startswith("Built ") and printed[0].replace("j.ubt", "t.ubt") == printed[2]
    j_cli.main(["search", str(tmp_path / "j.ctr"), str(refs / "reads.fa"),
                str(tmp_path / "j.txt"), "--rc", "--host"])
    t_cli.main(["search", str(tmp_path / "t.ctr"), str(refs / "reads.fa"),
                str(tmp_path / "t.txt"), "--rc", "--device", "cpu"])
    want = (tmp_path / "j.txt").read_bytes()
    assert (tmp_path / "t.txt").read_bytes() == want and want.count(b"\n") > 100


def test_cli_search_profile_dir(refs, tmp_path, capsys):
    """--profile-dir writes a Chrome trace (parseable JSON of trace events)
    under the directory, and the output bytes are those without it."""
    ubt, ctr = str(tmp_path / "db.ubt"), str(tmp_path / "db.ctr")
    t_cli.main(["build", str(refs / "refs.fa"), str(refs / "tax.map"), ubt])
    t_cli.main(["compress", ubt, ctr])
    prof = tmp_path / "prof"
    base = ["search", ctr, str(refs / "reads.fa")]
    t_cli.main([*base, str(tmp_path / "plain.txt"), "--rc", "--device", "cpu"])
    t_cli.main([*base, str(tmp_path / "traced.txt"), "--rc", "--device", "cpu",
                "--profile-dir", str(prof), "--trace"])
    assert (tmp_path / "traced.txt").read_bytes() == (tmp_path / "plain.txt").read_bytes()
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert len(events) > 10 and not kernel_names(str(traces[0]))  # the CPU: no kernels
    assert f"profile: {traces[0]}" in capsys.readouterr().out
    # the host search ignores it, as utree_tpu's does
    t_cli.main([*base, str(tmp_path / "host.txt"), "--rc", "--host",
                "--profile-dir", str(tmp_path / "prof_host")])
    assert not (tmp_path / "prof_host").exists()
    assert (tmp_path / "host.txt").read_bytes() == (tmp_path / "plain.txt").read_bytes()


def test_tracer_without_kernels_on_a_card_raises(tmp_path):
    """A trace of a CUDA device that recorded no kernel (here: no card, so
    torch.profiler drops its CUDA activity) raises and leaves no file; it
    never writes a trace without the kernels.  Tracer(None) does nothing."""
    with pytest.raises(RuntimeError, match="no CUDA kernel"):
        with Tracer(str(tmp_path / "prof"), "cuda"):
            torch.ones(8).add_(1)
    assert not list((tmp_path / "prof").iterdir())
    with Tracer(None, "cuda") as tr:
        torch.ones(8).add_(1)
    assert tr.path is None and not (tmp_path / "none").exists()
