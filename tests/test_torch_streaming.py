"""The port's streamed ingestion (`SearchPipeline._iter_fasta_pieces`: the
read file in pieces cut at record boundaries, batches accumulated across
them) against utree_tpu.pipeline, on the CPU: the mirror of
tests/test_streaming.py on a make_toy_db DB and reads of more than 64 KiB,
so the 64 KiB floor of `stream_chunk_bytes` still makes several pieces.
classifications.txt must match byte for byte: tiny pieces, a record longer
than a piece, a .gz read file, and a resume that crosses pieces."""

import gzip

import numpy as np
import pytest

from utree_tpu.build import build_database
from utree_tpu.config import UTreeConfig
from utree_tpu.index import DeviceIndexArrays
from utree_tpu.pipeline import SearchPipeline as JaxPipeline
from utree_tpu.testdata import make_toy_db, make_toy_reads
from utree_tpu_torch.convert import index_from_jax
from utree_tpu_torch.pipeline import SearchPipeline
from utree_tpu_torch.utils.checkpoint import SearchCheckpoint

NREADS = 1000


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The DB, 1000 reads of 150 bp (about 160 KB: three pieces at the
    floor), a file with a 301 kbp record between the first and the last 500
    of those reads, and the JAX pipeline's bytes for each at its default
    piece size."""
    wd = tmp_path_factory.mktemp("stream")
    recs = make_toy_db(str(wd / "refs.fa"), str(wd / "tax.map"), seed=107, num_refs=10)
    make_toy_reads(str(wd / "reads.fa"), recs, num_reads=NREADS, seed=109)
    assert (wd / "reads.fa").stat().st_size > 2 * (1 << 16)
    rng = np.random.default_rng(4)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    shorts = (wd / "reads.fa").read_bytes().split(b">")[1:]
    genomic = b"".join(r.split(b"\n")[1] for r in shorts[:8])
    with open(wd / "mix.fa", "wb") as f:
        f.write(b">" + b">".join(shorts[:500]))
        f.write(b">big first\n" + rng.choice(acgt, 300_000).tobytes() + genomic + b"\n")
        for i in range(10):
            s = recs[i % len(recs)][2]
            f.write(b">r%d\n" % i + s[100 * i:100 * i + 120] + b"\n")
        f.write(b">" + b">".join(shorts[500:]))
    cfg = UTreeConfig()
    res = build_database(str(wd / "refs.fa"), str(wd / "tax.map"), cfg)
    index = DeviceIndexArrays.from_build(res.words, res.ixs, res.labels.strings, cfg)
    want = {}
    for reads, batch in (("reads.fa", 128), ("mix.fa", 16)):
        jp = JaxPipeline(index, do_rc=True, batch_size=batch)
        jp.search_file(str(wd / reads), str(wd / f"jax_{reads}.txt"))
        want[reads] = (wd / f"jax_{reads}.txt").read_bytes()
    return {"dir": wd, "port": index_from_jax(index), "want": want}


def _pipe(env, batch_size=128, chunk=1):
    pipe = SearchPipeline(env["port"], device="cpu", do_rc=True, batch_size=batch_size)
    pipe.stream_chunk_bytes = chunk
    pieces = []
    orig = pipe._iter_fasta_pieces

    def counted(*a):
        for sc in orig(*a):
            pieces.append(sc.num_records)
            yield sc

    pipe._iter_fasta_pieces = counted
    return pipe, pieces


def test_tiny_chunks_identical(env, tmp_path):
    """stream_chunk_bytes=1 (the 64 KiB floor): several pieces, each cut at
    a record boundary, batches spanning them; the bytes of the JAX pipeline
    and of the port's own single-piece run."""
    pipe, pieces = _pipe(env)
    out = tmp_path / "chunked.txt"
    assert pipe.search_file(str(env["dir"] / "reads.fa"), str(out)) == NREADS
    assert len(pieces) >= 3 and sum(pieces) == NREADS
    whole, one = _pipe(env, chunk=32 << 20)
    whole.search_file(str(env["dir"] / "reads.fa"), str(tmp_path / "whole.txt"))
    assert one == [NREADS]
    want = env["want"]["reads.fa"]
    assert out.read_bytes() == (tmp_path / "whole.txt").read_bytes() == want
    assert want.count(b"\n") > 500


def test_record_larger_than_chunk(env, tmp_path):
    """A 301 kbp record mid-file: the tail grows past the 64 KiB piece
    until the record ends; the record is a long read (chunked histograms),
    and the lines stay in read order around it."""
    pipe, pieces = _pipe(env, batch_size=16)
    out = tmp_path / "chunked.txt"
    assert pipe.search_file(str(env["dir"] / "mix.fa"), str(out)) == NREADS + 11
    assert len(pieces) >= 3 and sum(pieces) == NREADS + 11
    want = env["want"]["mix.fa"]
    assert out.read_bytes() == want and b"\nbig\t" in want


def test_gz_input_identical(env, tmp_path):
    """A .gz read file streams through zlib in pieces: the plain file's
    bytes."""
    gz = tmp_path / "reads.fa.gz"
    with gzip.open(gz, "wb") as f:
        f.write((env["dir"] / "reads.fa").read_bytes())
    pipe, pieces = _pipe(env, chunk=1 << 16)
    out = tmp_path / "gz.txt"
    assert pipe.search_file(str(gz), str(out)) == NREADS
    assert len(pieces) >= 3
    assert out.read_bytes() == env["want"]["reads.fa"]


def test_resume_across_pieces(env, tmp_path, monkeypatch):
    """A run interrupted at its fifth checkpoint commit (batches of 64, so
    mid-file and past a piece boundary), resumed with the same pieces: the
    uninterrupted bytes."""
    out = tmp_path / "resumed.txt"
    calls = []
    orig = SearchCheckpoint.commit

    class Boom(RuntimeError):
        pass

    def bomb(self, done, tell):
        orig(self, done, tell)
        calls.append(done)
        if len(calls) == 5:
            raise Boom()

    monkeypatch.setattr(SearchCheckpoint, "commit", bomb)
    pipe, _ = _pipe(env, batch_size=64)
    with pytest.raises(Boom):
        pipe.search_file(str(env["dir"] / "reads.fa"), str(out))
    monkeypatch.setattr(SearchCheckpoint, "commit", orig)
    assert calls[-1] == 5 * 64 and (tmp_path / "resumed.txt.ckpt").exists()
    pipe2, pieces = _pipe(env, batch_size=64)
    assert pipe2.search_file(str(env["dir"] / "reads.fa"), str(out), resume=True) == NREADS
    assert len(pieces) >= 3
    assert out.read_bytes() == env["want"]["reads.fa"]
