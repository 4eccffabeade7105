"""The port's multi-host driver (utree_tpu_torch.parallel.distributed)
against utree_tpu's: two processes in a gloo process group on 127.0.0.1,
each searching its range of the reads through the port's CLI, write the
JAX pipeline's one-host bytes; the helpers equal utree_tpu's.  The DB comes
from make_toy_db -> build_database (no oracle)."""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

from utree_tpu.build import build_database
from utree_tpu.config import UTreeConfig
from utree_tpu.formats import write_ctr_from_ubt, write_ubt
from utree_tpu.index import DeviceIndexArrays
from utree_tpu.parallel import distributed as JD
from utree_tpu.pipeline import SearchPipeline as JaxPipeline
from utree_tpu.testdata import make_toy_db, make_toy_reads
from utree_tpu_torch.parallel import distributed as TD

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    wd = tmp_path_factory.mktemp("mh")
    recs = make_toy_db(str(wd / "refs.fa"), str(wd / "tax.map"), seed=101, num_refs=10)
    make_toy_reads(str(wd / "reads.fa"), recs, num_reads=701, seed=103)
    cfg = UTreeConfig()
    res = build_database(str(wd / "refs.fa"), str(wd / "tax.map"), cfg)
    write_ubt(str(wd / "db.ubt"), res.words, res.ixs, res.labels.strings, cfg)
    write_ctr_from_ubt(str(wd / "db.ubt"), str(wd / "db.ctr"), cfg)
    single = wd / "single.txt"
    JaxPipeline(DeviceIndexArrays.from_ctr(str(wd / "db.ctr")), do_rc=True,
                batch_size=128).search_file(str(wd / "reads.fa"), str(single))
    return {"dir": wd, "ctr": str(wd / "db.ctr"), "reads": str(wd / "reads.fa"),
            "single": single.read_bytes()}


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_processes_write_the_one_host_bytes(db, tmp_path):
    out = tmp_path / "merged.txt"
    port = _free_port()
    cmd = [sys.executable, "-m", "utree_tpu_torch.cli", "search", db["ctr"], db["reads"],
           str(out), "--rc", "--batch", "128", "--device", "cpu", "--num-hosts", "2",
           "--coordinator", f"127.0.0.1:{port}", "--host-id"]
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    procs = [subprocess.Popen(cmd + [str(h)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for h in range(2)]
    outs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=300)
            assert p.returncode == 0, e.decode()
            outs.append(o.decode())
    finally:
        for p in procs:
            p.kill()
    assert out.read_bytes() == db["single"]
    lines = db["single"].count(b"\n")
    assert f"multihost: 701 reads searched, {lines} classified across 2 hosts" in outs[0]
    assert "multihost:" not in outs[1]
    assert not list(tmp_path.glob("merged.txt.part*"))


def test_one_host_runs_without_a_process_group(db, tmp_path, capsys):
    from utree_tpu_torch.cli import main

    out = tmp_path / "one.txt"
    main(["search", db["ctr"], db["reads"], str(out), "--rc", "--batch", "128",
          "--device", "cpu", "--num-hosts", "1"])
    assert out.read_bytes() == db["single"]
    assert "across 1 hosts" in capsys.readouterr().out


def test_num_hosts_without_coordinator_exits_as_jax(db, tmp_path):
    from utree_tpu.cli import main as jax_main
    from utree_tpu_torch.cli import main

    args = ["search", db["ctr"], db["reads"], str(tmp_path / "o.txt"), "--num-hosts", "2"]
    msgs = []
    for run in (lambda: jax_main(args), lambda: main(args + ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            run()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "--host-id and --coordinator" in msgs[0]


def test_host_read_range_equals_jax():
    for total in (0, 1, 7, 701, 1000):
        for nh in (1, 2, 3, 8):
            for h in range(nh):
                assert (TD.host_read_range(total, h, nh)
                        == JD.host_read_range(total, h, nh))
    assert TD.host_read_range(701) == (0, 701)  # no process group: one host


def test_count_fasta_records_equals_jax(tmp_path):
    """'\\n>' straddling every chunk boundary, as test_distributed_units.py
    crafts it, and a file with no trailing newline."""
    rec = b">r%d\nACGTACGT\n"
    path = tmp_path / "reads.fa"
    for body in (b"".join(rec % i for i in range(100)), b">a\nAC\n>b\nGT"):
        path.write_bytes(body)
        for cb in list(range(1, 40)) + [64 << 20]:
            got = TD.count_fasta_records(str(path), chunk_bytes=cb)
            assert got == JD.count_fasta_records(str(path), chunk_bytes=cb) == (
                body.count(b"\n>") + 1), cb


def test_merge_sample_tallies_without_a_group_is_the_tally():
    got = TD.merge_sample_tallies(np.array([5, 7], np.int64))
    assert got.dtype == np.int64 and got.tolist() == [5, 7]
