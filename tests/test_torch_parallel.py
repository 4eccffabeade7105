"""The port's data-parallel search (SearchPipeline(devices=N) without
`routed`: the table replicated on N shards, the batch rows split over them)
against utree_tpu's mesh mode on the 8 virtual CPU devices of
tests/conftest.py, byte for byte, and the CLI's --devices and --lookup-mode
routed.  The DB comes from make_toy_db -> build_database ->
DeviceIndexArrays.from_build; the port gets its copy through
convert.index_from_jax."""

import numpy as np
import pytest

from utree_tpu.build import build_database
from utree_tpu.config import UTreeConfig
from utree_tpu.formats import write_ctr_from_ubt, write_ubt
from utree_tpu.index import DeviceIndexArrays
from utree_tpu.pipeline import SearchPipeline as JaxPipeline
from utree_tpu.testdata import make_toy_db, make_toy_reads
from utree_tpu_torch.convert import index_from_jax
from utree_tpu_torch.pipeline import SearchPipeline

BATCH = 96


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    wd = tmp_path_factory.mktemp("dp")
    recs = make_toy_db(str(wd / "refs.fa"), str(wd / "tax.map"), seed=83, num_refs=12)
    make_toy_reads(str(wd / "reads.fa"), recs, num_reads=400, seed=89)
    # chimeras of three refs (over a hist_cap of 2: the host replay) and one
    # long read (chunked; its chunk count pads to the shard count)
    rng = np.random.default_rng(97)
    with open(wd / "reads.fa", "ab") as f:
        for i in range(30):
            parts = []
            for r in rng.choice(len(recs), 3, replace=False):
                s = int(rng.integers(0, len(recs[r][2]) - 50))
                parts.append(recs[r][2][s:s + 50])
            f.write(b">chimera%d\n" % i + b"".join(parts) + b"\n")
        f.write(b">long0\n" + b"".join(recs[int(r)][2][:3500]
                                      for r in rng.choice(len(recs), 5)) + b"\n")
    cfg = UTreeConfig()
    res = build_database(str(wd / "refs.fa"), str(wd / "tax.map"), cfg)
    index = DeviceIndexArrays.from_build(res.words, res.ixs, res.labels.strings, cfg)
    write_ubt(str(wd / "db.ubt"), res.words, res.ixs, res.labels.strings, cfg)
    write_ctr_from_ubt(str(wd / "db.ubt"), str(wd / "db.ctr"), cfg)
    # the same words under 70,000 labels (IXTYPE=u32): the unpacked rows
    strings = list(res.labels.strings) + [b"pad%d" % i for i in range(70_000)]
    wide = DeviceIndexArrays.from_build(res.words, res.ixs, strings,
                                        UTreeConfig(ixtype_bytes=4))
    return {"dir": wd, "index": index, "port": index_from_jax(index), "wide": wide,
            "wide_port": index_from_jax(wide), "reads": str(wd / "reads.fa"),
            "ctr": str(wd / "db.ctr")}


@pytest.mark.parametrize("devices", [2, 4])
@pytest.mark.parametrize("mode,kw", [
    ("displaced", {}), ("canonical", {}), ("bsearch", {}),
    ("displaced", {"support_ranges": 8}), ("displaced", {"wide": True}),
], ids=["displaced", "ladder", "bsearch", "support8", "wide"])
def test_data_parallel_equals_jax(db, tmp_path, devices, mode, kw):
    kw = dict(kw)
    wide = kw.pop("wide", False)
    index, port = (db["wide"], db["wide_port"]) if wide else (db["index"], db["port"])
    common = dict(do_rc=True, batch_size=BATCH, hist_cap=2, lookup_mode=mode,
                  devices=devices, **kw)
    jax_out, port_out = tmp_path / "jax.txt", tmp_path / "port.txt"
    jp = JaxPipeline(index, **common)
    jp.search_file(db["reads"], str(jax_out))
    pipe = SearchPipeline(port, device="cpu", **common)
    want_layout = ("unpacked" if wide else "packed" if kw else "vote")
    assert pipe.table_kind == jp.table_kind and pipe.layout == want_layout
    assert len(pipe._tables) == devices and {d.type for d in pipe._mesh.devices} == {"cpu"}
    pipe.search_file(db["reads"], str(port_out))
    assert port_out.read_bytes() == jax_out.read_bytes()
    assert jax_out.read_bytes().count(b"\n") > 250 and b"long0\t" in jax_out.read_bytes()


def test_devices_one_is_the_single_device_path(db):
    pipe = SearchPipeline(db["port"], device="cpu", batch_size=BATCH, devices=1)
    assert pipe._mesh.size == 1 and pipe.layout == "vote"


@pytest.mark.parametrize("args", [["--devices", "2"],
                                  ["--devices", "4", "--lookup-mode", "routed"]],
                         ids=["devices", "routed"])
def test_cli_devices_equals_jax_cli(db, tmp_path, capsys, args):
    from utree_tpu.cli import main as jax_main
    from utree_tpu_torch.cli import main

    jax_out, port_out = tmp_path / "jax.txt", tmp_path / "port.txt"
    common = ["--rc", "--batch", str(BATCH), *args]
    jax_main(["search", db["ctr"], db["reads"], str(jax_out), *common])
    main(["search", db["ctr"], db["reads"], str(port_out), *common, "--device", "cpu",
          "--trace"])
    out = capsys.readouterr().out
    assert port_out.read_bytes() == jax_out.read_bytes()
    kind = "routed-displaced" if "routed" in args else "canonical"
    assert f"table_kind: {kind}" in out
