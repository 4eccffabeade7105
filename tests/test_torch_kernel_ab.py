"""kernel_ab.py's call list, on the CPU: each timed call is one entry of
`kernel_ab._calls` beside the input group it reads, `groups` makes exactly
the groups the calls that `--only` selects read, and the yardsticks' rows
are the rows the plain probes read; `--e2e` runs each tree's passes on its
own modules."""

import pathlib

import pytest
import torch

import chip_smoke as cs
import kernel_ab

CALLS = {name: group for group, name, _ in kernel_ab._calls(None, None)}


@pytest.mark.parametrize("name,group", [
    ("hash_probe main", "tier"),
    ("hash_probe rows by index_select", "tier"),
    ("scan_probe64 main", "k64"),
    ("scan_probe64 rows by index_select", "k64"),
    ("ladder_probe64 main", "k64"),
    ("ladder_probe64 rows by index_select", "k64"),
    ("bsearch_probe main", "tier"),
    ("scan_probe main", "tables"),
    ("ladder_probe_wide main", "wide"),
    ("bsearch_probe_shard (2, 4) slice 0", "tier"),
    ("bsearch_probe_shard (1, 8) slice 0", "tier"),
    ("xtree_probe main", "xtree"),
    ("xtree_probe rows by index_select", "xtree"),
    ("owner_probe narrow", "routed"),
    ("owner_probe wide", "routed"),
    ("canonical_owner_probe narrow", "routed"),
    ("canonical_owner_probe wide", "routed"),
    ("owner_probe narrow rows by index_select", "routed"),
    ("canonical_owner_probe wide rows by index_select", "routed"),
    ("aufbau_vote main", "vote"),
    ("hist_compact main", "vote"),
    ("hist_compact B=1024", "vote"),
])
def test_each_call_beside_its_input_group(name, group):
    assert CALLS[name] == group


def test_call_names_are_unique():
    names = [name for _, name, _ in kernel_ab._calls(None, None)]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("only,want", [
    ("hash_probe", {"tier"}),
    ("scan_probe64", {"k64"}),
    ("scan_probe64|hash_probe", {"tier", "k64"}),
    ("probe64", {"k64"}),
    ("^(scan|ladder)_probe ", {"tables", "tier"}),
    ("_wide", {"wide"}),
    ("bsearch", {"tier"}),
    ("xtree", {"xtree"}),
    ("xtree_probe|bsearch_probe_shard", {"xtree", "tier"}),
    ("owner_probe", {"routed"}),
    ("^owner_probe", {"routed"}),
    ("owner_probe|route_displaced", {"routed", "tables", "tier"}),
    ("aufbau_vote|hist_compact", {"vote"}),
    ("hist_compact", {"vote"}),
])
def test_groups_of_a_selection(only, want):
    assert kernel_ab.groups(only) == want


@pytest.fixture(scope="module")
def small_inputs(tmp_path_factory):
    """The 'tier' and 'k64' groups at 60,000 k-mers and 256 reads, on the
    CPU."""
    batch = cs.BATCH
    cs.BATCH = 256
    try:
        path = tmp_path_factory.mktemp("ab") / "inputs.pt"
        note = kernel_ab._inputs(path, torch.device("cpu"), {"tier", "k64"}, kmers=60_000)
    finally:
        cs.BATCH = batch
    return torch.load(path), note


def test_inputs_line_names_the_k10_and_k5_tables(small_inputs):
    _, note = small_inputs
    assert "K10: t1/t2 built and placed" in note and "missing t1" in note
    assert "K5's seed table d64_s" in note and "the card's 50 MB L2" in note


def test_yardstick_rows_are_the_probed_rows(small_inputs):
    """Every word the plain K10 finds in t1 has its key in the row the t1
    yardstick gathers; every window the plain K5 finds in d64_1 has its
    key in the row the d64_1 yardstick gathers."""
    from utree_tpu_torch import lookup as lk
    from utree_tpu_torch._u32 import i32

    inp, _ = small_inputs
    dev = torch.device("cpu")
    calls = {name: make() for group, name, make in kernel_ab._calls(inp, dev)
             if name.startswith(("hash_probe", "scan_probe64"))}
    # K10: the rows of the valid words, forward then RC
    t1 = inp["hash"]["t1"]
    rows = calls["hash_probe rows by index_select"]()
    packed, vbits, lens = inp["batch"]
    p, v = lk._trim(packed, vbits, kernel_ab.TRUE_LEN)
    qpre, qhi, qlo, valid = lk.extract_windows(lk.base_codes_packed(p, v, lens))
    words = torch.cat([torch.stack([i32(lo), i32((pre << 8) | hi)], -1)[valid]
                       for pre, hi, lo in ((qpre, qhi, qlo), lk.rc_word_lanes(qpre, qhi, qlo))])
    assert rows.shape == (words.shape[0], t1.shape[1])
    slots = rows.view(-1, 8, 3)
    held = ((slots[..., 0] == words[:, None, 0]) & (slots[..., 1] == words[:, None, 1])
            & (slots[..., 2] >= 0)).any(1)
    t1_only = {"t1": t1, "t2": torch.full((8, 24), -1, dtype=torch.int32)}
    ids = lk.window_ids_plain(t1_only, packed, vbits, lens, do_rc=True, bad_ix=0xFFFF,
                              num_labels=inp["num_labels"], true_len=kernel_ab.TRUE_LEN)
    found = torch.cat([ids[:, :ids.shape[1] // 2][valid], ids[:, ids.shape[1] // 2:][valid]])
    assert int(held.sum()) == int((found != 0xFFFF).sum()) > 100
    # K5: the d64_1 rows of the valid windows
    k64 = inp["k64"]
    d64 = calls["scan_probe64 rows by index_select"]()
    k0, k1, k2, k3, valid64 = lk.extract_windows64(lk.base_codes(k64["reads"], k64["lens"]))
    *c, _ = lk.canonicalize64(k0, k1, k2, k3)
    keys = torch.stack([i32(x) for x in c], -1)[valid64]
    assert d64.shape == (keys.shape[0], 12)
    slots64 = d64.view(-1, 2, 6)
    in_row = ((slots64[..., :4] == keys[:, None]).all(-1)
              & ((slots64[..., 4] | slots64[..., 5]) != 0)).any(1)
    disp = k64["displaced64"]
    no_tail = dict(disp, d64_3=torch.zeros((8, 12), dtype=torch.int32))
    ids64 = lk.window_ids64_plain(no_tail, k64["reads"], k64["lens"], do_rc=True,
                                  bad_ix=0x7FFFFFFF)
    w = ids64.shape[1] // 2
    hit = ((ids64[:, :w] != 0x7FFFFFFF) | (ids64[:, w:] != 0x7FFFFFFF))[valid64]
    assert bool((in_row == hit).all()) and int(hit.sum()) > 100


@pytest.fixture(scope="module")
def routed_inputs(tmp_path_factory):
    """The 'routed' group at 60,000 k-mers (both tiers) and 256 reads, on
    the CPU."""
    saved = cs.BATCH, cs.WIDE_DISPLACED_KMERS
    cs.BATCH, cs.WIDE_DISPLACED_KMERS = 256, 60_000
    try:
        path = tmp_path_factory.mktemp("ab") / "inputs.pt"
        note = kernel_ab._inputs(path, torch.device("cpu"), {"routed"}, kmers=60_000)
    finally:
        cs.BATCH, cs.WIDE_DISPLACED_KMERS = saved
    return torch.load(path), note


def test_owner_buffer_is_the_steps_receive_buffer(routed_inputs):
    """Owner 0's buffer holds four senders' blocks of the step's capacity,
    each its written lanes and then K11's zeroed tail; the inputs line
    counts both."""
    inp, note = routed_inputs
    assert "K12/K17: owner 0's receive buffer" in note and "unwritten" in note
    for key, r in inp["routed"].items():
        lanes, c = r["lanes"], r["capacity"]
        assert lanes.shape == (cs.ROUTED_SHARDS * c, 3)
        blocks = lanes.view(cs.ROUTED_SHARDS, c, 3)
        used = (blocks != 0).any(-1)
        counts = used.sum(1)
        # each block's written lanes come first, its tail is all zero
        assert bool((used == (torch.arange(c) < counts[:, None])).all()), key
        assert r["written"] == int(counts.sum()) and r["written"] + r["unwritten"] == len(lanes)
        assert 0 < r["written"] < len(lanes)


@pytest.mark.parametrize("key", ["narrow owner_probe", "wide owner_probe",
                                 "narrow canonical_owner_probe",
                                 "wide canonical_owner_probe"])
def test_owner_yardstick_rows_are_the_probed_rows(routed_inputs, key):
    """The owner probe finds a written lane's key exactly where its
    yardstick row holds that key with a non-zero value."""
    inp, _ = routed_inputs
    dev = torch.device("cpu")
    kind = key.split()[1]
    width = key.split()[0]
    calls = {name: make() for group, name, make in kernel_ab._calls(inp, dev)
             if name.startswith(f"{kind} {width}")}
    vals = calls[f"{kind} {width}"]()
    rows = calls[f"{kind} {width} rows by index_select"]()
    r = inp["routed"][key]
    lanes = r["lanes"]
    written = (lanes.view(cs.ROUTED_SHARDS, r["capacity"], 3) != 0).any(-1).reshape(-1)
    cps = 4 if width == "wide" else 3
    slots = rows.view(rows.shape[0], -1, cps)
    keys = lanes[written, 1:]
    in_row = ((slots[..., 0] == keys[:, None, 0]) & (slots[..., 1] == keys[:, None, 1])
              & (slots[..., 2:] != 0).any(-1)).any(1)
    hit = (vals.reshape(len(lanes), -1) != 0).any(1)[written]
    assert rows.shape[0] == int(written.sum())
    assert bool((in_row == hit).all()) and int(hit.sum()) > 100


@pytest.fixture(scope="module")
def vote_inputs(tmp_path_factory):
    """The 'vote' group at 60,000 k-mers and 256 reads, on the CPU (its
    displaced table cached in a scratch directory)."""
    saved = cs.BATCH, kernel_ab.ROOT
    cs.BATCH, kernel_ab.ROOT = 256, tmp_path_factory.mktemp("root")
    try:
        path = tmp_path_factory.mktemp("ab") / "inputs.pt"
        note = kernel_ab._inputs(path, torch.device("cpu"), {"vote"}, kmers=60_000)
        calls = {name: make() for group, name, make in
                 kernel_ab._calls(torch.load(path), torch.device("cpu")) if group == "vote"}
    finally:
        cs.BATCH, kernel_ab.ROOT = saved
    return torch.load(path), note, calls


def test_vote_calls_are_the_main_paths_k3_and_k8(vote_inputs):
    """K3's call votes phase 3's histograms with the pipeline's max_iters,
    K8's compact phase 11's packed rows of the same ids at over_cap B/8
    and their first 1024 rows at 64; the inputs line counts the reads of
    two or more labels and those that walk."""
    from utree_tpu_torch.classify_device import aufbau_walk, pack_vote
    from utree_tpu_torch.lookup import compact_rows

    inp, note, calls = vote_inputs
    v = inp["vote"]
    labels, counts, nuniq, found = v["hist"]
    assert labels.shape == (256, kernel_ab.HIST_CAP)
    assert "K3/K8: 256 reads, cap 8" in note and "walk" in note
    want = pack_vote(*aufbau_walk(v["tables"], *v["hist"], taxacut=v["taxacut"],
                                  max_iters=v["max_iters"]), nuniq, found)
    assert torch.equal(calls["aufbau_vote main"](), want)
    assert int((nuniq >= 2).sum()) > 0
    rows = v["rows"]
    assert rows.shape == (256, kernel_ab.HIST_CAP + 1)
    # the packed rows are the same histograms' (label+1 | count<<16 slots)
    assert torch.equal((rows[:, -1] & 31), torch.clamp(nuniq, max=kernel_ab.HIST_CAP + 1))
    assert torch.equal(calls["hist_compact main"](), compact_rows(rows, 256 // 8))
    assert torch.equal(calls["hist_compact B=1024"](), compact_rows(rows[:1024], 64))


def _vote_hist(c: int, q: list[int], found_q: list[int]):
    """Eight reads at cap c; the reads in q hit two labels, the rest one."""
    labels = torch.full((8, c), -1, dtype=torch.int32)
    labels[:, 0] = 5
    nuniq, found = torch.ones(8, dtype=torch.int32), torch.ones(8, dtype=torch.int32)
    for r, f in zip(q, found_q):
        nuniq[r], found[r] = 2, f
    return labels, torch.zeros((8, c), dtype=torch.int32), nuniq, found


@pytest.mark.parametrize("c, q, found_q, counts_sectors, walks", [
    (8, [1, 3, 6], [1, 4, 3], 3, True),  # 32 B rows, one sector each
    (8, [1, 3], [1, 1], 2, False),  # no read walks: no walk tables
    (3, [1, 3, 6], [2, 2, 2], 3, True),  # 12 B rows inside a sector each
    (3, [2, 5], [1, 2], 3, True),  # 12 B rows across sector edges, one shared
    (8, [], [], 0, False),  # every read packed from labels[:, 0]
])
def test_vote_bytes_counts_what_k3_reads(c, q, found_q, counts_sectors, walks):
    """K3's bound counts labels, nuniq, found and the rows in full, but of
    the counts rows and the rank table only what the reads of two or more
    labels touch, and the walk's tables only where a read walks."""
    labels, counts, nuniq, found = _vote_hist(c, q, found_q)
    for i, r in enumerate(q):  # ranks at bytes 0, 36 and 252 (clamped)
        labels[r, 1] = (0, 9, 100)[i % 3]
    vt = {"rank": torch.zeros(64, dtype=torch.int32), "st": torch.zeros((6, 64), dtype=torch.int32),
          "slen": torch.zeros(64, dtype=torch.int32), "semi": torch.zeros((64, 3), dtype=torch.int32),
          "und": torch.zeros((64, 3), dtype=torch.int32), "spos": torch.zeros((64, 4), dtype=torch.int32)}
    rows = torch.zeros((8, 3), dtype=torch.int32)
    # labels 5 (byte 20, sector 0) and the second labels above
    rank_sectors = len({0} | {(0, 1, 7)[i % 3] for i in range(len(q))}) if q else 0
    want = cs.nbytes(labels, nuniq, found, rows) + cs.SECTOR * (counts_sectors + rank_sectors)
    if walks:
        want += cs.nbytes(*(vt[k] for k in ("st", "slen", "semi", "und", "spos")))
    assert cs.vote_bytes((labels, counts, nuniq, found), vt, rows) == want


def test_e2e_passes_run_in_turn_on_each_trees_modules(tmp_path):
    """--e2e on two runs of this checkout, one round of the displaced,
    bsearch and support-8 passes each, at 60,000 k-mers and 512 reads in
    batches of 256: every pass reads all its reads on its tree's own
    modules, and the modules the test started with are back in place after."""
    import sys

    import utree_tpu_torch.pipeline  # noqa: F401  (the modules the run must put back)

    root = pathlib.Path(kernel_ab.__file__).resolve().parent
    before = kernel_ab._modules()
    saved = cs.BATCH, kernel_ab.ROOT
    cs.BATCH, kernel_ab.ROOT = 256, tmp_path
    try:
        res = kernel_ab.e2e_run(torch.device("cpu"), [root, root], 1, 60_000, 512,
                                tmp_path / "work")
        loaded = kernel_ab._modules()
    finally:
        cs.BATCH, kernel_ab.ROOT = saved
        for k in kernel_ab._modules():
            del sys.modules[k]
        sys.modules.update(before)
    assert [r["tree"] for r in res] == [str(root)] * 2
    for r in res:
        assert set(r["passes"]) == set(kernel_ab.E2E_PASSES)
        for p in r["passes"].values():
            assert len(p["reads_per_s"]) == 1 and p["median"] == p["best"] > 0
            assert "scan" in p["phase_median"]
    assert loaded["utree_tpu_torch"] is not before["utree_tpu_torch"]
    assert pathlib.Path(loaded["utree_tpu_torch"].__file__).parent.parent == root
    outs = sorted((tmp_path / "work").glob("e2e_ab_*.txt"))
    assert len(outs) == 6 and outs[0].stat().st_size > 0


def test_e2e_compare_pairs_each_rounds_runs_in_order():
    """Runs A B B A: A's first run pairs with B's first, A's second with
    B's second, round by round; medians and quartiles pool each tree."""
    def run(tree, rates):
        return {"tree": tree, "passes": {p: {"reads_per_s": rates} for p in kernel_ab.E2E_PASSES}}

    res = [run("a", [10.0, 20.0]), run("b", [11.0, 19.0]), run("b", [12.0, 25.0]),
           run("a", [13.0, 21.0])]
    lines = kernel_ab.e2e_compare(res)
    assert len(lines) == len(kernel_ab.E2E_PASSES)
    # pairs (10, 11), (20, 19), (13, 12), (21, 25): b faster in 2 of 4;
    # medians 16.5 and 15.5
    assert "a median 16 (quartiles 11-21); b median 16 (quartiles 11-24)" in lines[0]
    assert "faster in 2 of 4 pairs, median -6.1%" in lines[0]
    assert kernel_ab.e2e_compare(res[:2] + [run("c", [1.0, 1.0])]) == []
