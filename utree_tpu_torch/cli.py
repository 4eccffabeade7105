"""Command line of the port (counterpart of `utree_tpu/cli.py`: build,
compress, search and the xtree tool):

  python -m utree_tpu_torch.cli build <in.fa> <map> <out.ubt>
      [--complevel N] [--rank-specific]
  python -m utree_tpu_torch.cli compress <in.ubt> <out.ctr>
  python -m utree_tpu_torch.cli search <db.ctr> <reads.fa> <out.txt>
      [--rc] [--batch N]
      [--lookup-mode auto|canonical|displaced|bsearch|hash|routed]
      [--devices N] [--num-hosts H --host-id h --coordinator host:port]
      [--support-ranges 1|8] [--host] [--rank-specific] [--resume] [--trace]
      [--profile-dir DIR] [--device cuda|cpu]
  python -m utree_tpu_torch.cli xtree-build --seqs fa --db-out db
      [--map m --comp c --k k]
  python -m utree_tpu_torch.cli xtree-align --db db --seqs q
      [--confidence f --perq-out --ref-out --tax-out --cov-out --orthog-out
       --redistribute --fast-redistribute --shallow-lca]
      [--device [cuda|cpu]] [--host]

`build` writes the .ubt of utree-buildGG (utree-build with
`--rank-specific`) and its label counts to <out.ubt>.gg.log (.log);
`compress` writes the .ctr of utree-compress.  Both run on the host.
`--host` runs the exact host search (`search_host.search_file`) or the
xtree host engine (no device front end); a DB of a PACKSIZE other than 32
or 64 takes the host search too.  `--rank-specific` runs the rank-specific
(non-GG) search on the host (`search_host.search_file_shallow`), as
`utree_tpu` does.  `--devices N` runs N shards from one process (cuda:0..
N-1, or N entries of the CPU): the table replicated and the batch split by
rows, or, with `--lookup-mode routed`, the displaced table sharded by
seed-bucket range.  `--num-hosts H` runs the multi-host driver
(`parallel.distributed.search_file_multihost`): each process searches its
range of the reads, the processes meet in a gloo process group at
`--coordinator`, and host 0 writes the merged output; `--num-hosts 1`
needs no process group.  `--profile-dir DIR` writes a torch.profiler
Chrome trace of the device search (host operators and, on a card, its
kernels) under DIR; the host, rank-specific and multi-host searches ignore
it, as `utree_tpu` does.
"""

from __future__ import annotations

import argparse


def _cmd_build(a):
    from utree_tpu_torch.build import build_database
    from utree_tpu_torch.config import UTreeConfig
    from utree_tpu_torch.formats import label_lines, write_ubt

    cfg = UTreeConfig(complevel=a.complevel)
    res = build_database(a.fasta, a.map, cfg, do_gg=not a.rank_specific)
    write_ubt(a.out, res.words, res.ixs, res.labels.strings, cfg)
    with open(a.out + (".log" if a.rank_specific else ".gg.log"), "wb") as f:
        f.write(label_lines(res.labels.strings, res.label_counts))
    print(f"Built {len(res.words)} k-mers, {len(res.labels)} labels -> {a.out}")


def _cmd_compress(a):
    from utree_tpu_torch.formats import sniff_config, write_ctr_from_ubt

    write_ctr_from_ubt(a.input, a.out, sniff_config(a.input))
    print(f"Compressed {a.input} -> {a.out}")


def _cmd_search(a):
    from utree_tpu_torch.utils import trace

    # the command's phases with the index's and the table's set-up spans and
    # the search's counters, in one record
    with trace.scope() as tm:
        _search(a, tm)


def _search(a, tm):
    from utree_tpu_torch.formats import sniff_config
    from utree_tpu_torch.utils.trace import Tracer

    cfg = sniff_config(a.db)
    if cfg.packsize not in (32, 64) and not a.host and not a.rank_specific:
        # the device window extractor implements the 32/64-mer geometries;
        # small-k DBs (PACKSIZE=16) run the exact host path instead
        print(f"note: PACKSIZE={cfg.packsize} DB -> host search path "
              "(device path implements k=32/64)")
        a.host = True
    if a.rank_specific:
        if a.support_ranges != 1:
            raise SystemExit("--support-ranges applies to the GG vote only "
                             "(the rank-specific output has no SUPPORT;RANGE columns)")
        from utree_tpu_torch.search_host import HostIndex, search_file_shallow

        with tm.phase("load-db"):
            idx = HostIndex.from_ctr(a.db, cfg)
        with tm.phase("search"):
            n = search_file_shallow(idx, a.reads, a.out, do_rc=a.rc)
        tm.count("reads", n)
        where = "the host"
    elif a.host:
        from utree_tpu_torch.search_host import HostIndex, search_file

        with tm.phase("load-db"):
            idx = HostIndex.from_ctr(a.db, cfg)
        with tm.phase("search"):
            n = search_file(idx, a.reads, a.out, do_rc=a.rc,
                            support_ranges=a.support_ranges)
        tm.count("reads", n)
        where = "the host"
    else:
        from utree_tpu_torch.index import DeviceIndexArrays
        from utree_tpu_torch.parallel.distributed import (init_distributed,
                                                          search_file_multihost)
        from utree_tpu_torch.pipeline import SearchPipeline

        if a.num_hosts > 1 and (a.host_id is None or not a.coordinator):
            raise SystemExit(
                "search --num-hosts N (N>1) requires --host-id and --coordinator")
        if a.num_hosts > 1:
            init_distributed(a.coordinator, a.num_hosts, a.host_id)
        with tm.phase("load-db"):
            idx = DeviceIndexArrays.from_ctr(a.db, cfg)
        with tm.phase("build-table"):
            pipe = SearchPipeline(idx, device=a.device, do_rc=a.rc,
                                  batch_size=a.batch, lookup_mode=a.lookup_mode,
                                  support_ranges=a.support_ranges,
                                  devices=a.devices or None)
        with tm.phase("search"):
            if a.num_hosts:
                n = search_file_multihost(pipe, a.reads, a.out, resume=a.resume)
            else:
                with Tracer(a.profile_dir, pipe.device) as tr:
                    n = pipe.search_file(a.reads, a.out, resume=a.resume)
                if tr.path:
                    print(f"profile: {tr.path}")
        where = pipe.device
        if a.trace:
            print(f"table_kind: {pipe.table_kind}, layout: {pipe.layout}")
    if a.trace:
        print("\n".join(tm.lines()))
        rps = tm.rate("reads", "search")
        if rps:
            print(f"throughput: {rps:,.0f} reads/s on {where}")
    print(f"Searched {n} queries -> {a.out}")


def _cmd_xtree_build(a):
    from utree_tpu_torch.xtree.build import build_xtree_db, write_xtr

    db = build_xtree_db(a.seqs, a.map, k=a.k, comp=a.comp)
    write_xtr(db, a.db_out)
    print(f"Built xtree DB: {db.num_refs} refs, {db.num_kmers} k-mers -> {a.db_out}")


def _cmd_xtree_align(a):
    from utree_tpu_torch.xtree.align import AlignOptions, XtreeAligner
    from utree_tpu_torch.xtree.build import read_xtr

    conf, n_uniq = 0.33, 0
    if a.confidence is not None:
        if a.confidence <= 1:
            conf = a.confidence
        else:
            n_uniq = int(a.confidence)
    al = XtreeAligner(read_xtr(a.db), device=None if a.host else a.device)
    al.align_file(a.seqs, AlignOptions(
        confidence=conf, n_uniq_matches=n_uniq,
        do_full_lca=not a.shallow_lca,
        do_redist=a.redistribute or a.fast_redistribute,
        do_fast_redist=a.fast_redistribute,
        perq_out=a.perq_out, ref_out=a.ref_out, tax_out=a.tax_out,
        cov_out=a.cov_out, orthog_out=a.orthog_out,
    ))
    print("All outputs written.")


def parser() -> argparse.ArgumentParser:
    """The command line's parser; `main` runs what it parses."""
    p = argparse.ArgumentParser(prog="utree_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    b = sub.add_parser("build", help="utree-buildGG equivalent (host)")
    b.add_argument("fasta")
    b.add_argument("map")
    b.add_argument("out")
    b.add_argument("--complevel", type=int, default=1)
    b.add_argument("--rank-specific", dest="rank_specific", action="store_true",
                   help="utree-build (non-GG): conflicts poison k-mers")
    b.set_defaults(fn=_cmd_build)

    c = sub.add_parser("compress", help="utree-compress equivalent (host)")
    c.add_argument("input")
    c.add_argument("out")
    c.set_defaults(fn=_cmd_compress)

    s = sub.add_parser("search", help="utree-searchGG equivalent on a GPU")
    s.add_argument("db")
    s.add_argument("reads")
    s.add_argument("out")
    s.add_argument("--rc", action="store_true", help="also scan reverse complement")
    s.add_argument("--batch", type=int, default=8192)
    s.add_argument("--lookup-mode", dest="lookup_mode", default="auto",
                   choices=("auto", "canonical", "displaced", "bsearch", "hash",
                            "routed"),
                   help="device table layout (auto = the canonical ladder "
                        "below 80M records, the displaced table from 80M; "
                        "bsearch = the exact replay over the CTR records, "
                        "hash = the legacy two-table hash, routed = the "
                        "displaced table sharded over --devices N, each "
                        "PACKSIZE=32 only)")
    s.add_argument("--devices", type=int, default=0,
                   help="N shards from one process: the table replicated on "
                        "each and read batches split over them, or sharded "
                        "with --lookup-mode routed (output bytes identical at "
                        "any N)")
    s.add_argument("--num-hosts", dest="num_hosts", type=int, default=0,
                   help="multi-host mode: total process count (one per host); "
                        "N > 1 requires --host-id and --coordinator and a "
                        "filesystem the hosts share")
    s.add_argument("--host-id", dest="host_id", type=int, default=None)
    s.add_argument("--coordinator", default=None,
                   help="host:port of the gloo process group's rank 0")
    s.add_argument("--support-ranges", dest="support_ranges", type=int, choices=(1, 8),
                   default=1, help="SUPPORT;RANGE pairs per line: 1 = the reference "
                   "binary's output (itree.c:1096), 8 = the README-documented "
                   "per-rank variant (compact readback, voted on the host)")
    s.add_argument("--host", action="store_true",
                   help="the exact host (NumPy) search instead of the device")
    s.add_argument("--rank-specific", dest="rank_specific", action="store_true",
                   help="utree-search (non-GG) rank-specific vote, on the host")
    s.add_argument("--resume", action="store_true",
                   help="resume an interrupted search from its .ckpt sidecar")
    s.add_argument("--trace", action="store_true",
                   help="print per-phase timings and reads/s")
    s.add_argument("--profile-dir", dest="profile_dir", default=None,
                   help="write a torch.profiler Chrome trace of the device "
                        "search (host operators, and the card's kernels) "
                        "under this directory")
    s.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda runs the CUDA kernels; cpu their plain versions")
    s.set_defaults(fn=_cmd_search)

    xb = sub.add_parser("xtree-build", help="xtree BUILD equivalent")
    xb.add_argument("--seqs", required=True)
    xb.add_argument("--map")
    xb.add_argument("--db-out", dest="db_out", required=True)
    xb.add_argument("--k", type=int, default=29)
    xb.add_argument("--comp", type=int, default=0)
    xb.set_defaults(fn=_cmd_xtree_build)

    xa = sub.add_parser("xtree-align", help="xtree ALIGN equivalent on a GPU")
    xa.add_argument("--db", required=True)
    xa.add_argument("--seqs", required=True)
    xa.add_argument("--confidence", type=float)
    for flag in ("perq", "ref", "tax", "cov", "orthog"):
        xa.add_argument(f"--{flag}-out", dest=f"{flag}_out")
    xa.add_argument("--redistribute", action="store_true")
    xa.add_argument("--fast-redistribute", dest="fast_redistribute", action="store_true")
    xa.add_argument("--shallow-lca", dest="shallow_lca", action="store_true")
    xa.add_argument("--device", nargs="?", const="cuda", default="cuda",
                    choices=("cuda", "cpu"),
                    help="the k-mer front end: cuda (also a bare --device, as "
                         "utree_tpu spells it) runs kernel K9, cpu its plain "
                         "version (host voting either way)")
    xa.add_argument("--host", action="store_true",
                    help="the host engine (C++ scan) instead of the device front end")
    xa.set_defaults(fn=_cmd_xtree_align)
    return p


def main(argv=None):
    a = parser().parse_args(argv)
    a.fn(a)


if __name__ == "__main__":
    main()
