"""Command line of the port (counterpart of `utree_tpu/cli.py`, device
search branch):

  python -m utree_tpu_torch.cli search <db.ctr> <reads.fa> <out.txt>
      [--rc] [--batch N] [--lookup-mode auto|canonical|displaced|bsearch]
      [--resume] [--trace]
      [--device cuda|cpu]

The other subcommands and search flags of `utree_tpu.cli` are not ported
yet (ROADMAP A.6); `build` and `compress` are backend-neutral and stay with
`python -m utree_tpu.cli`.
"""

from __future__ import annotations

import argparse


def _cmd_search(a):
    from utree_tpu.formats import sniff_config
    from utree_tpu.index import DeviceIndexArrays
    from utree_tpu.utils.trace import PhaseTimer
    from utree_tpu_torch.pipeline import SearchPipeline

    tm = PhaseTimer(quiet=True) if a.trace else None
    cfg = sniff_config(a.db)
    if tm:
        with tm.phase("load-db"):
            idx = DeviceIndexArrays.from_ctr(a.db, cfg)
        with tm.phase("build-table"):
            pipe = SearchPipeline(idx, device=a.device, do_rc=a.rc,
                                  batch_size=a.batch, lookup_mode=a.lookup_mode,
                                  tracer=tm)
        with tm.phase("search"):
            n = pipe.search_file(a.reads, a.out, resume=a.resume)
        print(f"table_kind: {pipe.table_kind}")
        for name, dt in tm.phases.items():
            print(f"{name} [{dt:.3f}s]")
        rps = tm.rate("reads", "search")
        if rps:
            print(f"throughput: {rps:,.0f} reads/s on {pipe.device}")
    else:
        idx = DeviceIndexArrays.from_ctr(a.db, cfg)
        pipe = SearchPipeline(idx, device=a.device, do_rc=a.rc,
                              batch_size=a.batch, lookup_mode=a.lookup_mode)
        n = pipe.search_file(a.reads, a.out, resume=a.resume)
    print(f"Searched {n} queries -> {a.out}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="utree_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("search", help="utree-searchGG equivalent on a GPU")
    s.add_argument("db")
    s.add_argument("reads")
    s.add_argument("out")
    s.add_argument("--rc", action="store_true", help="also scan reverse complement")
    s.add_argument("--batch", type=int, default=8192)
    s.add_argument("--lookup-mode", dest="lookup_mode", default="auto",
                   choices=("auto", "canonical", "displaced", "bsearch"),
                   help="device table layout (auto = the canonical ladder "
                        "below 80M records, the displaced table from 80M; "
                        "bsearch = the exact replay over the CTR records, "
                        "PACKSIZE=32 only)")
    s.add_argument("--resume", action="store_true",
                   help="resume an interrupted search from its .ckpt sidecar")
    s.add_argument("--trace", action="store_true",
                   help="print per-phase timings and reads/s")
    s.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cuda runs the CUDA kernels; cpu their plain versions")
    s.set_defaults(fn=_cmd_search)
    a = p.parse_args(argv)
    a.fn(a)


if __name__ == "__main__":
    main()
