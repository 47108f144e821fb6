"""Serving launcher (the port of `repro/launch/serve.py`): token generation
and the resident DSE service.

  * ``tokens`` — batched greedy generation through the model stack, plus
    the DxPTA co-design report; the default when no subcommand is given::

        PYTHONPATH=src python -m repro_torch.launch.serve tokens \\
            --arch qwen2.5-3b

    serves the full published config with random weights on the card
    (``--device cpu --reduced`` runs a tiny same-family config).

  * ``dse`` — stand up a `repro_torch.serve.SearchService` and replay a
    constraint-scenario session against it: one cold bound-guided search
    per workload, then each ``--scenario`` as a constraint-delta query
    (tightened boxes are answered warm by re-pricing the slab ledger;
    repeated boxes hit the memo). Prints per-query latency and how each
    query was served::

        PYTHONPATH=src python -m repro_torch.launch.serve dse \\
            --workload all --n-z 24 \\
            --scenario power_w=4.5 --scenario power_w=4.0,area_mm2=45

    runs on the card with the cuda engine (``--device cpu`` runs the
    kernels' plain versions).

The ``scenarios`` subcommand waits for the scenario sweep (ROADMAP Queue 1
item 12).
"""
from __future__ import annotations

import argparse
import sys
import time

_NOT_PORTED = {"scenarios": "the scenario sweep (ROADMAP Queue 1 item 12)"}


def _tokens_main(args) -> None:
    """Batched greedy generation + co-design report."""
    import numpy as np

    from .. import models as M
    from .._device import resolve_device
    from ..configs import get_config, list_archs, reduced
    from ..train.serve import Request, Server, photonic_report

    if args.arch not in list_archs():
        raise SystemExit(f"unknown arch {args.arch!r}; pick from "
                         f"{list_archs()}")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    params = M.init_params(cfg, device=dev)
    srv = Server(cfg, params, batch_size=args.batch, max_len=args.max_len,
                 device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(1, cfg.vocab, size=8).astype(np.int32),
                    max_new=args.max_new) for _ in range(args.batch)]
    stats = srv.generate(reqs)
    print(f"{stats['tokens']} tokens on {dev}: "
          f"ttft={stats['ttft_s']*1e3:.1f}ms "
          f"decode={stats['decode_s_per_tok']*1e3:.2f}ms/tok")
    print(photonic_report(get_config(args.arch), seq_len=args.max_len,
                          batch=args.batch, new_tokens=args.max_new,
                          device=dev))


def _parse_scenario(spec: str) -> dict:
    """``power_w=4.0,area_mm2=45`` -> {"power_w": 4.0, "area_mm2": 45.0}."""
    out = {}
    for part in spec.split(","):
        if "=" not in part:
            raise SystemExit(f"bad --scenario entry {part!r}; expected "
                             f"field=value pairs like power_w=4.0")
        k, v = part.split("=", 1)
        out[k.strip()] = float(v)
    return out


def _dse_main(args) -> None:
    """Resident-service session: cold searches, then scenario deltas."""
    from ..core import paper_workloads
    from ..core.arch_params import Constraints
    from ..serve import SearchService

    names = (list(paper_workloads.PAPER_WORKLOADS) if args.workload == "all"
             else [args.workload])
    svc = SearchService(n_z=args.n_z, engine=args.engine, device=args.device,
                        chunk_size=args.chunk_size,
                        checkpoint_root=args.checkpoint_root,
                        workers=args.workers)
    boxes = [("paper defaults", Constraints())]
    boxes += [(spec, Constraints(**_parse_scenario(spec)))
              for spec in args.scenario]
    print(f"service: {args.engine} engine on {svc.device}, {args.n_z}^5 "
          f"space, {len(names)} workload(s), {len(boxes)} box(es)")
    for nm in names:
        wl = paper_workloads.load(nm)
        for label, cons in boxes:
            before = dict(svc.stats)
            t0 = time.perf_counter()
            res = svc.query(wl, cons, objective=args.objective)
            ms = (time.perf_counter() - t0) * 1e3
            how = ("memo" if svc.stats["memo_hits"] > before["memo_hits"]
                   else "warm" if svc.stats["warm"] > before["warm"]
                   else "cold")
            if args.objective == "pareto":
                answer = f"frontier of {res.size}"
            else:
                answer = str(res.best_cfg) if res.feasible else "infeasible"
            print(f"  {nm:10s} {label:40s} {how:4s} {ms:9.2f}ms  {answer}")
    s = svc.stats
    print(f"served {s['queries']} queries: {s['cold']} cold, {s['warm']} "
          f"warm, {s['memo_hits']} memoized "
          f"({s['slabs_revived']}/{s['slabs_repriced']} re-priced slabs "
          f"revived)")
    if args.gc is not None:
        if args.checkpoint_root is None:
            raise SystemExit("--gc requires --checkpoint-root")
        from ..core.runtime import gc_checkpoints
        removed = gc_checkpoints(args.checkpoint_root, keep=args.gc)
        print(f"gc: removed {len(removed)} stale checkpoint dir(s), "
              f"kept newest {args.gc}")


def main(argv=None) -> None:
    """Dispatch to a subcommand (``tokens`` when none is given)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in _NOT_PORTED:
        raise NotImplementedError(f"repro_torch.launch.serve {argv[0]}: "
                                  f"{_NOT_PORTED[argv[0]]} is not ported yet")
    if not argv or argv[0] not in ("tokens", "dse"):
        argv.insert(0, "tokens")  # original flag-only invocation

    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    sub = ap.add_subparsers(dest="cmd", required=True)
    tk = sub.add_parser("tokens", help="batched greedy generation")
    tk.add_argument("--arch", required=True)
    tk.add_argument("--reduced", action="store_true")
    tk.add_argument("--batch", type=int, default=4)
    tk.add_argument("--max-new", type=int, default=8)
    tk.add_argument("--max-len", type=int, default=64)
    tk.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; cpu runs "
                         "the plain PyTorch path)")

    ds = sub.add_parser("dse", help="resident DSE co-search service")
    ds.add_argument("--workload", default="deit-t",
                    help="paper workload name, or 'all'")
    ds.add_argument("--n-z", type=int, default=12)
    ds.add_argument("--engine", default="cuda",
                    choices=("numpy", "torch", "cuda"))
    ds.add_argument("--objective", default="edp",
                    choices=("edp", "pareto"))
    ds.add_argument("--scenario", action="append", default=[],
                    metavar="FIELD=VAL[,FIELD=VAL...]",
                    help="constraint box for one delta query (repeatable)")
    ds.add_argument("--chunk-size", type=int, default=None)
    ds.add_argument("--checkpoint-root", default=None,
                    help="service-owned checkpoint root (resume per query)")
    ds.add_argument("--workers", type=int, default=None,
                    help="SearchService(workers=)")
    ds.add_argument("--gc", type=int, default=None, metavar="KEEP",
                    help="after serving, prune completed-query checkpoint "
                         "dirs under --checkpoint-root down to the newest "
                         "KEEP (manifest-validated; foreign dirs skipped)")
    ds.add_argument("--device", default="cuda",
                    help="torch device the service runs on (default cuda; "
                         "cpu runs the kernels' plain PyTorch versions)")
    args = ap.parse_args(argv)
    if args.cmd == "dse":
        _dse_main(args)
    else:
        _tokens_main(args)


if __name__ == "__main__":
    main()
