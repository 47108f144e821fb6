"""Serving launcher (the port of `repro/launch/serve.py`): token generation
and the resident DSE service.

  * ``tokens`` — batched greedy generation through the model stack, plus
    the DxPTA co-design report; the default when no subcommand is given::

        PYTHONPATH=src python -m repro_torch.launch.serve tokens \\
            --arch qwen2.5-3b

    serves the full published config with random weights on the card,
    with the default bf16 x bf16 -> f32 products (``--device cpu --reduced``
    runs a tiny same-family config; ``--reduced`` turns the products'
    exec-safe mode on, as in the reference). Every
    decoder family serves; the enc-dec family needs source frames, which
    `Server` does not send (as in the reference), so it fails there.

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
    kernels' plain versions); ``--workers N`` fans every search out over N
    leased slab workers and ``--shard N`` every evaluation over up to N
    cards (byte-identical answers either way).

  * ``scenarios`` — sweep a model-zoo scenario grid (models x train /
    prefill / decode x shapes) through one resident service, twice by
    default (the repeat is served from the memo), and print the winners
    and the cross-class parameter shift::

        PYTHONPATH=src python -m repro_torch.launch.serve scenarios \
            --model qwen2.5-3b --model rwkv6-7b --box decode:latency_ms=2

    runs on the card with the cuda engine (``--device cpu --reduced`` sweeps
    tiny same-family configs with the kernels' plain versions; ``--shard
    N`` as for ``dse``).
"""
from __future__ import annotations

import argparse
import sys
import time


def _tokens_main(args) -> None:
    """Batched greedy generation + co-design report."""
    import numpy as np

    from .. import models as M
    from .._device import resolve_device
    from ..configs import get_config, list_archs, reduced
    from ..models.layers import set_exec_safe
    from ..train.serve import Request, Server, photonic_report

    if args.arch not in list_archs():
        raise SystemExit(f"unknown arch {args.arch!r}; pick from "
                         f"{list_archs()}")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
        set_exec_safe(True)
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
                        shard=args.shard, chunk_size=args.chunk_size,
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


def _scenarios_main(args) -> None:
    """Model-zoo scenario sweep through one resident service."""
    from ..configs import list_archs
    from ..core.arch_params import Constraints
    from ..scenarios import ScenarioGrid, sweep
    from ..serve import SearchService

    models = tuple(args.model) or ("qwen2.5-3b", "rwkv6-7b", "olmoe-1b-7b")
    unknown = sorted(set(models) - set(list_archs()))
    if unknown:
        raise SystemExit(f"unknown arch(es) {unknown}; pick from "
                         f"{list_archs()}")
    grid = ScenarioGrid(models=models, kinds=tuple(args.kind),
                        seq_lens=tuple(args.seq_len),
                        batches=tuple(args.batch),
                        new_tokens=tuple(args.new_tokens),
                        reduce=args.reduced)
    cons = {spec.split(":", 1)[0]: _parse_scenario(spec.split(":", 1)[1])
            for spec in args.box} if args.box else {}
    svc = SearchService(n_z=args.n_z, engine=args.engine, device=args.device,
                        shard=args.shard, chunk_size=args.chunk_size)
    print(f"service: {args.engine} engine on {svc.device}, {args.n_z}^5 "
          f"space; grid: {len(models)} model(s) x {len(args.kind)} kind(s) "
          f"-> {grid.size} scenarios")
    for i in range(max(1, args.repeat)):
        t0 = time.perf_counter()
        rep = sweep(grid, cons if cons else Constraints(), service=svc,
                    objective=args.objective)
        ms = (time.perf_counter() - t0) * 1e3
        print(f"sweep {i + 1} ({ms:.1f}ms):")
        print(rep.format())


def main(argv=None) -> None:
    """Dispatch to a subcommand (``tokens`` when none is given)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("tokens", "dse", "scenarios"):
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
    ds.add_argument("--shard", type=int, default=None,
                    help="fan each evaluation out over up to N cards "
                         "(byte-identical answers)")
    ds.add_argument("--chunk-size", type=int, default=None)
    ds.add_argument("--checkpoint-root", default=None,
                    help="service-owned checkpoint root (resume per query)")
    ds.add_argument("--workers", type=int, default=None,
                    help="fan cold searches and warm deltas out over N "
                         "leased slab workers (byte-identical answers)")
    ds.add_argument("--gc", type=int, default=None, metavar="KEEP",
                    help="after serving, prune completed-query checkpoint "
                         "dirs under --checkpoint-root down to the newest "
                         "KEEP (manifest-validated; foreign dirs skipped)")
    ds.add_argument("--device", default="cuda",
                    help="torch device the service runs on (default cuda; "
                         "cpu runs the kernels' plain PyTorch versions)")

    sc = sub.add_parser("scenarios", help="model-zoo scenario co-search")
    sc.add_argument("--model", action="append", default=[],
                    help="arch name (repeatable; default: a 3-model zoo)")
    sc.add_argument("--kind", action="append", default=None,
                    choices=("train", "prefill", "decode"),
                    help="scenario class (repeatable; default: all three)")
    sc.add_argument("--seq-len", type=int, action="append", default=None,
                    help="context length axis (repeatable; default 2048)")
    sc.add_argument("--batch", type=int, action="append", default=None,
                    help="batch axis (repeatable; default 8)")
    sc.add_argument("--new-tokens", type=int, action="append", default=None,
                    help="decode-length axis (repeatable; default 16, 64)")
    sc.add_argument("--box", action="append", default=[],
                    metavar="KIND:FIELD=VAL[,FIELD=VAL...]",
                    help="per-class constraint box, e.g. "
                         "decode:latency_ms=2 (repeatable)")
    sc.add_argument("--reduced", action="store_true",
                    help="sweep the reduced (CPU-smoke) configs")
    sc.add_argument("--repeat", type=int, default=2,
                    help="sweep the grid this many times (repeats after "
                         "the first are served from the memo)")
    sc.add_argument("--n-z", type=int, default=6)
    sc.add_argument("--engine", default="cuda",
                    choices=("numpy", "torch", "cuda"))
    sc.add_argument("--objective", default="edp",
                    choices=("edp", "pareto"))
    sc.add_argument("--shard", type=int, default=None,
                    help="fan each evaluation out over up to N cards "
                         "(byte-identical answers)")
    sc.add_argument("--chunk-size", type=int, default=None)
    sc.add_argument("--device", default="cuda",
                    help="torch device the service runs on (default cuda; "
                         "cpu runs the kernels' plain PyTorch versions)")

    args = ap.parse_args(argv)
    if args.cmd == "scenarios":
        args.kind = args.kind or ["train", "prefill", "decode"]
        args.seq_len = args.seq_len or [2048]
        args.batch = args.batch or [8]
        args.new_tokens = args.new_tokens or [16, 64]
        _scenarios_main(args)
    elif args.cmd == "dse":
        _dse_main(args)
    else:
        _tokens_main(args)


if __name__ == "__main__":
    main()
