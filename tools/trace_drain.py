#!/usr/bin/env python3
"""Where the time of the service's batched cold path goes, on one CUDA card.

    python3 tools/trace_drain.py [--n-z 24] [--box power_w=6] [--reps 2]
                                 [--out build/trace_drain]

`SearchService.drain()` coalesces queued cold queries into one
`search_workloads` call; under the bound-guided driver that call runs one
search per workload. This script answers the five paper workloads cold,
each time on a fresh cuda-engine service (so nothing comes from a memo or
a warm base) with the slab-bound tables and the kernels already built:

  * one at a time under the paper box, and under `--box`;
  * as one submit/drain batch under `--box`;

alternating the last two `--reps` times (one, drain, drain, one, ...). It
prints each wall time (host clock around work that ends in a sync), each
workload's BnB counters and launches under both boxes, and a `cProfile` of
one drain: the host functions with the most cumulative time. The full
profile goes under `--out`.
"""
import argparse
import cProfile
import io
import pstats
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-z", type=int, default=24)
    ap.add_argument("--box", default="power_w=6")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default=str(ROOT / "build" / "trace_drain"))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("trace_drain: no CUDA device is available")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import Constraints, FactorizedSpace, search
    from repro_torch.core.paper_workloads import PAPER_WORKLOADS, load
    from repro_torch.kernels import dse_eval as dse
    from repro_torch.serve import SearchService

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    space = FactorizedSpace.full(args.n_z)
    wls = [load(n) for n in sorted(PAPER_WORKLOADS)]
    box = Constraints(**{k: float(v) for k, v in
                         (kv.split("=") for kv in args.box.split(","))})
    paper = Constraints()

    def one_at_a_time(cons):
        svc = SearchService(space=space, engine="cuda", device=dev)
        return [svc.query(wl, cons) for wl in wls], svc

    def drained(cons):
        svc = SearchService(space=space, engine="cuda", device=dev)
        for wl in wls:
            svc.submit(wl, cons)
        return svc.drain(), svc

    def timed(fn, cons):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, svc = fn(cons)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, res, svc

    for wl in wls:  # kernel build and slab-bound tables, untimed
        search(wl, paper, engine="cuda", factorized=True, space=space,
               prune="bound", device=dev)

    for label, cons in (("paper box", paper), (args.box, box)):
        total = 0.0
        for wl in wls:
            dse.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = SearchService(space=space, engine="cuda",
                              device=dev).query(wl, cons)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            total += wall
            launches = {k: n for k, n in dse.LAUNCHES.items() if n}
            print(f"{label:>12} {wl.name:>7}: cold {wall:.4f} s, "
                  f"n_evaluated {r.n_evaluated}, n_feasible {r.n_feasible}, "
                  f"n_pruned {r.n_pruned}, n_bounds {r.n_bounds}, "
                  f"launches {launches}")
        print(f"{label:>12}: five colds one at a time {total:.4f} s")

    order = [one_at_a_time, drained, drained, one_at_a_time] * args.reps
    walls = {one_at_a_time: [], drained: []}
    for fn in order[:2 * args.reps]:
        wall, res, svc = timed(fn, box)
        walls[fn].append(wall)
        if fn is drained:
            assert svc.stats["batched_calls"] == 1, svc.stats
    print(f"{args.box}: five colds one at a time "
          f"{[round(w, 4) for w in walls[one_at_a_time]]} s, one "
          f"submit/drain {[round(w, 4) for w in walls[drained]]} s")

    pr = cProfile.Profile()
    pr.enable()
    drained(box)
    pr.disable()
    full = io.StringIO()
    pstats.Stats(pr, stream=full).sort_stats("cumulative").print_stats(80)
    (out / "drain.cprofile.txt").write_text(full.getvalue())
    rows = sorted(pstats.Stats(pr).stats.items(), key=lambda kv: kv[1][3],
                  reverse=True)
    print("cProfile of one drain, host functions by cumulative time:")
    shown = 0
    for (fname, line, func), (_, ncalls, tt, ct, _) in rows:
        if "repro_torch" not in fname:
            continue
        where = fname.split("src/")[-1]
        print(f"  cum {ct * 1e3:9.3f} ms  self {tt * 1e3:9.3f} ms  "
              f"x{ncalls:<6d} {where}:{line} {func}")
        shown += 1
        if shown == 16:
            break


if __name__ == "__main__":
    main()
