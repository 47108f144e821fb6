#!/usr/bin/env python3
"""Warm wall time of one branch-and-bound query, this tree against another.

    python3 tools/compare_bnb.py --base DIR [--workload deit-b] [--n-z 24]
                                 [--pairs 10] [--reps 5]

`DIR` is an unpacked copy of another commit (`git archive <commit> | tar
-x -C DIR`). Its `src/repro_torch` is loaded beside this tree's, under the
name `repro_torch_base`, so both run in one process on one card. Each pair
times `search(..., factorized=True, prune="bound")` on the n_z^5 space for
both trees, base first in even pairs and this tree first in odd ones; a
side's time is the median of `--reps` warm queries. Both trees must return
the same winner and counters. Printed per engine: every pair, the medians,
the base's interquartile spread and how many pairs this tree won.
"""
import argparse
import importlib.util
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KEYS = ("best_cfg", "edp", "n_feasible", "n_workload_evals", "n_pruned",
        "n_bounds")


def _load_base(base: Path):
    init = base / "src" / "repro_torch" / "__init__.py"
    if not init.is_file():
        sys.exit(f"compare_bnb: {init} does not exist")
    spec = importlib.util.spec_from_file_location(
        "repro_torch_base", init,
        submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["repro_torch_base"] = mod
    spec.loader.exec_module(mod)
    return "repro_torch_base"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True)
    ap.add_argument("--workload", default="deit-b")
    ap.add_argument("--n-z", type=int, default=24)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.exit("compare_bnb: no CUDA device is available")
    sys.path.insert(0, str(ROOT / "src"))
    sides = {}
    for side, pkg in (("base", _load_base(Path(args.base).resolve())),
                      ("change", "repro_torch")):
        core = importlib.import_module(pkg + ".core")
        wl = importlib.import_module(pkg + ".core.paper_workloads") \
            .load(args.workload)
        sides[side] = (core, wl, core.FactorizedSpace.full(args.n_z))
    dev = torch.device("cuda", 0)

    def query(side, engine):
        core, wl, space = side
        r = core.search(wl, core.Constraints(), engine=engine,
                        factorized=True, space=space, prune="bound",
                        device=dev)
        torch.cuda.synchronize()
        return r

    for engine in ("cuda", "numpy"):
        results = {s: query(side, engine) for s, side in sides.items()}
        got = {s: tuple(str(getattr(r, k)) for k in KEYS)
               for s, r in results.items()}
        if got["base"] != got["change"]:
            sys.exit(f"compare_bnb: {engine} results differ: {got}")
        times = {"base": [], "change": []}
        for i in range(args.pairs):
            order = ("base", "change") if i % 2 == 0 else ("change", "base")
            for s in order:
                ts = []
                for _ in range(args.reps):
                    t0 = time.perf_counter()
                    query(sides[s], engine)
                    ts.append(time.perf_counter() - t0)
                times[s].append(statistics.median(ts))
        wins = sum(c < b for b, c in zip(times["base"], times["change"]))
        q = statistics.quantiles(times["base"], n=4)
        print(f"{args.workload} {args.n_z}^5 prune=bound, {engine} engine, "
              f"{args.pairs} pairs of {args.reps}-query medians: base "
              f"median {statistics.median(times['base'])!r} s, change "
              f"median {statistics.median(times['change'])!r} s, base "
              f"interquartile spread {q[2] - q[0]!r} s, change won "
              f"{wins}/{args.pairs}")
        for s in ("base", "change"):
            print(f"  {s}: {[round(t, 5) for t in times[s]]}")


if __name__ == "__main__":
    main()
