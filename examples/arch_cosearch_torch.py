"""Beyond-paper example on the port (PyTorch): DxPTA co-search on the
unified engine layer, `examples/arch_cosearch.py` through `repro_torch`.

The engines are the port's: `python` (the paper-faithful Alg. 2 loop),
`numpy` (float64, vectorized), `torch` (the reference's `jax` engine in
plain PyTorch float32) and `cuda` (the reference's `pallas` engine on the
hand-written kernels). `--device` names where they run ("cuda" by default,
raising without a card; "cpu" runs the kernels' plain PyTorch versions).

Three modes:

  * Default — one searched PTA per (arch, shape) across the framework's
    model zoo, via the config->workload extractor
    (repro_torch.core.extract).

        PYTHONPATH=src python examples/arch_cosearch_torch.py --engine cuda

  * `--scenarios` — constraint-scenario sweep over the five paper workloads
    (DeiT-T/S/B, BERT-B/L): every (area, power) box is one batched
    `search_workloads` call, which on the cuda engine evaluates all five
    workloads against the area/power survivors of the 12^5 grid in one
    `dse_search_padded` launch (none where no config survives the box).
    Each scenario's line gives the launches the kernels counted in it.

        PYTHONPATH=src python examples/arch_cosearch_torch.py --scenarios \
            --engine cuda

  * `--scenarios --pareto` — the same sweep in frontier mode: each scenario
    returns every workload's whole area/power/EDP Pareto frontier
    (objective="pareto") instead of the single min-EDP point. On cuda the
    per-block dominance reduction for all five workloads shares one
    `dse_pareto_padded` launch per scenario.

        PYTHONPATH=src python examples/arch_cosearch_torch.py --scenarios \
            --pareto --engine cuda
"""
import argparse
import time

from repro_torch.configs import SHAPES_BY_NAME, get_config, list_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import (Constraints, ENGINES, dxpta_search,
                              search_workloads)
from repro_torch.core.extract import workload_for
from repro_torch.core.paper_workloads import PAPER_WORKLOADS
from repro_torch.kernels.dse_eval import LAUNCHES

# (area mm^2, power W) boxes swept in --scenarios mode; the first is the
# paper's constraint set.
SCENARIOS = [(50.0, 5.0), (40.0, 4.0), (30.0, 3.0), (60.0, 8.0),
             (25.0, 2.5)]


def sweep_archs(args):
    if args.shape == "serve_2k":
        # laptop-scale default: 2k-token prefill, batch 1
        shape = ShapeConfig("serve_2k", seq_len=2048, global_batch=1,
                            kind="prefill")
    else:
        shape = SHAPES_BY_NAME[args.shape]
    cons = Constraints(area_mm2=args.area, power_w=args.power,
                       energy_mj=1e9, latency_ms=1e9)  # A/P-bounded search
    print(f"shape={shape.name}  engine={args.engine}  constraints: "
          f"{args.area}mm^2 {args.power}W "
          f"(energy/latency unconstrained -> min-EDP inside the A/P box)")
    print(f"{'arch':24s} {'feasible':8s} {'config':34s} "
          f"{'E[mJ]':>9s} {'L[ms]':>9s}")
    rows = {}
    for arch in list_archs():
        cfg = get_config(arch)
        wl = workload_for(cfg, shape)
        r = dxpta_search(wl, cons, engine=args.engine, device=args.device)
        rows[arch] = (r.feasible, _cfg(r.best_cfg), r.energy_j, r.latency_s)
        if r.feasible:
            print(f"{arch:24s} {'yes':8s} {str(r.best_cfg):34s} "
                  f"{r.energy_j*1e3:9.1f} {r.latency_s*1e3:9.2f}")
        else:
            print(f"{arch:24s} {'NO':8s} {'-':34s} {'-':>9s} {'-':>9s}")
    return {"mode": "archs", "rows": rows}


def sweep_scenarios(args):
    wls = {name: f() for name, f in PAPER_WORKLOADS.items()}
    objective = "pareto" if args.pareto else "edp"
    print(f"engine={args.engine}  objective={objective}  batched search: "
          f"{len(wls)} paper workloads x full 12^5 grid per constraint "
          f"scenario")
    rows, launches, walls = {}, {}, {}
    for area, power in SCENARIOS:
        cons = Constraints(area_mm2=area, power_w=power)
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        res = search_workloads(wls, cons, engine=args.engine,
                               hierarchical=True, objective=objective,
                               device=args.device)
        dt = time.perf_counter() - t0
        ran = {k: n - before[k] for k, n in LAUNCHES.items()
               if n != before[k]}
        launches[(area, power)] = ran
        walls[(area, power)] = dt
        total = sum(ran.values())
        what = "".join(f", {k} x{n}" for k, n in ran.items())
        print(f"\n-- scenario: {area:.0f}mm^2 / {power:.1f}W "
              f"({total} kernel launch{'' if total == 1 else 'es'}{what}, "
              f"{dt*1e3:.0f}ms)")
        for name, r in res.items():
            if args.pareto:
                rows[(area, power, name)] = (
                    r.feasible, [tuple(int(v) for v in row)
                                 for row in r.front],
                    {k: v.tolist() for k, v in r.metrics.items()},
                    r.n_feasible)
            else:
                rows[(area, power, name)] = (r.feasible, _cfg(r.best_cfg),
                                             r.edp, r.n_feasible)
            if not r.feasible:
                print(f"  {name:8s} infeasible under this box")
            elif args.pareto:
                lo, hi = r.metrics["edp"].min(), r.metrics["edp"].max()
                a_lo, a_hi = r.metrics["area"].min(), r.metrics["area"].max()
                print(f"  {name:8s} frontier: {r.size:3d} configs  "
                      f"area {a_lo:.1f}..{a_hi:.1f}mm^2  "
                      f"EDP {lo:.3e}..{hi:.3e} ({r.n_feasible} feasible)")
            else:
                print(f"  {name:8s} {str(r.best_cfg):34s} "
                      f"EDP={r.edp:.3e} ({r.n_feasible} feasible)")
    return {"mode": objective, "rows": rows, "launches": launches,
            "walls": walls}


def _cfg(c):
    return None if c is None else tuple(int(v) for v in c.as_array())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="serve_2k",
                    choices=["serve_2k", *sorted(SHAPES_BY_NAME)])
    ap.add_argument("--area", type=float, default=50.0)
    ap.add_argument("--power", type=float, default=5.0)
    ap.add_argument("--engine", default="numpy", choices=sorted(ENGINES))
    ap.add_argument("--scenarios", action="store_true",
                    help="constraint-scenario sweep over the paper "
                         "workloads (batched search_workloads)")
    ap.add_argument("--pareto", action="store_true",
                    help="with --scenarios: return each workload's whole "
                         "area/power/EDP frontier per scenario instead of "
                         "the min-EDP point")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engines (default cuda)")
    args = ap.parse_args(argv)
    if args.pareto and not args.scenarios:
        ap.error("--pareto requires --scenarios")
    if args.scenarios:
        return sweep_scenarios(args)
    return sweep_archs(args)


if __name__ == "__main__":
    main()
