"""Quickstart on the port (PyTorch): `examples/quickstart.py`'s DxPTA
methodology end to end on a paper workload, through `repro_torch`.

    PYTHONPATH=src python examples/quickstart_torch.py [--workload deit-b]
    # on the card by default; --device cpu runs it here

Steps (mirrors Fig. 4): 1) significance analysis (Alg. 1), 2) constraint-
aware search (Alg. 2, the paper-faithful python engine, as the reference),
3) compare against the exhaustive optimum, 4) report the found PTA. No
hand-written kernel runs on this path: Alg. 2 is a host loop and the
exhaustive cross-check is the float64 numpy model; `--device` names where
the entry points run (they raise without a card unless it is "cpu").
"""
import argparse
import dataclasses

from repro_torch.core import (Constraints, PAPER_WORKLOADS, dxpta_search,
                              grid_search_vectorized, observe_significance,
                              significant_params)
from repro_torch.core.paper_workloads import load


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="deit-b",
                    choices=sorted(PAPER_WORKLOADS))
    ap.add_argument("--area", type=float, default=50.0)
    ap.add_argument("--power", type=float, default=5.0)
    ap.add_argument("--energy", type=float, default=50.0)
    ap.add_argument("--latency", type=float, default=10.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the entry points (default cuda)")
    args = ap.parse_args(argv)

    print("== Step 1: parameter significance (Alg. 1) ==")
    scores = observe_significance()
    for name, s in scores.items():
        print(f"  S({name}): area x{s.s_area:.3f}, power x{s.s_power:.3f}")
    significant = significant_params(scores)
    print(f"  fine-grained candidates for: {significant}")
    out = {"scores": {n: dataclasses.astuple(s) for n, s in scores.items()},
           "significant": significant}

    cons = Constraints(area_mm2=args.area, power_w=args.power,
                       energy_mj=args.energy, latency_ms=args.latency)
    wl = load(args.workload)
    print(f"\n== Step 2: constraint-aware search (Alg. 2) on {wl.name} ==")
    print(f"  constraints: {cons}")
    r = dxpta_search(wl, cons, significance=scores, device=args.device)
    out["found"] = _result(r)
    if not r.feasible:
        print("  NO feasible config under these constraints.")
        return out
    print(f"  found: {r.best_cfg}")
    print(f"  area={r.area_mm2:.1f} mm^2  power={r.power_w:.2f} W  "
          f"energy={r.energy_j*1e3:.1f} mJ  latency={r.latency_s*1e3:.2f} ms")
    print(f"  evaluated {r.n_evaluated} configs "
          f"({r.n_workload_evals} workload evals) in {r.wall_time_s:.2f}s")

    print("\n== Step 3: exhaustive optimum (vectorized, beyond-paper) ==")
    ex = grid_search_vectorized(wl, cons)
    print(f"  exhaustive best: {ex.best_cfg}  EDP ratio "
          f"dxpta/exh = {r.edp/ex.edp:.3f}  ({ex.wall_time_s*1e3:.0f} ms "
          f"for all {ex.n_evaluated} configs)")
    out["exhaustive"] = _result(ex)
    out["edp_ratio"] = r.edp / ex.edp
    return out


def _result(r):
    """A SearchResult's answer and work counters as plain data."""
    return {"config": None if r.best_cfg is None
            else tuple(int(v) for v in r.best_cfg.as_array()),
            "area_mm2": r.area_mm2, "power_w": r.power_w,
            "energy_j": r.energy_j, "latency_s": r.latency_s, "edp": r.edp,
            "n_evaluated": r.n_evaluated,
            "n_workload_evals": r.n_workload_evals, "feasible": r.feasible}


if __name__ == "__main__":
    main()
