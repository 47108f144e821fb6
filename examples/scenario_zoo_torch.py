"""Scenario co-search across the model zoo on the port (PyTorch):
`examples/scenario_zoo.py` through `repro_torch.scenarios`.

Expands a model x shape grid — every architecture family, prefill vs
decode vs train — lowers each cell through the config->workload
extractor, and co-searches all of them through one resident
`SearchService`. The report at the end is the HW/SW co-design payoff:
per-scenario winning PTA configs plus the cross-class summary showing
which architecture parameter decode's tiny-M GEMMs re-negotiate against
prefill's large-M ones (the paper's Alg. 1 significance question,
answered empirically per scenario class).

    PYTHONPATH=src python examples/scenario_zoo_torch.py         # reduced zoo
    PYTHONPATH=src python examples/scenario_zoo_torch.py --full  # real configs

`--engine` is the service's: numpy, torch (the reference's jax) or cuda
(the reference's pallas: a cold query whose box leaves survivors launches
`dse_search_decoded` and `dse_search_padded`). The service runs on the
card by default and raises without one; `--device cpu` runs it here.
"""
import argparse
import time

from repro_torch.configs import list_archs
from repro_torch.core import Constraints
from repro_torch.scenarios import ScenarioGrid, sweep
from repro_torch.serve import SearchService


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--full", action="store_true",
                    help="sweep the published configs (slower) instead of "
                         "the reduced CPU-smoke ones")
    ap.add_argument("--engine", default="numpy",
                    choices=("numpy", "torch", "cuda"))
    ap.add_argument("--n-z", type=int, default=6)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the service (default cuda)")
    args = ap.parse_args(argv)

    grid = ScenarioGrid.zoo(
        kinds=("train", "prefill", "decode"),
        seq_lens=(2048,), batches=(8,), new_tokens=(16, 64),
        reduce=not args.full)
    print(f"model zoo: {len(list_archs())} archs -> {grid.size} scenarios")

    # Serving classes carry tighter latency budgets than training runs —
    # the per-class box mapping expresses that directly.
    boxes = {"train": Constraints(),
             "prefill": Constraints(latency_ms=8.0),
             "decode": Constraints(latency_ms=5.0)}

    svc = SearchService(n_z=args.n_z, engine=args.engine, device=args.device)
    t0 = time.perf_counter()
    report = sweep(grid, boxes, service=svc)
    cold_s = time.perf_counter() - t0
    print(f"cold sweep: {cold_s * 1e3:.1f}ms")
    print(report.format())

    # The same grid again: every scenario is a canonical-key memo hit.
    t0 = time.perf_counter()
    again = sweep(grid, boxes, service=svc)
    repeat_s = time.perf_counter() - t0
    print(f"repeat sweep: {repeat_s * 1e3:.1f}ms, "
          f"{again.stats['memo_hits']}/{len(again.results)} memoized")
    return {"report": report.format(), "cold_s": cold_s,
            "repeat_s": repeat_s, "memo_hits": again.stats["memo_hits"],
            "n_scenarios": len(again.results)}


if __name__ == "__main__":
    main()
