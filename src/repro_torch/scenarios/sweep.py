"""Sweep a scenario grid through the resident co-search service (the port of
`repro.scenarios.sweep`).

`sweep` lowers every scenario to a workload (`core.extract`), queues all
of them on one `serve.SearchService`, and drains the queue — memo hits
and warm constraint-deltas are peeled off individually, the cold
remainder coalesces into multi-workload `search_workloads` waves. The
returned `SweepReport` pairs each scenario with its search result and
adds the cross-scenario view the paper's Alg. 1 asks about, measured per
*scenario class* (shape kind): which architecture parameter the winning
configs actually move between decode's tiny-M pressure and
prefill/train's large-M pressure.

Constraint boxes can be one box for everything, or a mapping keyed by
scenario class — ``{"decode": Constraints(latency_ms=2), ...}`` — so
serving classes can carry the tighter latency budgets they do in
practice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.arch_params import Constraints
from ..core.performance_model import require_i32_dims
from ..core.photonic_model import CONSTANTS, DeviceConstants
from ..core.search import ParetoResult, SearchResult
from ..core.significance import PARAM_NAMES
from ..core.workload import Workload
from ..serve import SearchService

from .grid import KINDS, Scenario, ScenarioGrid, dedup_scenarios

Result = Union[SearchResult, ParetoResult]
ConstraintsLike = Union[Constraints, Mapping]


def resolve_constraints(constraints: ConstraintsLike,
                        kind: str) -> Constraints:
    """The constraint box one scenario class sees.

    A `Constraints` (or a plain box mapping over its field names) applies
    to every class; a mapping whose keys are shape kinds assigns boxes
    per class, with missing kinds taking the paper defaults. The two
    mapping spellings cannot collide: kind names and box field names are
    disjoint vocabularies.
    """
    if isinstance(constraints, Constraints):
        return constraints
    if isinstance(constraints, Mapping) and \
            set(constraints).issubset(set(KINDS)):
        box = constraints.get(kind, Constraints())
        return box if isinstance(box, Constraints) else Constraints(**box)
    return Constraints(**dict(constraints))


@dataclasses.dataclass(frozen=True)
class ScenarioResult:
    """One swept scenario: the question, its workload, and the answer."""

    scenario: Scenario
    workload: Workload
    constraints: Constraints
    result: Result

    @property
    def winner_row(self) -> Optional[np.ndarray]:
        """(R, 5) int config rows of the answer — the single min-EDP
        winner, the Pareto frontier, or None when infeasible."""
        r = self.result
        if isinstance(r, ParetoResult):
            return r.front if len(r.front) else None
        if r.best_cfg is None:
            return None
        return np.array([[getattr(r.best_cfg, p) for p in PARAM_NAMES]],
                        dtype=np.int64)


@dataclasses.dataclass
class SweepReport:
    """Everything one sweep produced, plus the cross-scenario summary."""

    results: List[ScenarioResult]
    stats: Dict[str, int]    # service-stat deltas attributable to this sweep

    def by_class(self) -> Dict[str, List[ScenarioResult]]:
        """Results grouped by scenario class (shape kind), KINDS order."""
        out: Dict[str, List[ScenarioResult]] = {}
        for r in self.results:
            out.setdefault(r.scenario.kind, []).append(r)
        return {k: out[k] for k in KINDS if k in out}

    def class_param_means(self) -> Dict[str, Dict[str, float]]:
        """Mean winning value of each architecture parameter per class.

        Pareto answers contribute every frontier row; infeasible answers
        contribute nothing. Classes with no feasible answer are absent.
        """
        means: Dict[str, Dict[str, float]] = {}
        for kind, results in self.by_class().items():
            rows = [r.winner_row for r in results
                    if r.winner_row is not None]
            if not rows:
                continue
            stacked = np.concatenate(rows, axis=0).astype(np.float64)
            means[kind] = {p: float(stacked[:, j].mean())
                           for j, p in enumerate(PARAM_NAMES)}
        return means

    def param_shift(self) -> List[Tuple[str, float]]:
        """Parameters ranked by how far their winning value moves across
        scenario classes — the empirical, per-class counterpart of the
        paper's Alg. 1 significance ranking.

        For each parameter: (max class mean - min class mean) / overall
        mean. A large value means that parameter is what decode's tiny-M
        GEMMs vs prefill's large-M GEMMs actually re-negotiate; ~0 means
        every class agrees on it.
        """
        means = self.class_param_means()
        if len(means) < 2:
            return []
        out = []
        for p in PARAM_NAMES:
            vals = np.array([means[k][p] for k in means])
            out.append((p, float((vals.max() - vals.min())
                                 / max(vals.mean(), 1e-12))))
        return sorted(out, key=lambda kv: (-kv[1], kv[0]))

    def format(self) -> str:
        """Printable sweep report: winners, class means, shift ranking."""
        lines = [f"{len(self.results)} scenarios "
                 f"({self.stats.get('cold', 0)} cold, "
                 f"{self.stats.get('warm', 0)} warm, "
                 f"{self.stats.get('memo_hits', 0)} memoized, "
                 f"{self.stats.get('batched_calls', 0)} batched wave(s))"]
        for r in self.results:
            res = r.result
            if isinstance(res, ParetoResult):
                answer = f"frontier of {len(res.front)}"
            elif res.best_cfg is None:
                answer = "infeasible"
            else:
                answer = (f"{res.best_cfg}  edp={res.edp:.3e}")
            lines.append(f"  {r.scenario.name:44s} {answer}")
        means = self.class_param_means()
        if means:
            lines.append("class mean winning parameters:")
            header = "".join(f"{p:>10s}" for p in PARAM_NAMES)
            lines.append(f"  {'class':8s}{header}")
            for kind, m in means.items():
                vals = "".join(f"{m[p]:10.2f}" for p in PARAM_NAMES)
                lines.append(f"  {kind:8s}{vals}")
        shift = self.param_shift()
        if shift:
            ranked = ", ".join(f"{p}={v:.2f}" for p, v in shift)
            lines.append(f"cross-class parameter shift (Alg. 1 view): "
                         f"{ranked}")
        return "\n".join(lines)


def sweep(grid: Union[ScenarioGrid, Sequence[Scenario]],
          constraints: ConstraintsLike = Constraints(), *,
          service: Optional[SearchService] = None,
          engine: str = "cuda", n_z: int = 12, space=None,
          objective: str = "edp", pareto_metrics: Optional[tuple] = None,
          device=None, c: DeviceConstants = CONSTANTS,
          calibration=None, robust: Optional[str] = None
          ) -> SweepReport:
    """Run every scenario of `grid` through one `SearchService`.

    Args:
      grid: a `ScenarioGrid` or an explicit scenario sequence (deduped
        here by extraction fingerprint either way).
      constraints: one box for all scenarios, or a per-class mapping
        (see `resolve_constraints`).
      service: a standing service to sweep through — repeated sweeps on
        one service answer repeated scenarios from the memo. When None a
        fresh service is built from `engine`/`n_z`/`space`/`device`/
        `c`/`calibration`/`robust` (those are ignored when `service` is
        given: the space side of a query belongs to the service).
      engine / device: the fresh service's engine (default "cuda") and
        device ("cuda" by default, raising without a card; "cpu" runs the
        kernels' plain PyTorch versions).
      objective / pareto_metrics: forwarded to every query.
      calibration / robust: calibration uncertainty for the fresh
        service (see `serve.SearchService`): robust="worst_case" sweeps
        the zoo for configs whose *worst-case* metrics meet each class's
        box, and every scenario result carries its uncertainty band.

    Returns a `SweepReport`; `report.stats` holds the service-counter
    deltas this sweep caused (not lifetime totals).

    Raises ValueError before any search runs when a scenario's GEMM dims
    exceed the int32 device-path ceiling on a torch/cuda service — the
    error names the offending scenario instead of surfacing later from
    kernel baking mid-drain.
    """
    scenarios = grid.expand() if isinstance(grid, ScenarioGrid) \
        else dedup_scenarios(grid)
    svc = service if service is not None else SearchService(
        space=space, n_z=n_z, engine=engine, device=device, c=c,
        calibration=calibration, robust=robust)
    pairs = []
    for sc in scenarios:
        wl = sc.workload()
        if svc.engine in ("torch", "cuda"):
            require_i32_dims(
                wl.gemm_array,
                where=f"{svc.engine} engine (scenario {sc.name})")
        pairs.append((sc, wl))
    before = dict(svc.stats)
    for sc, wl in pairs:
        svc.submit(wl, resolve_constraints(constraints, sc.kind),
                   objective=objective, pareto_metrics=pareto_metrics)
    answers = svc.drain()
    results = [ScenarioResult(sc, wl,
                              resolve_constraints(constraints, sc.kind),
                              res)
               for (sc, wl), res in zip(pairs, answers)]
    return SweepReport(results=results, stats=svc.stats_delta(before))
