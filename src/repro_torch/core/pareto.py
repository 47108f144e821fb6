"""Pareto-frontier search mode — the port of `repro.core.pareto`.

The paper selects a single feasible min-EDP point; `objective="pareto"` on
`search` / `search_workloads` returns the whole non-dominated feasible set
instead (every engine, identical frontiers). This module holds the pure
dominance math plus the two user-facing conveniences:

  * `pareto_mask`           — exact vectorized non-dominated reduction
                              (lexicographic sort + forward elimination; the
                              oracle every engine's frontier is refined
                              through).
  * `pareto_front`          — (front_rows, metrics) over a grid, routed
                              through the engine layer so a hierarchical
                              prefilter's survivors are reused.
  * `pareto_search_refined` — Alg. 1 -> Alg. 2 applied to frontiers: a
                              coarse significance-reduced pass, then a finer
                              grid around the coarse frontier where only the
                              significant parameters get dense
                              neighborhoods.

Dominance convention throughout: all metrics minimized; a point is dominated
when another point is <= on every metric and < on at least one, so exact
metric ties are *kept* (both points stay on the frontier).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from .arch_params import Constraints
from .photonic_model import CONSTANTS, DeviceConstants
from .significance import SignificanceScore, observe_significance, refinement_sets
from .workload import Workload

DEFAULT_OBJECTIVES = ("area", "power", "edp")


def pareto_mask(points: np.ndarray) -> np.ndarray:
    """Boolean mask of non-dominated rows (all metrics minimized).

    Rows are visited in full lexicographic order, so every dominator strictly
    precedes the rows it dominates (a dominator differs somewhere, and its
    first differing metric is smaller); one forward elimination pass is then
    complete. Sorting by the first metric alone is *not* enough — with a tie
    on metric 0, a later row can dominate an earlier one and the earlier one
    would survive. O(F * G) vectorized with F = |frontier|.
    """
    points = np.asarray(points, dtype=np.float64)
    g = len(points)
    if g == 0:
        return np.zeros(0, dtype=bool)
    mask = np.ones(g, dtype=bool)
    order = np.lexsort(points.T[::-1])  # full lexicographic, metric 0 primary
    pts = points[order]
    for i in range(g):
        if not mask[i]:
            continue
        p = pts[i]
        # Anything after i in lex order with all metrics >= p (and one >) is
        # dominated; exact ties on every metric are kept.
        later = pts[i + 1:]
        dom = np.all(later >= p, axis=1) & np.any(later > p, axis=1)
        mask[i + 1:] &= ~dom
    out = np.zeros(g, dtype=bool)
    out[order] = mask
    return out


def dominates(p: np.ndarray, q: np.ndarray) -> bool:
    """True when point `p` dominates `q` (<= everywhere, < somewhere)."""
    p, q = np.asarray(p), np.asarray(q)
    return bool(np.all(p <= q) and np.any(p < q))


def merge_fronts(pts_a: np.ndarray, pts_b: np.ndarray) -> np.ndarray:
    """Cross-chunk frontier reduction: the non-dominated merge.

    Boolean mask over `np.vstack([pts_a, pts_b])` of the points surviving
    the merge (exact ties kept). Dominance is transitive and a dominated
    point stays dominated in every superset, so folding `merge_fronts` over
    locally-reduced chunk frontiers — in any partition, any order — lands on
    exactly `pareto_mask` of the one-shot point set, which is what makes
    `search(..., chunk_size=...)` byte-identical to the unstreamed sweep.
    """
    d = 0
    for p in (pts_a, pts_b):
        p = np.asarray(p)
        if p.size:
            d = p.shape[-1]
    pts_a = np.asarray(pts_a, np.float64).reshape(-1, d)
    pts_b = np.asarray(pts_b, np.float64).reshape(-1, d)
    return pareto_mask(np.vstack([pts_a, pts_b]))


def pareto_front(grid: np.ndarray, wl: Workload,
                 metrics: Sequence[str] = DEFAULT_OBJECTIVES,
                 constraints: Optional[Constraints] = None, *,
                 engine: str = "numpy", hierarchical: bool = False,
                 c: DeviceConstants = CONSTANTS, device=None,
                 calibration=None, robust: Optional[str] = None):
    """(front_rows, front_metrics) of non-dominated feasible configs.

    Thin wrapper over `search(..., objective="pareto")`, so the evaluation
    runs on any engine and — with `hierarchical=True` — reuses the
    area/power prefilter's survivor set. `constraints=None` gives the
    frontier over *all* grid points, feasibility ignored. `calibration=` /
    `robust="worst_case"` forward to `search` for a variation-aware frontier
    (dominance on worst-case metrics); the returned metrics are then the
    worst-case ones.
    """
    from .search import search  # deferred: search imports pareto_mask

    if constraints is None:
        unconstrained = float("inf")
        constraints = Constraints(area_mm2=unconstrained,
                                  power_w=unconstrained,
                                  energy_mj=unconstrained,
                                  latency_ms=unconstrained)
    r = search(wl, constraints, engine=engine, grid=grid,
               hierarchical=hierarchical, c=c, device=device,
               objective="pareto", pareto_metrics=tuple(metrics),
               calibration=calibration, robust=robust)
    return r.front, {k: r.metrics[k] for k in metrics}


def pareto_search_refined(wl: Workload,
                          constraints: Constraints = Constraints(), *,
                          engine: str = "numpy", n_z: int = 12, step: int = 2,
                          significance: Optional[Dict[str, SignificanceScore]]
                          = None,
                          top_k: int = 2, radius: int = 1,
                          metrics: Sequence[str] = DEFAULT_OBJECTIVES,
                          hierarchical: bool = True,
                          c: DeviceConstants = CONSTANTS, device=None,
                          calibration=None,
                          robust: Optional[str] = None):
    """Two-pass significance-guided frontier search (Alg. 1 -> Alg. 2).

    Pass 1 sweeps the coarse significance-reduced grid (fine sets for the
    top-k significant parameters, progressive sets for the rest). Pass 2
    re-grids *around the coarse frontier*: `refinement_sets` gives the
    significant parameters dense +/-`radius` neighborhoods of every frontier
    value while the others keep their frontier values. The returned
    `ParetoResult` is the exact frontier of the union of both passes'
    frontiers; `n_evaluated`, `n_workload_evals` and `n_feasible` sum both
    passes. `calibration=` / `robust="worst_case"` run both passes and the
    final merge at the calibration's certified worst corner (exactly as in
    `search`), and the result carries its uncertainty band; calibrations
    with uncertified varying fields are rejected (the two-pass refinement
    has no vertex-sweep fallback).
    """
    import time

    from .search import (ParetoResult, _measure_band, _pareto_from_rows,
                         _resolve_robust, _space_to_grid, build_search_space,
                         search)

    t0 = time.perf_counter()
    c, cal, fallback = _resolve_robust(calibration, robust, c, engine)
    if fallback:
        raise ValueError(
            "this calibration has uncertified varying fields "
            f"({cal.unresolved()}): pareto_search_refined supports only "
            "certified worst-corner robust search — certify the field "
            "directions (core.calibration.MONOTONE) or use "
            "search(objective='pareto')")
    significance = significance or observe_significance()
    coarse_grid = _space_to_grid(build_search_space(n_z, step, significance))
    coarse = search(wl, constraints, engine=engine, grid=coarse_grid,
                    hierarchical=hierarchical, c=c, device=device,
                    objective="pareto", pareto_metrics=tuple(metrics))
    n_evaluated = coarse.n_evaluated
    n_wl = coarse.n_workload_evals
    n_feasible = coarse.n_feasible
    fine_front = np.zeros((0, 5), dtype=np.int64)
    if len(coarse.front):
        fine_grid = _space_to_grid(refinement_sets(
            significance, coarse.front, n_z, top_k=top_k, radius=radius))
        fine = search(wl, constraints, engine=engine, grid=fine_grid,
                      hierarchical=hierarchical, c=c, device=device,
                      objective="pareto", pareto_metrics=tuple(metrics))
        n_evaluated += fine.n_evaluated
        n_wl += fine.n_workload_evals
        n_feasible += fine.n_feasible
        fine_front = fine.front
    merged = np.unique(np.concatenate([coarse.front, fine_front], axis=0),
                       axis=0)
    front, met, _ = _pareto_from_rows(merged, wl, constraints, c,
                                      tuple(metrics))
    res = ParetoResult(front=front, metrics=met, objectives=tuple(metrics),
                       n_evaluated=n_evaluated, n_feasible=n_feasible,
                       n_workload_evals=n_wl,
                       wall_time_s=time.perf_counter() - t0)
    if cal is not None:
        res.band = _measure_band(res, cal, wl)
    return res
