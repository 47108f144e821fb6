"""Alg. 2 — constraint-aware architecture search, plus the engine layer.

The port of `repro.core.search`: the min-EDP search and the Pareto-frontier
mode. The paper-level entry points:

  * `dxpta_search`      — the paper's Alg. 2: significance-guided candidate
                          sets, feasible min-EDP selection (`prune=True`
                          skips the workload evaluation once area/power
                          already violate).
  * `exhaustive_search` — the paper's baseline: the full 1..N_z grid.

The engine layer (`search` / `search_workloads`) has four interchangeable
backends over the same cost model, all returning identical `SearchResult`s:

  * `python` — the paper-faithful Alg. 2 sequential loop (the oracle);
  * `numpy`  — the whole grid as one broadcasted float64 computation;
  * `torch`  — the same model in plain eager torch float32 on the search's
               device, with masking, argmin and a sort-and-scan frontier
               pass there (the reference's `jax` engine; it launches none
               of the hand-written kernels);
  * `cuda`   — the fused CUDA search kernels (`kernels/dse_eval.py`):
               feasibility, EDP and a per-block argmin inside the kernel,
               so only a (3W, n_blocks) reduction leaves the device.

`hierarchical=True` adds the area/power-only prefilter (`hw_prefilter`, plain
torch float32 on the search's device) before the workload evaluation;
`search_workloads` batches every workload into one cuda launch. `chunk_size=`
streams the grid (or the factorized index space) with a running argmin
carried across chunks — into the kernels on cuda. `shard=N` fans each
evaluation out over the candidate mesh (`launch.mesh`): the cuda and torch
engines launch one contiguous slice of the candidates per card (up to N
cards, one device on the CPU) and combine the slices' reductions on the
host; the python and numpy engines split the same way at any device count,
so every engine runs the cross-shard reduction. Any (shard, chunk_size)
returns the one-shot sweep's bytes. `objective="pareto"`
returns the whole non-dominated feasible set (`ParetoResult`) instead: the
python oracle grows it incrementally, numpy masks it exactly in float64,
torch sorts and scans its float32 points against a bounded buffer, and
cuda reduces each block to its local front in the frontier kernels, after
which every engine refines its candidates through the float64 reference
model, so the frontiers come back byte-identical. `factorized=True`
evaluates a product space from per-axis tables (numpy, torch) or decodes
the candidates on device (cuda), and `prune="bound"` runs the significance-
ordered branch-and-bound over slabs of that space. Whichever backend picks
the winner, its reported metrics are recomputed through the float64
reference model (`eval_full`).

`calibration=` / `robust="worst_case"` carry calibration uncertainty
(core.calibration) through any path: a robust search is an ordinary search
at the calibration's certified worst corner, so its constants reach the
cuda kernels through the same host-folded float32 parameters as any other
`DeviceConstants`. `runtime=` attaches the resilient control plane
(core.runtime): checkpoint/resume per evaluation unit, bounded retries
and, on the CPU only, cuda -> torch -> numpy degradation and NaN
quarantine, all without changing a result (on a card an exhausted or
NaN-poisoned unit fails the search). `keep_ledger=True` keeps a bound-guided run's slab
partition (`core.factorized.SlabLedger`), the warm-start substrate of
`repro_torch.serve.SearchService`. `workers=N` fans the bound-guided slab
queue out across N leased worker threads (`repro_torch.parallel.slab_sched`),
byte-identical to `workers=None` in its default deterministic mode.

Every entry point takes `device=`: "cuda" (the default) launches the
kernels and runs the prefilter on the card, and raises when no card is
present; "cpu" runs the kernels' plain PyTorch versions. `engine="jax"`
raises a ValueError that names `torch`, its counterpart.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import time
from typing import Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from .._device import resolve_device
from ..launch.mesh import shard_mesh
from .arch_params import Constraints, PTAConfig, config_grid
from .calibration import RobustBand, as_calibration
from .factorized import (FactorizedSpace, evaluate_space_tensors,
                         factorized_evaluate_grid)
from .pareto import DEFAULT_OBJECTIVES, pareto_mask
from .performance_model import (calc_edp, eval_full, eval_wload_arrays,
                                eval_wload_tensors, gemm_tensor,
                                scalar_tensor, workload_statics)
from .photonic_model import (CONSTANTS, DeviceConstants, area_breakdown,
                             eval_hw, power_breakdown, sram_mb_for_workload)
from .runtime import (SearchRuntime, decode_best_indexed, decode_best_row,
                      decode_front, encode_best_indexed, encode_best_row,
                      encode_front, fingerprint as _fingerprint)
from .significance import SignificanceScore, observe_significance, significant_params
from .workload import Workload

# Metric arrays reported per evaluated point (every evaluate_grid key).
REPORT_METRICS = ("area", "power", "energy", "latency", "util", "edp")

@dataclasses.dataclass
class SearchResult:
    """Feasible min-EDP selection.

    `best_cfg` is the winning config (None when nothing satisfied the
    constraints) and the metric fields its float64 reference-model
    evaluation. The counters record how much work the search did and,
    under `prune="bound"` / `runtime=`, how much it skipped or survived.
    """

    best_cfg: Optional[PTAConfig]
    area_mm2: float = float("nan")
    power_w: float = float("nan")
    energy_j: float = float("nan")
    latency_s: float = float("nan")
    edp: float = float("inf")
    n_evaluated: int = 0
    n_feasible: int = 0
    n_workload_evals: int = 0
    wall_time_s: float = 0.0
    # Bound-guided search (prune="bound") counters: configs skipped by the
    # admissible slab bounds and slab bound evaluations performed.
    n_pruned: int = 0
    n_bounds: int = 0
    # Resilient-runtime counters (search(..., runtime=)): transient launch
    # retries, engine degradations and NaN-quarantined units re-evaluated
    # on the host (both on the CPU only), committed snapshots, and the unit cursor this run resumed
    # from (0 = cold start). Zero when no runtime is attached.
    n_retries: int = 0
    n_fallbacks: int = 0
    n_quarantined: int = 0
    n_checkpoints: int = 0
    resumed_step: int = 0
    # Optional (collect=True): per-candidate metric arrays for Fig. 9 scatter.
    history: Optional[Dict[str, np.ndarray]] = None

    # Slab ledger (prune="bound", keep_ledger=True): the run's pruned and
    # evaluated slab partition with stored bounds, the warm-start substrate
    # of repro_torch.serve. Excluded from equality: two searches that agree
    # on everything above are the same result whether or not one kept it.
    ledger: Optional[object] = dataclasses.field(default=None, repr=False,
                                                 compare=False)

    # Robust search (calibration=): the winner's uncertainty band — float64
    # reference metrics at the calibration's worst, nominal and best
    # corners (a core.calibration.RobustBand). None on uncalibrated
    # searches and infeasible results; excluded from equality like the
    # ledger.
    band: Optional[RobustBand] = dataclasses.field(default=None, repr=False,
                                                   compare=False)

    # Parallel slab scheduler (search(..., workers=N)): the run's
    # lease/requeue/merge telemetry (a repro_torch.parallel.slab_sched.
    # SchedStats). None on single-executor searches. Excluded from equality
    # like the ledger: scheduling is how the answer was computed, not the
    # answer.
    sched: Optional[object] = dataclasses.field(default=None, repr=False,
                                                compare=False)

    @property
    def feasible(self) -> bool:
        """True when the search found any constraint-satisfying config."""
        return self.best_cfg is not None

    @property
    def pruned_fraction(self) -> float:
        """Fraction of the candidate space the bound pruning skipped."""
        return self.n_pruned / max(self.n_evaluated, 1)


@dataclasses.dataclass
class ParetoResult:
    """A feasible Pareto frontier (objective="pareto").

    `front` holds the non-dominated feasible config rows in canonical
    (lexicographic) order; `metrics` the float64 reference-model metric
    arrays aligned row for row with it. Whatever engine proposed the
    frontier, both are finalized through the numpy reference model, so
    results are byte-identical across engines whenever they agree on the
    frontier membership.
    """

    front: np.ndarray                      # (F, 5) int64 config rows
    metrics: Dict[str, np.ndarray]         # {REPORT_METRICS: (F,) float64}
    objectives: tuple = DEFAULT_OBJECTIVES
    n_evaluated: int = 0
    n_feasible: int = 0
    n_workload_evals: int = 0
    wall_time_s: float = 0.0
    # Bound-guided search counters, as on SearchResult.
    n_pruned: int = 0
    n_bounds: int = 0
    # Resilient-runtime counters, as on SearchResult.
    n_retries: int = 0
    n_fallbacks: int = 0
    n_quarantined: int = 0
    n_checkpoints: int = 0
    resumed_step: int = 0
    # cuda frontier-kernel blocks whose local front overflowed MAX_FRONT and
    # were refined on the host from the whole block (exact, just slower).
    # Always 0 on the python/numpy/torch engines.
    n_overflow: int = 0
    # Slab ledger, as on SearchResult (keep_ledger=True only).
    ledger: Optional[object] = dataclasses.field(default=None, repr=False,
                                                 compare=False)
    # Robust-search uncertainty band, as on SearchResult but with
    # (F,)-arrays aligned row for row with `front`. None on uncalibrated
    # searches and empty frontiers.
    band: Optional[RobustBand] = dataclasses.field(default=None, repr=False,
                                                   compare=False)
    # Parallel slab scheduler telemetry, as on SearchResult (workers=N).
    sched: Optional[object] = dataclasses.field(default=None, repr=False,
                                                compare=False)

    @property
    def size(self) -> int:
        """Number of points on the frontier."""
        return len(self.front)

    @property
    def pruned_fraction(self) -> float:
        """Fraction of the candidate space the bound pruning skipped."""
        return self.n_pruned / max(self.n_evaluated, 1)

    @property
    def feasible(self) -> bool:
        """True when any constraint-satisfying config exists."""
        return self.size > 0

    @property
    def configs(self):
        """The frontier rows as `PTAConfig` objects."""
        return [PTAConfig.from_array(row) for row in self.front]


def progressive_candidates(n_z: int, step: int,
                           align_dims: Optional[Sequence[int]] = None):
    """Candidate set for the non-significant parameters (Alg. 2 lines 3-8):
    {step, 2*step, ...} <= n_z, optionally joined with the divisors of the
    workload's evenly-sized data dimensions."""
    base = list(range(step, n_z + 1, step))
    if not align_dims:
        return base
    divisors = sorted({d for dim in align_dims for d in range(2, n_z + 1)
                       if dim % d == 0})
    return sorted(set(base) | set(divisors)) if divisors else base


def build_search_space(n_z: int = 12, step: int = 2,
                       significance: Optional[Dict[str, SignificanceScore]] = None,
                       align_dims: Optional[Sequence[int]] = None):
    """Candidate sets per parameter, driven by Alg. 1 significance output:
    the top-2 significant parameters get 1..N_z, the rest progressive
    sets."""
    significance = significance or observe_significance()
    fine = set(significant_params(significance, top_k=2))
    inc = list(range(1, n_z + 1))
    prog = progressive_candidates(n_z, step, align_dims)
    return {name: (inc if name in fine else prog)
            for name in ("n_t", "n_c", "n_h", "n_v", "n_lambda")}


def _space_to_grid(space) -> np.ndarray:
    return config_grid(space["n_t"], space["n_c"], space["n_v"],
                       space["n_h"], space["n_lambda"])


def _sequential_search(grid: np.ndarray, wl: Workload, constraints: Constraints,
                       prune: bool, collect: bool, c: DeviceConstants,
                       edp_init: float = 1000.0) -> SearchResult:
    """Shared Alg. 2-style sequential loop (also the exhaustive baseline,
    with pruning disabled). `edp_init` defaults to the paper's EDP_svd cap;
    the engine layer passes inf to match the uncapped vectorized engines."""
    sram_mb = sram_mb_for_workload(wl.max_act_bytes, c)
    gemms = wl.gemm_array
    best = SearchResult(best_cfg=None, edp=edp_init)  # EDP_svd init (Alg. 2)
    hist = {k: [] for k in ("area", "power", "energy", "latency",
                            "feasible")} if collect else None
    n_wl = 0
    n_feasible = 0
    t0 = time.perf_counter()
    for row in grid:
        n_t, n_c, n_h, n_v, n_l = (int(x) for x in row)
        area, power = eval_hw(n_t, n_c, n_h, n_v, n_l, sram_mb, c)
        hw_ok = (area < constraints.area_mm2) and (power < constraints.power_w)
        if prune and not hw_ok:
            if collect:
                for k, v in (("area", area), ("power", power),
                             ("energy", np.nan), ("latency", np.nan),
                             ("feasible", False)):
                    hist[k].append(v)
            continue
        energy, latency, _ = eval_wload_arrays(
            n_t, n_c, n_h, n_v, n_l, gemms, wl.elec_ops, wl.weight_bytes,
            wl.act_io_bytes, sram_mb, c)
        energy, latency = float(energy), float(latency)
        n_wl += 1
        ok = hw_ok and (energy < constraints.energy_j) \
            and (latency < constraints.latency_s)
        if collect:
            for k, v in (("area", area), ("power", power), ("energy", energy),
                         ("latency", latency), ("feasible", ok)):
                hist[k].append(v)
        if not ok:
            continue
        n_feasible += 1
        edp = calc_edp(energy, latency)
        if edp < best.edp:
            best = SearchResult(
                best_cfg=PTAConfig(n_t, n_c, n_h, n_v, n_l),
                area_mm2=float(area), power_w=float(power), energy_j=energy,
                latency_s=latency, edp=edp)
    best.n_evaluated = len(grid)
    best.n_feasible = n_feasible
    best.n_workload_evals = n_wl
    best.wall_time_s = time.perf_counter() - t0
    if collect:
        best.history = {k: np.asarray(v) for k, v in hist.items()}
    return best


def dxpta_search(wl: Workload, constraints: Constraints = Constraints(),
                 n_z: int = 12, step: int = 2,
                 significance: Optional[Dict[str, SignificanceScore]] = None,
                 align_dims: Optional[Sequence[int]] = None,
                 prune: Union[bool, str] = True, collect: bool = False,
                 c: DeviceConstants = CONSTANTS, engine: str = "python",
                 device=None, factorized: bool = False, calibration=None,
                 robust: Optional[str] = None) -> SearchResult:
    """The paper's constraint-aware search (Alg. 2).

    `engine` dispatches the significance-reduced grid to any backend of the
    engine layer; `prune` maps to the hierarchical two-phase pass there
    (`prune="bound"` to the branch-and-bound driver over the candidate
    sets' product space). The default `python` engine is the paper-faithful
    sequential loop, including the EDP_svd=1000 initial cap; `collect=True`
    requires it. `factorized=True` hands the candidate sets to the
    factorized product-space evaluation (numpy/torch/cuda engines).
    `calibration=` / `robust="worst_case"` carry calibration uncertainty
    through whichever path dispatches, exactly as in `search` (robust mode
    needs a vectorized engine; the python loop accepts `calibration=` only
    without `robust=`, running at its nominal constants).
    """
    dev = resolve_device(device)
    if collect and engine != "python":
        raise ValueError("collect=True (per-candidate history) is only "
                         "implemented by the python engine")
    space = build_search_space(n_z, step, significance, align_dims)
    if prune == "bound":
        return search(wl, constraints, engine=engine, factorized=True,
                      space=space, c=c, device=dev, prune="bound",
                      calibration=calibration, robust=robust)
    if factorized:
        return search(wl, constraints, engine=engine, factorized=True,
                      space=space, c=c, device=dev, calibration=calibration,
                      robust=robust)
    grid = _space_to_grid(space)
    if engine == "python":
        c, cal, _ = _resolve_robust(calibration, robust, c, engine)
        res = _sequential_search(grid, wl, constraints, prune, collect, c)
        if cal is not None:
            res.band = _measure_band(res, cal, wl)
        return res
    return search(wl, constraints, engine=engine, grid=grid,
                  hierarchical=prune, c=c, device=dev,
                  calibration=calibration, robust=robust)


def exhaustive_search(wl: Workload, constraints: Constraints = Constraints(),
                      n_z: int = 12, collect: bool = False,
                      c: DeviceConstants = CONSTANTS) -> SearchResult:
    """The paper's exhaustive baseline: full 1..N_z grid on all parameters."""
    inc = list(range(1, n_z + 1))
    grid = config_grid(inc, inc, inc, inc, inc)
    return _sequential_search(grid, wl, constraints, prune=False,
                              collect=collect, c=c)


def evaluate_grid(grid: np.ndarray, wl: Workload,
                  c: DeviceConstants = CONSTANTS):
    """Float64 metrics for a (G, 5) config grid: dict of (G,) arrays area,
    power, energy, latency, util, edp."""
    sram_mb = sram_mb_for_workload(wl.max_act_bytes, c)
    g = np.asarray(grid)
    cols = [g[:, i] for i in range(5)]
    area, power = eval_hw(*cols, sram_mb, c)
    energy, latency, util = eval_wload_arrays(
        *cols, wl.gemm_array, wl.elec_ops, wl.weight_bytes, wl.act_io_bytes,
        sram_mb, c)
    return {"area": area, "power": power, "energy": energy,
            "latency": latency, "util": util, "edp": energy * latency}


def grid_search_vectorized(wl: Workload,
                           constraints: Constraints = Constraints(),
                           grid: Optional[np.ndarray] = None, n_z: int = 12,
                           c: DeviceConstants = CONSTANTS) -> SearchResult:
    """Beyond-paper: whole-grid broadcasted float64 evaluation."""
    if grid is None:
        inc = list(range(1, n_z + 1))
        grid = config_grid(inc, inc, inc, inc, inc)
    t0 = time.perf_counter()
    m = evaluate_grid(grid, wl, c)
    ok = constraints.satisfied(m["area"], m["power"], m["energy"],
                               m["latency"])
    edp = np.where(ok, m["edp"], np.inf)
    n_feasible = int(np.sum(ok))
    wall = time.perf_counter() - t0
    if n_feasible == 0:
        return SearchResult(best_cfg=None, n_evaluated=len(grid),
                            n_feasible=0, n_workload_evals=len(grid),
                            wall_time_s=wall)
    i = int(np.argmin(edp))
    return SearchResult(
        best_cfg=PTAConfig.from_array(grid[i]),
        area_mm2=float(m["area"][i]), power_w=float(m["power"][i]),
        energy_j=float(m["energy"][i]), latency_s=float(m["latency"][i]),
        edp=float(edp[i]), n_evaluated=len(grid), n_feasible=n_feasible,
        n_workload_evals=len(grid), wall_time_s=wall)


# ---------------------------------------------------------------------------
# Unified engine layer: python | numpy | cuda
# ---------------------------------------------------------------------------

def _full_grid(n_z: int) -> np.ndarray:
    inc = list(range(1, n_z + 1))
    return config_grid(inc, inc, inc, inc, inc)


def _f32(x) -> float:
    return float(np.float32(x))


def _hw_prefix(cols: torch.Tensor, c: DeviceConstants):
    """Workload-independent float32 area/power prefix columns.

    The derived SRAM size is the only workload dependence of the hardware
    model, and its term sits second-to-last in `eval_hw`'s component sum —
    so summing every component before it once per grid (in the breakdowns'
    dict order), then `(prefix + sram * coef) + chip_fixed` per workload,
    reproduces the reference prefilter's float32 value: same additions,
    same order."""
    five = tuple(cols[i] for i in range(5))

    def prefix(breakdown):
        total = None
        for key, term in breakdown(*five, 0.0, c).items():
            if key == "memory":  # chip_misc follows it — stop before
                return total
            total = term if total is None else total + term

    return prefix(area_breakdown), prefix(power_breakdown)


def hw_prefilter_masks(grid: np.ndarray, wls: Sequence[Workload],
                       constraints_seq: Sequence[Constraints],
                       c: DeviceConstants = CONSTANTS, device=None):
    """Per-workload area/power feasibility masks over one grid, in plain
    torch float32 on `device`.

    The base columns are computed once per grid; each distinct
    (sram_mb, area bound, power bound) bucket then costs one affine compare
    (the paper's five workloads share bounds and several share the derived
    SRAM size). Returns a list of (G,) boolean numpy masks aligned with
    `wls`."""
    dev = resolve_device(device)
    cols = torch.from_numpy(
        np.ascontiguousarray(np.asarray(grid).T, np.float32)).to(dev)
    area0, power0 = _hw_prefix(cols, c)
    keys = [(float(sram_mb_for_workload(wl.max_act_bytes, c)),
             float(cc.area_mm2), float(cc.power_w))
            for wl, cc in zip(wls, constraints_seq)]
    by_key = {}
    for key in sorted(set(keys)):
        sram = torch.tensor(key[0], dtype=torch.float32, device=dev)
        area = (area0 + sram * c.a_sram_per_mb) + c.a_chip_fixed
        power = (power0 + sram * c.p_sram_per_mb) + c.p_chip_fixed
        by_key[key] = ((area < _f32(key[1])) & (power < _f32(key[2]))) \
            .cpu().numpy()
    return [by_key[key] for key in keys]


def hw_prefilter(grid: np.ndarray, wl: Workload, constraints: Constraints,
                 c: DeviceConstants = CONSTANTS, device=None) -> np.ndarray:
    """Phase-1 mask of the hierarchical search: area/power feasibility only
    (no workload term), one float32 sweep of the grid on `device`."""
    return hw_prefilter_masks(grid, [wl], [constraints], c, device)[0]


def _make_result(cfg_row, n_feasible: int, wl: Workload, c: DeviceConstants,
                 n_evaluated: int, n_workload_evals: int,
                 wall: float) -> SearchResult:
    """Finalize an engine's selection through the float64 reference model so
    reported metrics are bit-identical across backends."""
    if cfg_row is None:
        return SearchResult(best_cfg=None, n_evaluated=n_evaluated,
                            n_feasible=0, n_workload_evals=n_workload_evals,
                            wall_time_s=wall)
    cfg = PTAConfig.from_array(cfg_row)
    area, power, energy, latency = eval_full(cfg, wl, c)[:4]
    return SearchResult(
        best_cfg=cfg, area_mm2=area, power_w=power, energy_j=energy,
        latency_s=latency, edp=calc_edp(energy, latency),
        n_evaluated=n_evaluated, n_feasible=n_feasible,
        n_workload_evals=n_workload_evals, wall_time_s=wall)


def _prefiltered(grid, wl, constraints, c, hierarchical, device):
    """(survivor subset, n_workload_evals) for one workload."""
    if not hierarchical:
        return grid, len(grid)
    sub = grid[hw_prefilter(grid, wl, constraints, c, device)]
    return sub, len(sub)


def _python_engine(grid, wl, constraints, c, hierarchical, device):
    r = _sequential_search(grid, wl, constraints, prune=hierarchical,
                           collect=False, c=c, edp_init=float("inf"))
    row = None if r.best_cfg is None else r.best_cfg.as_array()
    return _make_result(row, r.n_feasible, wl, c, len(grid),
                        r.n_workload_evals, r.wall_time_s)


def _numpy_engine(grid, wl, constraints, c, hierarchical, device):
    t0 = time.perf_counter()
    sub, n_wl = _prefiltered(grid, wl, constraints, c, hierarchical, device)
    if len(sub) == 0:
        return _make_result(None, 0, wl, c, len(grid), 0,
                            time.perf_counter() - t0)
    m = evaluate_grid(sub, wl, c)
    ok = np.asarray(constraints.satisfied(m["area"], m["power"],
                                          m["energy"], m["latency"]))
    n_feasible = int(ok.sum())
    if n_feasible == 0:
        return _make_result(None, 0, wl, c, len(grid), n_wl,
                            time.perf_counter() - t0)
    edp = np.where(ok, m["edp"], np.inf)
    return _make_result(sub[int(np.argmin(edp))], n_feasible, wl, c,
                        len(grid), n_wl, time.perf_counter() - t0)


def _cuda_engine(grid, wl, constraints, c, hierarchical, device):
    from ..kernels.ops import dse_search_grid  # deferred: kernels import core
    t0 = time.perf_counter()
    sub, n_wl = _prefiltered(grid, wl, constraints, c, hierarchical, device)
    if len(sub) == 0:
        return _make_result(None, 0, wl, c, len(grid), 0,
                            time.perf_counter() - t0)
    i, _, nf = dse_search_grid(sub, wl, constraints, c, device)
    row = sub[i] if i >= 0 else None
    return _make_result(row, nf, wl, c, len(grid), n_wl,
                        time.perf_counter() - t0)


def _constraint_vec(constraints, device) -> torch.Tensor:
    """The (4,) float32 [area, power, energy, latency] bounds on `device`."""
    return torch.tensor([constraints.area_mm2, constraints.power_w,
                         constraints.energy_j, constraints.latency_s],
                        dtype=torch.float32, device=device)


def _torch_grid_metrics(cols, wl, c):
    """Float32 metric tensors of (5, G) float32 config columns: the jax
    engine's `eval_wload_arrays` and `eval_hw` (xp=jnp), on the columns'
    device."""
    gemms, scalars = workload_statics(wl, c)
    n = tuple(cols[i] for i in range(5))
    energy, latency, util = eval_wload_tensors(
        *n, gemm_tensor(gemms, cols.device), *scalars[:3], scalars[3], c)
    area, power = eval_hw(*n, scalars[3], c)
    return {"area": area, "power": power, "energy": energy,
            "latency": latency, "util": util, "edp": energy * latency}


def _torch_feasible(m, valid, cons):
    """Feasibility mask of float32 metric tensors under (4,) bounds."""
    ok = ((m["area"] < cons[0]) & (m["power"] < cons[1])
          & (m["energy"] < cons[2]) & (m["latency"] < cons[3]))
    return ok if valid is None else valid & ok


def _torch_argmin_t(m, ok):
    """[index, its float32 EDP, n_feasible] as a (3,) float64 tensor left
    on the device (exact: indices and counts stay below 2**53): the first
    lane of the least feasible EDP (jnp.argmin's first hit; +inf
    everywhere when none). A fan-out launches every shard's before any of
    them waits."""
    edp = torch.where(ok, m["edp"], scalar_tensor(np.inf, ok.device))
    i = torch.argmin(edp)
    return torch.stack([i.double(), edp[i].double(), ok.sum().double()])


def _torch_argmin(m, ok):
    """(index, its float32 EDP, n_feasible) of `_torch_argmin_t`."""
    i, e, nf = _torch_argmin_t(m, ok).tolist()
    return int(i), e, int(nf)


def _torch_search_fn(sub, wl, constraints, c, device):
    """(argmin index, its float32 EDP, n_feasible) of one workload over the
    candidate rows, in plain torch float32 on `device` (the jax engine's
    fused argmin)."""
    cols = torch.from_numpy(np.ascontiguousarray(np.asarray(sub).T,
                                                 np.float32)).to(device)
    m = _torch_grid_metrics(cols, wl, c)
    return _torch_argmin(m, _torch_feasible(
        m, None, _constraint_vec(constraints, device)))


def _combine_shard_argmins(parts, shard_size):
    """(shard-order index or -1, EDP, n_feasible) of the shards' [index,
    EDP, n_feasible] triples: the least EDP, the earliest shard on exact
    ties (shards are contiguous slices, so that is the global first hit)."""
    a = np.stack([p.cpu().numpy() for p in parts])
    nf = int(a[:, 2].sum())
    if nf == 0:
        return -1, float("inf"), 0
    s = int(np.lexsort((np.arange(len(a)), a[:, 1]))[0])
    return s * shard_size + int(a[s, 0]), float(a[s, 1]), nf


def _torch_sharded_argmin(sub, wl, constraints, c, mesh):
    """The torch engine's argmin fanned out over `mesh` (the reference's
    `_jax_sharded_argmin`): the rows padded to a k-multiple, each shard's
    contiguous slice reduced to (argmin, EDP, n_feasible) on its device,
    the shards combined on the host. Returns (index into `sub` or -1, its
    float32 EDP, n_feasible)."""
    k = len(mesh)
    cols, valid = _padded_candidate_cols(sub, k, "cpu")
    ss = cols.shape[1] // k
    parts = []
    for s, dev in enumerate(mesh):
        cols_s = cols[:, s * ss:(s + 1) * ss].to(dev)
        m = _torch_grid_metrics(cols_s, wl, c)
        parts.append(_torch_argmin_t(m, _torch_feasible(
            m, valid[s * ss:(s + 1) * ss].to(dev),
            _constraint_vec(constraints, dev))))
    return _combine_shard_argmins(parts, ss)


def _torch_engine(grid, wl, constraints, c, hierarchical, device):
    t0 = time.perf_counter()
    sub, n_wl = _prefiltered(grid, wl, constraints, c, hierarchical, device)
    if len(sub) == 0:
        return _make_result(None, 0, wl, c, len(grid), 0,
                            time.perf_counter() - t0)
    i, _, nf = _torch_search_fn(sub, wl, constraints, c, device)
    row = sub[i] if nf > 0 else None
    return _make_result(row, nf, wl, c, len(grid), n_wl,
                        time.perf_counter() - t0)


ENGINES = {"python": _python_engine, "numpy": _numpy_engine,
           "torch": _torch_engine, "cuda": _cuda_engine}


# ---------------------------------------------------------------------------
# Pareto-frontier search mode (objective="pareto"), same three engines
# ---------------------------------------------------------------------------

def _pareto_from_rows(rows, wl: Workload, constraints: Constraints,
                      c: DeviceConstants, objectives: tuple, m=None):
    """Exact float64 frontier over candidate rows.

    Every engine funnels its (possibly float32-proposed) candidate set
    through here: feasibility and dominance are re-decided by the numpy
    float64 reference model, and the frontier comes back in canonical
    lexicographic row order with reference-model metrics — so engines that
    agree on candidates return byte-identical `ParetoResult`s. Pass `m` to
    reuse already-computed `evaluate_grid` metrics for `rows`.

    Returns (front_rows, metrics, n_feasible_in_rows).
    """
    rows = np.asarray(rows, dtype=np.int64).reshape(-1, 5)
    empty = (np.zeros((0, 5), np.int64),
             {k: np.zeros(0, np.float64) for k in REPORT_METRICS}, 0)
    if len(rows) == 0:
        return empty
    if m is None:
        m = evaluate_grid(rows, wl, c)
    ok = np.asarray(constraints.satisfied(m["area"], m["power"], m["energy"],
                                          m["latency"]))
    if not ok.any():
        return empty
    pts = np.stack([np.asarray(m[k], np.float64)[ok] for k in objectives],
                   axis=1)
    mask = pareto_mask(pts)
    front = rows[ok][mask]
    order = np.lexsort(front.T[::-1])
    sel = np.where(ok)[0][mask][order]
    met = {k: np.asarray(m[k], np.float64)[sel] for k in REPORT_METRICS}
    return front[order], met, int(ok.sum())


def _sequential_pareto(grid, wl: Workload, constraints: Constraints,
                       prune: bool, c: DeviceConstants, objectives: tuple):
    """Alg. 2-style sequential oracle for the frontier: stream the grid,
    maintain the running non-dominated set incrementally (dominated
    newcomers are rejected, newly-dominated incumbents evicted, exact ties
    kept). Returns (front_rows, n_feasible, n_workload_evals)."""
    sram_mb = sram_mb_for_workload(wl.max_act_bytes, c)
    gemms = wl.gemm_array
    front_rows: list = []
    front_pts: list = []
    n_wl = 0
    n_feasible = 0
    for row in grid:
        n_t, n_c, n_h, n_v, n_l = (int(x) for x in row)
        area, power = eval_hw(n_t, n_c, n_h, n_v, n_l, sram_mb, c)
        hw_ok = (area < constraints.area_mm2) and (power < constraints.power_w)
        if prune and not hw_ok:
            continue
        energy, latency, util = eval_wload_arrays(
            n_t, n_c, n_h, n_v, n_l, gemms, wl.elec_ops, wl.weight_bytes,
            wl.act_io_bytes, sram_mb, c)
        energy, latency = float(energy), float(latency)
        n_wl += 1
        if not (hw_ok and (energy < constraints.energy_j)
                and (latency < constraints.latency_s)):
            continue
        n_feasible += 1
        vals = {"area": float(area), "power": float(power), "energy": energy,
                "latency": latency, "util": float(util),
                "edp": calc_edp(energy, latency)}
        p = np.array([vals[k] for k in objectives], np.float64)
        if front_pts:
            fr = np.asarray(front_pts)
            if bool(np.any(np.all(fr <= p, axis=1) & np.any(fr < p, axis=1))):
                continue
            keep = ~(np.all(p <= fr, axis=1) & np.any(p < fr, axis=1))
            front_rows = [r for r, k in zip(front_rows, keep) if k]
            front_pts = [q for q, k in zip(front_pts, keep) if k]
        front_rows.append(np.asarray(row))
        front_pts.append(p)
    return front_rows, n_feasible, n_wl


def _pareto_result(cand_rows, n_feasible, wl, constraints, c, objectives,
                   n_evaluated, n_wl, t0) -> ParetoResult:
    front, met, _ = _pareto_from_rows(cand_rows, wl, constraints, c,
                                      objectives)
    return ParetoResult(front=front, metrics=met, objectives=objectives,
                        n_evaluated=n_evaluated, n_feasible=n_feasible,
                        n_workload_evals=n_wl,
                        wall_time_s=time.perf_counter() - t0)


def _pareto_python(grid, wl, constraints, c, hierarchical, device,
                   objectives):
    t0 = time.perf_counter()
    rows, n_feasible, n_wl = _sequential_pareto(grid, wl, constraints,
                                                hierarchical, c, objectives)
    cand = np.asarray(rows, np.int64).reshape(-1, 5)
    return _pareto_result(cand, n_feasible, wl, constraints, c, objectives,
                          len(grid), n_wl, t0)


def _pareto_numpy(grid, wl, constraints, c, hierarchical, device,
                  objectives):
    t0 = time.perf_counter()
    sub, n_wl = _prefiltered(grid, wl, constraints, c, hierarchical, device)
    if len(sub) == 0:
        return _pareto_result(sub, 0, wl, constraints, c, objectives,
                              len(grid), 0, t0)
    m = evaluate_grid(sub, wl, c)
    front, met, n_feasible = _pareto_from_rows(sub, wl, constraints, c,
                                               objectives, m=m)
    return ParetoResult(front=front, metrics=met, objectives=objectives,
                        n_evaluated=len(grid), n_feasible=n_feasible,
                        n_workload_evals=n_wl,
                        wall_time_s=time.perf_counter() - t0)


def _pareto_cuda(grid, wl, constraints, c, hierarchical, device,
                 objectives):
    from ..kernels.ops import dse_pareto_multi
    t0 = time.perf_counter()
    sub, n_wl = _prefiltered(grid, wl, constraints, c, hierarchical, device)
    if len(sub) == 0:
        return _pareto_result(sub, 0, wl, constraints, c, objectives,
                              len(grid), 0, t0)
    (cand_idx, nf, n_over), = dse_pareto_multi(sub, [wl], [constraints], c,
                                               device, objectives=objectives)
    r = _pareto_result(sub[cand_idx], nf, wl, constraints, c, objectives,
                       len(grid), n_wl, t0)
    r.n_overflow = n_over
    return r


# Sorted points per scan step and running-frontier buffer bound of the torch
# sort-and-scan dominance pass (the jax engine's JAX_PARETO_CHUNK and
# JAX_PARETO_MAX_FRONT). An overflowing buffer only grows the candidate
# superset (never drops a true frontier point) — the host refinement
# restores exactness — so the bound is a performance knob, not a limit.
TORCH_PARETO_CHUNK = 2048
TORCH_PARETO_MAX_FRONT = 256


def _dominated_by(a, p):
    """(len(p), len(a)) mask: [i, j] when row a[j] is <= p[i] in every
    objective and < in one (jnp.all / jnp.any over the objectives)."""
    le = torch.ones((p.shape[0], a.shape[0]), dtype=torch.bool,
                    device=p.device)
    lt = torch.zeros_like(le)
    for k in range(p.shape[1]):
        le &= a[None, :, k] <= p[:, None, k]
        lt |= a[None, :, k] < p[:, None, k]
    return le & lt


def _pareto_scan_mask(objs) -> np.ndarray:
    """Sort-and-scan dominance pass over already-masked objective vectors,
    step for step the jax engine's.

    objs: equal-length float32 tensors on one device (length a
    TORCH_PARETO_CHUNK multiple), infeasible and padding rows already +inf.
    The rows are lex-sorted (stable sorts, least significant objective
    first: ties keep their input order, as jnp.lexsort's), so a dominator
    precedes what it dominates, then scanned in chunks against a bounded
    running-frontier buffer (survivors join it in order, the rows past
    TORCH_PARETO_MAX_FRONT drop out) and the earlier rows of their own
    chunk. A row whose first objective is not finite sorts after every
    finite one and can neither survive nor join the buffer, so the scan
    stops at the chunk that holds the last finite row. Returns the (n,)
    boolean candidate mask in input order.
    """
    n = objs[0].shape[0]
    dev = objs[0].device
    order = torch.arange(n, device=dev)
    for o in reversed(objs):
        order = order[torch.sort(o[order], stable=True).indices]
    pts = torch.stack([o[order] for o in objs], dim=1)
    n_live = int(torch.isfinite(pts[:, 0]).sum())
    cs, cap = TORCH_PARETO_CHUNK, TORCH_PARETO_MAX_FRONT
    inf = scalar_tensor(np.inf, dev)
    earlier = torch.ones((cs, cs), dtype=torch.bool, device=dev).tril(-1)
    pos = torch.arange(cap + cs, device=dev)
    buf = torch.full((cap, len(objs)), np.inf, dtype=torch.float32,
                     device=dev)
    surv = torch.zeros(n, dtype=torch.bool, device=dev)
    for s in range(0, n_live, cs):
        p = pts[s:s + cs]
        ok = (torch.isfinite(p[:, 0]) & ~_dominated_by(buf, p).any(dim=1)
              & ~(_dominated_by(p, p) & earlier).any(dim=1))
        pool = torch.cat([buf, torch.where(ok[:, None], p, inf)])
        key = torch.where(torch.isfinite(pool[:, 0]), pos, pos.numel())
        buf = pool[torch.argsort(key, stable=True)[:cap]]
        surv[s:s + cs] = ok
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    mask[order] = surv
    return mask.cpu().numpy()


def _padded_candidate_cols(sub, multiple: int, device):
    """((5, n_pad) float32 cols, (n_pad,) bool validity) on `device`, the
    candidate axis padded to a `multiple` multiple with all-ones configs
    (valid model inputs, no division by zero), masked invalid."""
    n = len(sub)
    pad = (-n) % multiple
    cols = np.ones((5, n + pad), np.float32)
    cols[:, :n] = np.asarray(sub).T
    valid = np.zeros(n + pad, bool)
    valid[:n] = True
    return (torch.from_numpy(cols).to(device),
            torch.from_numpy(valid).to(device))


def _torch_front_mask(m, ok, objectives):
    """Candidate mask of the feasible lanes' frontier: each objective +inf
    where infeasible, then the scan."""
    inf = scalar_tensor(np.inf, ok.device)
    return _pareto_scan_mask([torch.where(ok, m[k], inf)
                              for k in objectives])


def _torch_sharded_pareto_mask(sub, wl, constraints, c, mesh, objectives):
    """The torch engine's frontier-candidate pass fanned out over `mesh`
    (the reference's `_jax_sharded_pareto_mask`): the rows padded to k
    shards of a TORCH_PARETO_CHUNK multiple, each shard reduced to its own
    non-dominated mask on its device — a superset of that slice's frontier
    members, so the union stays exact after the float64 refinement.
    Returns (mask over `sub`, n_feasible)."""
    k = len(mesh)
    cols, valid = _padded_candidate_cols(sub, k * TORCH_PARETO_CHUNK, "cpu")
    ss = cols.shape[1] // k
    masks = []
    nf = 0
    for s, dev in enumerate(mesh):
        m = _torch_grid_metrics(cols[:, s * ss:(s + 1) * ss].to(dev), wl, c)
        ok = _torch_feasible(m, valid[s * ss:(s + 1) * ss].to(dev),
                             _constraint_vec(constraints, dev))
        masks.append(_torch_front_mask(m, ok, objectives))
        nf += int(ok.sum())
    return np.concatenate(masks)[:len(sub)], nf


def _torch_pareto_fn(sub, wl, constraints, c, device, objectives):
    """(candidate mask over `sub`, n_feasible): the jax engine's fused
    frontier-candidate pass in plain torch float32 on `device`."""
    cols, valid = _padded_candidate_cols(sub, TORCH_PARETO_CHUNK, device)
    m = _torch_grid_metrics(cols, wl, c)
    ok = _torch_feasible(m, valid, _constraint_vec(constraints, device))
    return _torch_front_mask(m, ok, objectives)[:len(sub)], int(ok.sum())


def _pareto_torch(grid, wl, constraints, c, hierarchical, device,
                  objectives):
    t0 = time.perf_counter()
    sub, n_wl = _prefiltered(grid, wl, constraints, c, hierarchical, device)
    if len(sub) == 0:
        return _pareto_result(sub, 0, wl, constraints, c, objectives,
                              len(grid), 0, t0)
    mask, nf = _torch_pareto_fn(sub, wl, constraints, c, device, objectives)
    return _pareto_result(sub[mask], nf, wl, constraints, c, objectives,
                          len(grid), n_wl, t0)


PARETO_ENGINES = {"python": _pareto_python, "numpy": _pareto_numpy,
                  "torch": _pareto_torch, "cuda": _pareto_cuda}


# ---------------------------------------------------------------------------
# Streamed and sharded evaluation (chunk_size= / shard=): a running argmin
# (or frontier) carried across chunks of the grid — on cuda into the
# kernels' carry operands — and each chunk fanned out over the candidate
# mesh (cuda, torch) or split as many ways on the host (python, numpy), so
# every engine runs the same cross-shard reduction. Exact: any (shard,
# chunk_size) returns the one-shot sweep's bytes.
# ---------------------------------------------------------------------------

def _iter_chunks(grid, chunk_size: int):
    for s in range(0, len(grid), chunk_size):
        yield grid[s:s + chunk_size]


def _host_shards(chunk, shard):
    """The host engines' split of a chunk into `shard` contiguous parts
    (np.array_split sizes; at most one part a row) — the host counterpart
    of the device fan-out, at any device count."""
    if not shard or int(shard) <= 1 or len(chunk) == 0:
        return [chunk]
    return np.array_split(chunk, min(int(shard), len(chunk)))


def merge_running_best(carry, candidate):
    """Cross-chunk and cross-shard running-argmin reduction over (row, edp)
    pairs.

    Strict-< replacement: exact EDP ties keep the incumbent, which arrived
    from an earlier chunk or shard and therefore has the lower grid index —
    composed over any partition of the grid it reproduces the one-shot
    engines' first-hit argmin."""
    row, edp = candidate
    if row is not None and edp < carry[1]:
        return (row, edp)
    return carry


def _edp_chunk_python(chunk, wl, constraints, c, hierarchical, device,
                      shard):
    best = (None, float("inf"))
    nf = n_wl = 0
    for part in _host_shards(chunk, shard):
        r = _sequential_search(part, wl, constraints, prune=hierarchical,
                               collect=False, c=c, edp_init=float("inf"))
        nf += r.n_feasible
        n_wl += r.n_workload_evals
        row = None if r.best_cfg is None else r.best_cfg.as_array()
        best = merge_running_best(best, (row, r.edp))
    return best[0], best[1], nf, n_wl


def _edp_chunk_numpy(chunk, wl, constraints, c, hierarchical, device,
                     shard):
    best = (None, float("inf"))
    nf = n_wl = 0
    for part in _host_shards(chunk, shard):
        sub, nw = _prefiltered(part, wl, constraints, c, hierarchical,
                               device)
        n_wl += nw
        if len(sub) == 0:
            continue
        m = evaluate_grid(sub, wl, c)
        ok = np.asarray(constraints.satisfied(m["area"], m["power"],
                                              m["energy"], m["latency"]))
        nf += int(ok.sum())
        if not ok.any():
            continue
        edp = np.where(ok, m["edp"], np.inf)
        i = int(np.argmin(edp))
        best = merge_running_best(best, (sub[i], float(edp[i])))
    return best[0], best[1], nf, n_wl


def _edp_chunk_cuda(chunk, wl, constraints, c, hierarchical, device, shard,
                    carry_edp):
    from ..kernels.ops import dse_search_grid
    sub, n_wl = _prefiltered(chunk, wl, constraints, c, hierarchical, device)
    if len(sub) == 0:
        return None, float("inf"), 0, n_wl
    i, e, nf = dse_search_grid(sub, wl, constraints, c, device, shard=shard,
                               carry_edp=carry_edp)
    return (sub[i] if i >= 0 else None), e, nf, n_wl


def _edp_chunk_torch(chunk, wl, constraints, c, hierarchical, device,
                     shard):
    sub, n_wl = _prefiltered(chunk, wl, constraints, c, hierarchical, device)
    if len(sub) == 0:
        return None, float("inf"), 0, n_wl
    mesh = shard_mesh(shard, device)
    if mesh is not None:
        i, e, nf = _torch_sharded_argmin(sub, wl, constraints, c, mesh)
    else:
        i, e, nf = _torch_search_fn(sub, wl, constraints, c, device)
    if nf == 0:
        return None, float("inf"), 0, n_wl
    return sub[i], e, nf, n_wl


EDP_CHUNK_ENGINES = {"python": _edp_chunk_python, "numpy": _edp_chunk_numpy,
                     "torch": _edp_chunk_torch}


def _rt_fp(tag, wl, constraints, engine, c, device, shard, chunk_size,
           **extra):
    """Search-signature fingerprint binding a checkpoint directory to one
    exact search. Engine, device type and the (shard, chunk_size) shape are
    part of the signature: resume re-runs the tail on the engine and device
    the head ran on, cut the same way (degradation within a run is fine —
    engines are byte-identical — but resuming under another engine=,
    device= or shard= is a different campaign)."""
    return _fingerprint(tag=tag, wl=wl.name, gemms=wl.gemm_array,
                        act=int(wl.max_act_bytes), cons=repr(constraints),
                        engine=engine, c=repr(c), device=device.type,
                        shard=shard, chunk=chunk_size, **extra)


def _edp_chunk_thunks(chunk, wl, constraints, c, hierarchical, device, shard,
                      best):
    """Byte-identical per-engine evaluations of one streamed EDP chunk for
    the resilient runtime's retry / fallback / quarantine guard. Each
    returns host values, so an attempt ends when its launches have."""
    def cuda():
        carry = best[1] if best[0] is not None else None
        return _edp_chunk_cuda(chunk, wl, constraints, c, hierarchical,
                               device, shard, carry)

    thunks = {"cuda": cuda}
    for eng, fn in EDP_CHUNK_ENGINES.items():
        thunks[eng] = functools.partial(fn, chunk, wl, constraints, c,
                                        hierarchical, device, shard)
    return thunks


def _search_streamed(grid, wl, constraints, engine, hierarchical, c, device,
                     shard, chunk_size, rt=None) -> SearchResult:
    """Chunked (and sharded) min-EDP driver, any engine; under a runtime
    each chunk is one guarded, checkpointed unit."""
    t0 = time.perf_counter()
    n = len(grid)
    cs = int(chunk_size) if chunk_size else max(n, 1)
    best = (None, float("inf"))
    nf = n_wl = 0
    start = 0
    fp = None
    if rt is not None:
        fp = _rt_fp("edp_stream", wl, constraints, engine, c, device,
                    shard, chunk_size, grid=np.ascontiguousarray(grid),
                    hier=bool(hierarchical))
        rec = rt.resume(fp)
        if rec is not None:
            start, st, extra = rec
            best = decode_best_row(st)
            nf, n_wl = int(extra["nf"]), int(extra["n_wl"])
    for u, chunk in enumerate(_iter_chunks(grid, cs)):
        if u < start:
            continue
        thunks = _edp_chunk_thunks(chunk, wl, constraints, c, hierarchical,
                                   device, shard, best)
        # The cuda kernel folds the carried best into its own reduction
        # (carry wins ties), so per-chunk launches compose on device.
        row, e, cf, cw = (thunks[engine]() if rt is None
                          else rt.eval_unit(engine, thunks, device))
        nf += cf
        n_wl += cw
        best = merge_running_best(best, (row, e))
        if rt is not None:
            rt.unit_done(fp, u, encode_best_row(best),
                         {"nf": nf, "n_wl": n_wl})
    res = _make_result(best[0], nf, wl, c, n, n_wl, time.perf_counter() - t0)
    return rt.annotate(res) if rt is not None else res


def _pareto_chunk_python(chunk, wl, constraints, c, hierarchical, device,
                         shard, objectives):
    cands = []
    nf = n_wl = 0
    for part in _host_shards(chunk, shard):
        rows, f, nw = _sequential_pareto(part, wl, constraints, hierarchical,
                                         c, objectives)
        cands += list(rows)
        nf += f
        n_wl += nw
    return np.asarray(cands, np.int64).reshape(-1, 5), nf, n_wl


def _pareto_chunk_numpy(chunk, wl, constraints, c, hierarchical, device,
                        shard, objectives):
    cands = []
    nf = n_wl = 0
    for part in _host_shards(chunk, shard):
        sub, nw = _prefiltered(part, wl, constraints, c, hierarchical,
                               device)
        n_wl += nw
        if len(sub) == 0:
            continue
        m = evaluate_grid(sub, wl, c)
        front, _, f = _pareto_from_rows(sub, wl, constraints, c, objectives,
                                        m=m)
        nf += f
        cands.append(front)
    if not cands:
        return np.zeros((0, 5), np.int64), nf, n_wl
    return np.concatenate(cands, axis=0), nf, n_wl


def _cuda_front_points(rows, wl, c, device, objectives):
    """Objective points of `rows` in the frontier kernels' own float32
    metric space (the dse_eval kernel runs the identical cost model), so
    the carried-front prune compares like with like."""
    from ..kernels.ops import dse_eval_grid
    m = dse_eval_grid(rows, wl, c, device).astype(np.float32)
    vals = {"area": m[:, 0], "power": m[:, 1], "energy": m[:, 2],
            "latency": m[:, 3], "edp": m[:, 2] * m[:, 3]}
    return np.stack([vals[k] for k in objectives], axis=1)


def _pareto_chunk_cuda(chunk, wl, constraints, c, hierarchical, device,
                       shard, objectives, carry_rows):
    from ..kernels.ops import dse_pareto_multi
    sub, n_wl = _prefiltered(chunk, wl, constraints, c, hierarchical, device)
    if len(sub) == 0:
        return np.zeros((0, 5), np.int64), 0, n_wl, 0
    carry_points = None
    if carry_rows is not None and len(carry_rows):
        carry_points = [_cuda_front_points(carry_rows, wl, c, device,
                                           objectives)]
    (idx, nf, n_over), = dse_pareto_multi(sub, [wl], [constraints], c,
                                          device, objectives=objectives,
                                          shard=shard,
                                          carry_points=carry_points)
    return sub[idx], nf, n_wl, n_over


def _pareto_chunk_torch(chunk, wl, constraints, c, hierarchical, device,
                        shard, objectives):
    sub, n_wl = _prefiltered(chunk, wl, constraints, c, hierarchical, device)
    if len(sub) == 0:
        return np.zeros((0, 5), np.int64), 0, n_wl
    mesh = shard_mesh(shard, device)
    if mesh is not None:
        mask, nf = _torch_sharded_pareto_mask(sub, wl, constraints, c, mesh,
                                              objectives)
    else:
        mask, nf = _torch_pareto_fn(sub, wl, constraints, c, device,
                                    objectives)
    return sub[mask], nf, n_wl


PARETO_CHUNK_ENGINES = {"python": _pareto_chunk_python,
                        "numpy": _pareto_chunk_numpy,
                        "torch": _pareto_chunk_torch}


def _empty_run_state():
    return (np.zeros((0, 5), np.int64),
            {k: np.zeros(0, np.float64) for k in REPORT_METRICS})


def _merge_running_front(run_rows, run_met, cand_rows, wl, constraints, c,
                         objectives):
    """Fold one chunk's (or shard's) candidate rows into the bounded
    running frontier: refine the candidates through the float64 reference
    model, then keep the non-dominated union (`pareto.merge_fronts` — exact
    ties kept, so duplicate grid rows survive streaming like they survive
    the one-shot sweep). A strictly dominated point can never re-enter, so
    dropping it is exact."""
    from .pareto import merge_fronts
    front_c, met_c, _ = _pareto_from_rows(cand_rows, wl, constraints, c,
                                          objectives)
    if len(front_c) == 0:
        return run_rows, run_met
    d = len(objectives)
    pts_a = (np.stack([run_met[k] for k in objectives], axis=1)
             if len(run_rows) else np.zeros((0, d)))
    pts_b = np.stack([met_c[k] for k in objectives], axis=1)
    keep = merge_fronts(pts_a, pts_b)
    rows = np.concatenate([run_rows, front_c], axis=0)[keep]
    met = {k: np.concatenate([run_met[k], met_c[k]])[keep]
           for k in REPORT_METRICS}
    return rows, met


def _front_result(run_rows, run_met, wl, constraints, c, objectives,
                  n_evaluated, nf, n_wl, wall, **counters) -> ParetoResult:
    """The ParetoResult of a running frontier (already float64-refined)."""
    front, met, _ = _pareto_from_rows(run_rows, wl, constraints, c,
                                      objectives, m=run_met)
    return ParetoResult(front=front, metrics=met, objectives=objectives,
                        n_evaluated=n_evaluated, n_feasible=nf,
                        n_workload_evals=n_wl, wall_time_s=wall, **counters)


def _pareto_chunk_thunks(chunk, wl, constraints, c, hierarchical, device,
                         shard, objectives, run_rows):
    """Per-engine streamed-frontier chunk evaluations, normalized to
    (cand_rows, n_feasible, n_wl, n_overflow) for the runtime guard."""
    def cuda():
        return _pareto_chunk_cuda(chunk, wl, constraints, c, hierarchical,
                                  device, shard, objectives, run_rows)

    def host(eng):
        cand, cf, cw = PARETO_CHUNK_ENGINES[eng](
            chunk, wl, constraints, c, hierarchical, device, shard,
            objectives)
        return cand, cf, cw, 0

    thunks = {"cuda": cuda}
    for eng in PARETO_CHUNK_ENGINES:
        thunks[eng] = functools.partial(host, eng)
    return thunks


def _pareto_streamed(grid, wl, constraints, engine, hierarchical, c, device,
                     objectives, shard, chunk_size, rt=None) -> ParetoResult:
    """Chunked (and sharded) frontier search, any engine: a running
    (float64-refined) frontier carried across chunks — into the kernels on
    cuda."""
    t0 = time.perf_counter()
    n = len(grid)
    cs = int(chunk_size) if chunk_size else max(n, 1)
    run_rows, run_met = _empty_run_state()
    nf = n_wl = n_over = 0
    start = 0
    fp = None
    if rt is not None:
        fp = _rt_fp("pareto_stream", wl, constraints, engine, c, device,
                    shard, chunk_size, grid=np.ascontiguousarray(grid),
                    hier=bool(hierarchical), objectives=tuple(objectives))
        rec = rt.resume(fp)
        if rec is not None:
            start, st, extra = rec
            run_rows, run_met = decode_front(st, REPORT_METRICS)
            nf, n_wl = int(extra["nf"]), int(extra["n_wl"])
            n_over = int(extra["n_over"])
    for u, chunk in enumerate(_iter_chunks(grid, cs)):
        if u < start:
            continue
        thunks = _pareto_chunk_thunks(chunk, wl, constraints, c, hierarchical,
                                      device, shard, objectives, run_rows)
        cand, cf, cw, co = (thunks[engine]() if rt is None
                            else rt.eval_unit(engine, thunks, device))
        nf += cf
        n_wl += cw
        n_over += co
        if len(cand):
            run_rows, run_met = _merge_running_front(
                run_rows, run_met, cand, wl, constraints, c, objectives)
        if rt is not None:
            rt.unit_done(fp, u, encode_front(run_rows, run_met,
                                             REPORT_METRICS),
                         {"nf": nf, "n_wl": n_wl, "n_over": n_over})
    res = _front_result(run_rows, run_met, wl, constraints, c, objectives,
                        n, nf, n_wl, time.perf_counter() - t0,
                        n_overflow=n_over)
    return rt.annotate(res) if rt is not None else res


# ---------------------------------------------------------------------------
# Factorized product-space evaluation (factorized=True)
# ---------------------------------------------------------------------------

FACTORIZED_ENGINES = ("numpy", "torch", "cuda")


def _factorized_space(space, grid, n_z, engine, hierarchical
                      ) -> FactorizedSpace:
    if engine not in FACTORIZED_ENGINES:
        raise ValueError(f"factorized=True supports engines "
                         f"{FACTORIZED_ENGINES}, not {engine!r}")
    if grid is not None:
        raise ValueError("factorized=True evaluates a product space; pass "
                         "the candidate sets via space= (or n_z=), not a "
                         "materialized grid")
    if hierarchical:
        raise ValueError("hierarchical=True is incompatible with "
                         "factorized=True: survivor compaction would break "
                         "the product structure (the factorized combine "
                         "already evaluates area/power at axis-table cost)")
    fspace = (FactorizedSpace.full(n_z) if space is None
              else FactorizedSpace.from_space(space))
    if engine == "cuda" and fspace.size > 1 << 24:
        raise ValueError(
            f"the factorized cuda engine addresses configs by float32 "
            f"global index, exact only below 2**24 points; this space has "
            f"{fspace.size}. Use the numpy factorized engine (exact integer "
            f"indices) for spaces this large.")
    return fspace


def _span_parts(start: int, n: int, shard):
    """Contiguous sub-spans of [start, start + n) for the host engines'
    shard split — the sizes of np.array_split, as `_host_shards`."""
    if not shard or int(shard) <= 1 or n == 0:
        return [(start, start + n)]
    k = min(int(shard), n)
    base, rem = divmod(n, k)
    parts, s = [], start
    for i in range(k):
        size = base + (1 if i < rem else 0)
        parts.append((s, s + size))
        s += size
    return parts


def _np_factorized_metrics(fspace, wl, c, start, stop):
    """Float64 factorized metrics for an index span (the whole space goes
    through the index-free broadcast combine)."""
    if (start, stop) == (0, fspace.size):
        return factorized_evaluate_grid(fspace, wl, c)
    return factorized_evaluate_grid(
        fspace, wl, c, idx=np.arange(start, stop, dtype=np.int64))


def _merge_best_indexed(best, cand):
    """Running argmin over (global index, edp) pairs: strictly lower EDP
    wins, exact EDP ties go to the lower flat-space index. Index -1 (or
    CARRY_IDX) means 'no candidate'."""
    gi, ge = cand
    if gi < 0:
        return best
    bi, be = best
    if bi < 0 or ge < be or (ge == be and gi < bi):
        return cand
    return best


def _edp_from_metrics(m, constraints, index_of):
    """(best gidx or -1, its EDP, n_feasible) of float64 metric arrays."""
    ok = np.asarray(constraints.satisfied(m["area"], m["power"],
                                          m["energy"], m["latency"]))
    if not ok.any():
        return -1, float("inf"), 0
    edp = np.where(ok, m["edp"], np.inf)
    i = int(np.argmin(edp))
    return index_of(i), float(edp[i]), int(ok.sum())


def _edp_span_numpy_factorized(fspace, wl, constraints, c, start, n,
                               shard):
    """(best gidx or -1, EDP, n_feasible) over an index span, split into
    `shard` host parts."""
    best = (-1, float("inf"))
    nf = 0
    for s0, s1 in _span_parts(start, n, shard):
        m = _np_factorized_metrics(fspace, wl, c, s0, s1)
        gi, e, f = _edp_from_metrics(m, constraints, lambda i: s0 + i)
        nf += f
        best = _merge_best_indexed(best, (gi, e))
    return best[0], best[1], nf


def _edp_idx_numpy(fspace, wl, constraints, c, idx_arr, shard):
    """(best gidx or -1, EDP, n_feasible) over an explicit ascending
    flat-index vector, float64 metrics, split into `shard` host parts —
    the numpy bound-guided leaf."""
    best = (-1, float("inf"))
    nf = 0
    for part in _host_shards(np.asarray(idx_arr, np.int64), shard):
        if len(part) == 0:
            continue
        m = factorized_evaluate_grid(fspace, wl, c, idx=part)
        gi, e, f = _edp_from_metrics(m, constraints,
                                     lambda i, part=part: int(part[i]))
        nf += f
        best = _merge_best_indexed(best, (gi, e))
    return best[0], best[1], nf


def _iter_spans(size: int, chunk_size):
    cs = int(chunk_size) if chunk_size else max(size, 1)
    for s in range(0, size, cs):
        yield s, min(cs, size - s)


def _edp_span_thunks(fspace, wl, constraints, c, device, shard, s, n, best):
    """Per-engine factorized EDP span evaluations, normalized to
    (gidx or -1/CARRY_IDX, edp, n_feasible) for the runtime guard."""
    def cuda():
        from ..kernels.ops import dse_search_multi_factorized
        carry = best[1] if best[0] >= 0 else None
        (gi,), (e,), (cf,) = dse_search_multi_factorized(
            fspace, s, n, [wl], [constraints], c, device, shard=shard,
            carry_edp=None if carry is None else [carry])
        return gi, e, cf

    return {"cuda": cuda,
            "torch": functools.partial(_edp_span_torch_factorized, fspace,
                                       wl, constraints, c, device, s, n,
                                       shard),
            "numpy": functools.partial(_edp_span_numpy_factorized, fspace,
                                       wl, constraints, c, s, n, shard)}


def _search_factorized(fspace, wl, constraints, engine, c, device, shard,
                       chunk_size, rt=None) -> SearchResult:
    """Factorized min-EDP driver (one-shot is the single-span case)."""
    t0 = time.perf_counter()
    best = (-1, float("inf"))
    nf = n_wl = 0
    start = 0
    fp = None
    if rt is not None:
        fp = _rt_fp("edp_fact", wl, constraints, engine, c, device, shard,
                    chunk_size, axes=fspace.axes)
        rec = rt.resume(fp)
        if rec is not None:
            start, st, extra = rec
            best = decode_best_indexed(st)
            nf, n_wl = int(extra["nf"]), int(extra["n_wl"])
    for u, (s, n) in enumerate(_iter_spans(fspace.size, chunk_size)):
        if u < start:
            continue
        thunks = _edp_span_thunks(fspace, wl, constraints, c, device, shard,
                                  s, n, best)
        gi, e, cf = (thunks[engine]() if rt is None
                     else rt.eval_unit(engine, thunks, device))
        nf += cf
        n_wl += n
        best = _merge_best_indexed(best, (gi, e))
        if rt is not None:
            rt.unit_done(fp, u, encode_best_indexed(best),
                         {"nf": nf, "n_wl": n_wl})
    row = fspace.decode([best[0]])[0] if best[0] >= 0 else None
    res = _make_result(row, nf, wl, c, fspace.size, n_wl,
                       time.perf_counter() - t0)
    return rt.annotate(res) if rt is not None else res


def _front_candidates_of(m, constraints, objectives, index_of):
    """(candidate gidx array, n_feasible) of float64 metric arrays: the
    exact frontier members among the feasible points."""
    ok = np.asarray(constraints.satisfied(m["area"], m["power"],
                                          m["energy"], m["latency"]))
    f = int(ok.sum())
    if f == 0:
        return np.zeros(0, np.int64), 0
    pts = np.stack([np.asarray(m[k], np.float64)[ok] for k in objectives],
                   axis=1)
    return index_of(np.where(ok)[0][pareto_mask(pts)]), f


def _concat_candidates(cands):
    return np.concatenate(cands) if cands else np.zeros(0, np.int64)


def _pareto_idx_numpy(fspace, wl, constraints, c, idx_arr, shard,
                      objectives):
    """Frontier candidates (gidx array) + feasible count over an explicit
    ascending flat-index vector, float64 metrics, split into `shard` host
    parts — the numpy bound-guided leaf."""
    cands = []
    nf = 0
    for part in _host_shards(np.asarray(idx_arr, np.int64), shard):
        if len(part) == 0:
            continue
        m = factorized_evaluate_grid(fspace, wl, c, idx=part)
        cand, f = _front_candidates_of(m, constraints, objectives,
                                       lambda i, part=part: part[i])
        nf += f
        cands.append(cand)
    return _concat_candidates(cands), nf


def _pareto_span_numpy_factorized(fspace, wl, constraints, c, start, n,
                                  shard, objectives):
    """(candidate gidx array, n_feasible) over a contiguous index span,
    split into `shard` host parts (the whole-space span takes the
    index-free broadcast combine)."""
    cands = []
    nf = 0
    for s0, s1 in _span_parts(start, n, shard):
        m = _np_factorized_metrics(fspace, wl, c, s0, s1)
        cand, f = _front_candidates_of(m, constraints, objectives,
                                       lambda i, s0=s0: s0 + i)
        nf += f
        cands.append(cand)
    return _concat_candidates(cands), nf


def _torch_space_metrics(fspace, wl, c, device, idx=None):
    """Float32 factorized metric tensors on `device` (the jax engines'
    `evaluate_space(..., xp=jnp, col_dtype=np.float32)`): the whole space,
    or the flat indices of the int64 tensor `idx`."""
    gemms, scalars = workload_statics(wl, c)
    return evaluate_space_tensors(fspace.axes, gemm_tensor(gemms, device),
                                  *scalars[:3], scalars[3], c, idx=idx)


def _torch_factorized_full_fn(fspace, wl, constraints, c, device,
                              objectives):
    """The whole product space by the broadcast combine: (argmin, EDP,
    n_feasible) for objectives=None, else (candidate mask, n_feasible)."""
    m = _torch_space_metrics(fspace, wl, c, device)
    ok = _torch_feasible(m, None, _constraint_vec(constraints, device))
    if objectives is None:
        return _torch_argmin(m, ok)
    pad = (-fspace.size) % TORCH_PARETO_CHUNK
    if pad:
        m = {k: torch.cat([m[k], torch.full((pad,), np.inf,
                                            dtype=torch.float32,
                                            device=device)])
             for k in objectives}
        ok = torch.cat([ok, torch.zeros(pad, dtype=torch.bool,
                                        device=device)])
    return (_torch_front_mask(m, ok, objectives)[:fspace.size],
            int(ok.sum()))


def _padded_idx_operands(idx_arr, multiple: int, device):
    """((n_pad,) int64 flat indices, (n_pad,) validity) on `device`, padded
    to a `multiple` multiple by repeating the last index (always
    decodable), the padding masked invalid. Eager torch compiles nothing
    per shape, so the jax engine's power-of-two bucketing has no
    counterpart."""
    idx_arr = np.asarray(idx_arr, np.int64)
    n = len(idx_arr)
    n_pad = max(1, -(-n // multiple)) * multiple
    out = np.full(n_pad, idx_arr[-1] if n else 0, np.int64)
    out[:n] = idx_arr
    valid = np.zeros(n_pad, bool)
    valid[:n] = True
    return (torch.from_numpy(out).to(device),
            torch.from_numpy(valid).to(device))


def _torch_factorized_span_fn(fspace, wl, constraints, c, device, idx,
                              valid, objectives):
    """An index vector by decode and table gathers: (argmin, EDP,
    n_feasible) for objectives=None, else (candidate mask, n_feasible)."""
    m = _torch_space_metrics(fspace, wl, c, device, idx)
    ok = _torch_feasible(m, valid, _constraint_vec(constraints, device))
    if objectives is None:
        return _torch_argmin(m, ok)
    return _torch_front_mask(m, ok, objectives), int(ok.sum())


def _torch_factorized_idx_argmin(fspace, wl, constraints, c, device,
                                 idx_arr, shard):
    """(best gidx or -1, its float32 EDP, n_feasible) over an explicit
    ascending flat-index vector; under `shard=` each contiguous slice of
    the (k-multiple padded) vector reduces on its own device of the mesh
    and the host combines them (the reference's sharded idx argmin)."""
    mesh = shard_mesh(shard, device)
    if mesh is not None:
        k = len(mesh)
        idx, valid = _padded_idx_operands(idx_arr, k, "cpu")
        ss = len(idx) // k
        parts = []
        for s, dev in enumerate(mesh):
            m = _torch_space_metrics(fspace, wl, c, dev,
                                     idx[s * ss:(s + 1) * ss].to(dev))
            parts.append(_torch_argmin_t(m, _torch_feasible(
                m, valid[s * ss:(s + 1) * ss].to(dev),
                _constraint_vec(constraints, dev))))
        i, e, nf = _combine_shard_argmins(parts, ss)
        return (int(idx[i]) if nf > 0 else -1), e, nf
    idx, valid = _padded_idx_operands(idx_arr, 1, device)
    i, e, nf = _torch_factorized_span_fn(fspace, wl, constraints, c, device,
                                         idx, valid, None)
    if nf == 0:
        return -1, float("inf"), 0
    return int(idx[i]), e, nf


def _edp_span_torch_factorized(fspace, wl, constraints, c, device, start,
                               n, shard):
    """(best gidx or -1, its float32 EDP, n_feasible) over an index span
    (the whole unsharded space by the broadcast combine)."""
    if (start, n) == (0, fspace.size) and shard_mesh(shard, device) is None:
        i, e, nf = _torch_factorized_full_fn(fspace, wl, constraints, c,
                                             device, None)
        return (i if nf > 0 else -1), e, nf
    return _torch_factorized_idx_argmin(
        fspace, wl, constraints, c, device,
        np.arange(start, start + n, dtype=np.int64), shard)


def _torch_factorized_idx_mask(fspace, wl, constraints, c, device, idx_arr,
                               shard, objectives):
    """(candidate gidx array, n_feasible) over an explicit ascending
    flat-index vector; padding lanes are invalid, so never candidates.
    Under `shard=` each slice of k shards of a TORCH_PARETO_CHUNK multiple
    is scanned on its own device of the mesh."""
    mesh = shard_mesh(shard, device)
    if mesh is None:
        idx, valid = _padded_idx_operands(idx_arr, TORCH_PARETO_CHUNK,
                                          device)
        mask, nf = _torch_factorized_span_fn(fspace, wl, constraints, c,
                                             device, idx, valid, objectives)
        return idx.cpu().numpy()[mask], nf
    k = len(mesh)
    idx, valid = _padded_idx_operands(idx_arr, k * TORCH_PARETO_CHUNK, "cpu")
    ss = len(idx) // k
    masks = []
    nf = 0
    for s, dev in enumerate(mesh):
        mask, f = _torch_factorized_span_fn(
            fspace, wl, constraints, c, dev, idx[s * ss:(s + 1) * ss].to(dev),
            valid[s * ss:(s + 1) * ss].to(dev), objectives)
        masks.append(mask)
        nf += f
    return idx.numpy()[np.concatenate(masks)], nf


def _pareto_span_torch_factorized(fspace, wl, constraints, c, device, start,
                                  n, shard, objectives):
    """(candidate gidx array, n_feasible) over an index span (the whole
    unsharded space by the broadcast combine)."""
    if (start, n) == (0, fspace.size) and shard_mesh(shard, device) is None:
        mask, nf = _torch_factorized_full_fn(fspace, wl, constraints, c,
                                             device, objectives)
        return np.nonzero(mask)[0], nf
    return _torch_factorized_idx_mask(
        fspace, wl, constraints, c, device,
        np.arange(start, start + n, dtype=np.int64), shard, objectives)


def _pareto_span_thunks(fspace, wl, constraints, c, device, objectives,
                        shard, s, n, run_rows):
    """Per-engine factorized frontier span evaluations, normalized to
    (candidate gidx array, n_feasible, n_overflow)."""
    def cuda():
        from ..kernels.ops import dse_pareto_multi_factorized
        carry_points = None
        if len(run_rows):
            carry_points = [_cuda_front_points(run_rows, wl, c, device,
                                               objectives)]
        (idx, cf, co), = dse_pareto_multi_factorized(
            fspace, s, n, [wl], [constraints], c, device,
            objectives=objectives, shard=shard, carry_points=carry_points)
        return idx, cf, co

    def torch_():
        idx, cf = _pareto_span_torch_factorized(fspace, wl, constraints, c,
                                                device, s, n, shard,
                                                objectives)
        return idx, cf, 0

    def numpy_():
        idx, cf = _pareto_span_numpy_factorized(fspace, wl, constraints, c,
                                                s, n, shard, objectives)
        return idx, cf, 0

    return {"cuda": cuda, "torch": torch_, "numpy": numpy_}


def _pareto_factorized(fspace, wl, constraints, engine, c, device,
                       objectives, shard, chunk_size, rt=None
                       ) -> ParetoResult:
    """Factorized frontier search (one-shot is the single-span case): a
    running frontier across spans, carried into the kernel on cuda."""
    t0 = time.perf_counter()
    run_rows, run_met = _empty_run_state()
    nf = n_wl = n_over = 0
    start = 0
    fp = None
    if rt is not None:
        fp = _rt_fp("pareto_fact", wl, constraints, engine, c, device,
                    shard, chunk_size, axes=fspace.axes,
                    objectives=tuple(objectives))
        rec = rt.resume(fp)
        if rec is not None:
            start, st, extra = rec
            run_rows, run_met = decode_front(st, REPORT_METRICS)
            nf, n_wl = int(extra["nf"]), int(extra["n_wl"])
            n_over = int(extra["n_over"])
    for u, (s, n) in enumerate(_iter_spans(fspace.size, chunk_size)):
        if u < start:
            continue
        thunks = _pareto_span_thunks(fspace, wl, constraints, c, device,
                                     objectives, shard, s, n, run_rows)
        idx, cf, co = (thunks[engine]() if rt is None
                       else rt.eval_unit(engine, thunks, device))
        nf += cf
        n_wl += n
        n_over += co
        if len(idx):
            run_rows, run_met = _merge_running_front(
                run_rows, run_met, fspace.decode(idx), wl, constraints, c,
                objectives)
        if rt is not None:
            rt.unit_done(fp, u, encode_front(run_rows, run_met,
                                             REPORT_METRICS),
                         {"nf": nf, "n_wl": n_wl, "n_over": n_over})
    res = _front_result(run_rows, run_met, wl, constraints, c, objectives,
                        fspace.size, nf, n_wl, time.perf_counter() - t0,
                        n_overflow=n_over)
    return rt.annotate(res) if rt is not None else res


# ---------------------------------------------------------------------------
# Bound-guided branch-and-bound (prune="bound")
#
# The product space is split into mixed-radix slabs, most Alg. 1-significant
# axis first; each slab is priced by admissible interval lower bounds
# (core.factorized.SlabBoundEvaluator) and discarded when they already
# violate a constraint or cannot beat the incumbent EDP — in pareto mode,
# when their objective lower-bound corner is strictly dominated by a
# running-frontier point (then every point of the slab is strictly
# dominated too, transitively safe even if that point is later evicted).
# Winners and frontiers are
# byte-identical to the unpruned sweep; the slab tree, traversal order and
# leaf size are fixed and engine-independent, so every engine and chunk_size
# visits identical survivors and returns identical counters.
# ---------------------------------------------------------------------------

BNB_LEAF = 4096  # slab size at or below which a surviving slab is evaluated
BNB_BATCH = 16384  # points per leaf-evaluation batch (incumbent refreshes)
BNB_FINE = 16  # slab size floor of the post-incumbent refinement


@functools.lru_cache(maxsize=8)
def _bnb_axis_order(c: DeviceConstants = CONSTANTS):
    """Meshgrid-axis indices ranked by Alg. 1 significance (descending),
    ties broken toward the slower-varying (outer) meshgrid axis."""
    from .factorized import AXIS_NAMES
    scores = observe_significance(c=c)
    return tuple(sorted(
        range(5),
        key=lambda ax: (-(scores[AXIS_NAMES[ax]].s_area
                          + scores[AXIS_NAMES[ax]].s_power), ax)))


def _bnb_infeasible_mask(lbs, constraints):
    """(B,) mask of slabs whose constraint lower bounds already violate a
    limit — every point inside is infeasible."""
    return ((np.asarray(lbs["area"]) >= constraints.area_mm2)
            | (np.asarray(lbs["power"]) >= constraints.power_w)
            | (np.asarray(lbs["energy"]) >= constraints.energy_j)
            | (np.asarray(lbs["latency"]) >= constraints.latency_s))


def _slab_sizes(ranges_list) -> np.ndarray:
    if len(ranges_list) == 0:
        return np.zeros(0, np.int64)
    arr = np.asarray(ranges_list, np.int64)
    return np.prod(arr[:, :, 1] - arr[:, :, 0], axis=1)


def _slab_first_indices(radices, ranges_list) -> np.ndarray:
    """(B,) first (lowest) flat index of each slab — the deterministic
    tie-break key of the best-first leaf ordering."""
    strides = np.ones(5, np.int64)
    for i in range(3, -1, -1):
        strides[i] = strides[i + 1] * int(radices[i + 1])
    if len(ranges_list) == 0:
        return np.zeros(0, np.int64)
    arr = np.asarray(ranges_list, np.int64)
    return arr[:, :, 0] @ strides


def _bnb_descend(ev, prune_mask_fn, start, start_lbs, leaf_size, stats, c,
                 led=None):
    """Slab-tree descent: process the active (B, 5, 2) digit-range array
    level by level — one vectorized `lower_bounds_batch` call plus one
    vectorized halving of the survivors along the significance order per
    level. Returns the surviving ((L, 5, 2) leaves, {metric: (L,) bounds}).
    With a `LedgerRecorder` attached every pruned slab is recorded with the
    bounds it was priced at."""
    order = np.asarray(_bnb_axis_order(c))
    active, lbs = np.asarray(start, np.int64).reshape(-1, 5, 2), start_lbs
    leaf_parts = []
    leaf_lbs = []
    while len(active):
        die = prune_mask_fn(lbs)
        widths = active[:, :, 1] - active[:, :, 0]
        sizes = np.prod(widths, axis=1)
        stats["n_pruned"] += int(sizes[die].sum())
        if led is not None:
            led.prune(active[die], {k: v[die] for k, v in lbs.items()})
        keep = ~die
        is_leaf = keep & (sizes <= leaf_size)
        leaf_parts.append(active[is_leaf])
        leaf_lbs.append({k: v[is_leaf] for k, v in lbs.items()})
        sub = active[keep & ~is_leaf]
        if not len(sub):
            break
        # Each slab splits its most significant axis with width > 1 at
        # mid = (lo + hi) // 2.
        wid = (sub[:, :, 1] - sub[:, :, 0])[:, order] > 1
        ax = order[np.argmax(wid, axis=1)]
        rows = np.arange(len(sub))
        lo = sub[rows, ax, 0]
        hi = sub[rows, ax, 1]
        mid = (lo + hi) // 2
        left = sub.copy()
        left[rows, ax, 1] = mid
        right = sub.copy()
        right[rows, ax, 0] = mid
        active = np.concatenate([left, right])
        lbs = ev.lower_bounds_batch(active)
        stats["n_bounds"] += len(active)
    leaves = (np.concatenate(leaf_parts) if leaf_parts
              else np.zeros((0, 5, 2), np.int64))
    out_lbs = {k: (np.concatenate([d[k] for d in leaf_lbs])
                   if leaf_lbs else np.zeros(0))
               for k in REPORT_METRICS}
    return leaves, out_lbs


def _bnb_frontier(fspace, ev, constraints, c, stats, led=None):
    """Constraint-driven descent from the whole space to BNB_LEAF leaves."""
    from .factorized import full_ranges
    root = np.asarray([full_ranges(fspace.radices)], np.int64)
    lbs = ev.lower_bounds_batch(root)
    stats["n_bounds"] += 1
    return _bnb_descend(ev, lambda b: _bnb_infeasible_mask(b, constraints),
                        root, lbs, BNB_LEAF, stats, c, led)


def _bnb_dominated_vs(pts: np.ndarray, lbs_arrays, objectives) -> np.ndarray:
    """(B,) mask of slabs whose objective lower-bound corner is strictly
    dominated by some point of `pts` ((F, d) float64 objective rows). Every
    point of such a slab is at or above the corner in every objective, so
    it is strictly dominated too."""
    corners = np.stack([np.asarray(lbs_arrays[k], np.float64)
                        for k in objectives], axis=1)
    if not len(pts):
        return np.zeros(len(corners), bool)
    le = np.all(pts[None, :, :] <= corners[:, None, :], axis=-1)
    lt = np.any(pts[None, :, :] < corners[:, None, :], axis=-1)
    return np.any(le & lt, axis=1)


@dataclasses.dataclass
class WarmStart:
    """Seed state for a warm-started bound-guided driver.

    The constraint-delta path of `repro_torch.serve.SearchService` re-prices
    a prior search's `SlabLedger` against a new constraint box and hands
    the slabs it could not kill to the BnB drivers through this object
    instead of the root descent: `start` (with its stored `lbs`) replaces
    the `_bnb_frontier` leaf set, `best` / `nf` seed the EDP driver's
    running argmin and incumbent with the best already-known feasible
    point, and `rows` / `met` seed the pareto driver's running
    (float64-refined) frontier. The seeds are true achievable values and
    the stored bounds are admissible, so the warm drivers return the same
    winners and frontiers as a cold search of the whole space under the new
    box.
    """

    start: np.ndarray                      # (B, 5, 2) slabs still to search
    lbs: Optional[Dict[str, np.ndarray]] = None  # their stored lower bounds
    best: tuple = (-1, float("inf"))       # EDP mode: (gidx, float64 edp)
    nf: int = 0                            # feasible count already known
    rows: Optional[np.ndarray] = None      # pareto mode: (F, 5) seed rows
    met: Optional[Dict[str, np.ndarray]] = None  # their metric columns


def _warm_leaves(warm, ev, stats):
    """(leaves, their lower bounds) of a WarmStart: the stored bounds when
    it carries them, else priced here (and counted)."""
    leaves = np.asarray(warm.start, np.int64).reshape(-1, 5, 2)
    if warm.lbs is not None and len(leaves):
        lbs = {k: np.asarray(warm.lbs[k], np.float64)
               for k in REPORT_METRICS}
    elif len(leaves):
        lbs = ev.lower_bounds_batch([tuple(tuple(r) for r in rng)
                                     for rng in leaves])
        stats["n_bounds"] += len(leaves)
    else:
        lbs = {k: np.zeros(0) for k in REPORT_METRICS}
    return leaves, lbs


def _check_warm(warm, rt, led):
    if warm is not None and rt is not None:
        raise ValueError("warm= cannot combine with a runtime: checkpoint "
                         "the cold search, re-price deltas warm")
    if warm is not None and led is not None:
        raise ValueError("warm= cannot capture a ledger: warm slabs do not "
                         "tile the space (delta against the cold ledger)")


def _bnb_order(fspace, ranges_list, lbs, objectives=None) -> np.ndarray:
    """Deterministic best-first permutation: ascending EDP lower bound (or
    the objective lower-bound vectors in pareto mode), ties broken by each
    leaf's first flat index — a pure function of the slab tree, never of
    the engine."""
    first = _slab_first_indices(fspace.radices, ranges_list)
    keys = ([first, lbs["edp"]] if objectives is None
            else [first] + [lbs[k] for k in reversed(objectives)])
    return np.lexsort(tuple(keys))


def _bnb_batch_slices(sizes: np.ndarray, max_points: Optional[int] = None):
    """Consecutive [s, e) leaf slices of at most `max_points` total points
    (default BNB_BATCH; a lone bigger leaf still forms its own slice)."""
    cap = BNB_BATCH if max_points is None else int(max_points)
    out = []
    s = 0
    pts = 0
    for j, n in enumerate(sizes):
        if j > s and pts + int(n) > cap:
            out.append((s, j))
            s, pts = j, 0
        pts += int(n)
    if s < len(sizes):
        out.append((s, len(sizes)))
    return out


def _bnb_leaf_items(fspace, ranges, chunk_size):
    """A leaf slab as decoded-launch work items [(start, count, slab), ...]:
    the slab's bounding index range, chunked to at most `chunk_size` lanes
    per launch (the kernel masks non-member lanes)."""
    from .factorized import slab_bounding_span
    b0, b1 = slab_bounding_span(fspace.radices, ranges)
    cs = int(chunk_size) if chunk_size else b1 - b0
    return [(s, min(cs, b1 - s), ranges) for s in range(b0, b1, cs)]


def _bnb_eval_edp(engine, fspace, wl, constraints, c, device, ranges_list,
                  shard, chunk_size):
    """(best gidx or -1, its engine EDP, n_feasible) over one batch of leaf
    slabs.

    numpy and torch evaluate the batch's ascending index vector (chunked by
    `chunk_size`, fanned out by `shard`). cuda picks its launch form per
    batch: coarse slabs (the probe phase) go through the decoded span-list
    driver — one decoded launch per leaf over its bounding span, the slab
    meta masking non-members — while batches of fine refined slabs
    materialize just the survivor rows for the grid-operand kernel, one
    launch per chunk (per shard under `shard=`)."""
    from .factorized import slab_indices_batch
    best = (-1, float("inf"))
    nf = 0
    if engine == "cuda" and (_slab_sizes(ranges_list) > BNB_FINE).any():
        from ..kernels.ops import dse_search_spans_factorized
        for ranges in ranges_list:
            items = _bnb_leaf_items(fspace, ranges, chunk_size)
            bi, be, bn = dse_search_spans_factorized(
                fspace, items, [wl], [constraints], c, device, shard=shard)
            nf += int(bn[0])
            best = _merge_best_indexed(best, (int(bi[0]), float(be[0])))
        return best[0], best[1], nf
    idx = slab_indices_batch(fspace.radices, ranges_list)
    cs = int(chunk_size) if chunk_size else len(idx)
    for s in range(0, len(idx), cs):
        part = idx[s:s + cs]
        if engine == "cuda":
            from ..kernels.ops import dse_search_multi
            rows = fspace.decode(part)
            (bi,), (be,), (bn,) = dse_search_multi(
                rows, [wl], [constraints], c, device, shard=shard)
            gi, e, f = (int(part[bi]) if bi >= 0 else -1), float(be), \
                int(bn)
        elif engine == "torch":
            gi, e, f = _torch_factorized_idx_argmin(fspace, wl, constraints,
                                                    c, device, part, shard)
        else:
            gi, e, f = _edp_idx_numpy(fspace, wl, constraints, c, part,
                                      shard)
        nf += f
        best = _merge_best_indexed(best, (gi, e))
    return best[0], best[1], nf


def _bnb_eval_pareto(engine, fspace, wl, constraints, c, device,
                     ranges_list, shard, chunk_size, objectives, run_rows):
    """(candidate gidx array, n_feasible, n_overflow) over one batch of leaf
    slabs; launch forms as in `_bnb_eval_edp`, with the running frontier
    carried into every cuda launch."""
    from .factorized import slab_indices_batch
    cands = []
    nf = n_over = 0
    carry_points = None
    if engine == "cuda" and len(run_rows):
        carry_points = [_cuda_front_points(run_rows, wl, c, device,
                                           objectives)]
    if engine == "cuda" and (_slab_sizes(ranges_list) > BNB_FINE).any():
        from ..kernels.ops import dse_pareto_spans_factorized
        for ranges in ranges_list:
            items = _bnb_leaf_items(fspace, ranges, chunk_size)
            (idx, f, o), = dse_pareto_spans_factorized(
                fspace, items, [wl], [constraints], c, device,
                objectives=objectives, shard=shard,
                carry_points=carry_points)
            nf += f
            n_over += o
            if len(idx):
                cands.append(idx)
        return (np.concatenate(cands) if cands
                else np.zeros(0, np.int64)), nf, n_over
    idx = slab_indices_batch(fspace.radices, ranges_list)
    cs = int(chunk_size) if chunk_size else len(idx)
    for s in range(0, len(idx), cs):
        part = idx[s:s + cs]
        if engine == "cuda":
            from ..kernels.ops import dse_pareto_multi
            (local, f, o), = dse_pareto_multi(
                fspace.decode(part), [wl], [constraints], c, device,
                objectives=objectives, shard=shard,
                carry_points=carry_points)
            cand = part[local]
            n_over += o
        elif engine == "torch":
            cand, f = _torch_factorized_idx_mask(fspace, wl, constraints, c,
                                                 device, part, shard,
                                                 objectives)
        else:
            cand, f = _pareto_idx_numpy(fspace, wl, constraints, c, part,
                                        shard, objectives)
        nf += f
        if len(cand):
            cands.append(cand)
    return (np.concatenate(cands) if cands
            else np.zeros(0, np.int64)), nf, n_over


def _bnb_thunks(run):
    """The runtime's per-engine alternatives of one BnB batch evaluation."""
    return {eng: functools.partial(run, eng)
            for eng in ("numpy", "torch", "cuda")}


def _search_factorized_bnb(fspace, wl, constraints, engine, c, device,
                           shard, chunk_size, rt=None, led=None,
                           warm=None, executor=None) -> SearchResult:
    """Bound-guided min-EDP driver.

    Phase 1 (`_bnb_frontier`): constraint-prune the slab tree down to
    BNB_LEAF-sized leaves. Phase 2: *probe* — evaluate the most promising
    leaves (ascending EDP lower bound) until an incumbent exists; *refine*
    — re-split everything else down to BNB_FINE against the incumbent;
    *sweep* — evaluate the refined survivors best-first in BNB_BATCH
    batches, stopping once the smallest remaining bound clears the
    incumbent.

    With a runtime attached the evaluation *unit* is one probe/sweep batch.
    The checkpoint carries the incumbent, the running (gidx, edp) argmin,
    the counters and the phase cursor; the slab frontier and the refinement
    are recomputed on resume (pure deterministic functions of the space and
    the checkpointed incumbent; their bound/prune work is already in the
    restored counters, so a throwaway stats dict keeps the totals exact).

    A `WarmStart` (`warm=`) replaces the root slab frontier with a prior
    run's re-priced surviving slabs and seeds the running argmin and
    incumbent from its point store (the serve layer's constraint-delta
    path). A `LedgerRecorder` (`led=`) captures the pruned/evaluated slab
    partition onto ``result.ledger``. Warm starts exclude both the runtime
    and the ledger (warm slabs no longer tile the space).

    An `executor` (a `repro_torch.parallel.slab_sched.SlabScheduler`)
    replaces the direct `_bnb_eval_edp` call with a leased multi-worker
    fan-out of the same batch. The fan-out is byte-identical to the direct
    call (per the scheduler's merge contract), so every other line of this
    driver — the schedule, the checkpoints, the counters — is untouched.
    """
    from .factorized import cached_bound_evaluator
    _check_warm(warm, rt, led)
    t0 = time.perf_counter()
    ev = cached_bound_evaluator(fspace, wl, c)
    stats = {"n_pruned": 0, "n_bounds": 0}
    state = {"inc": float("inf"), "best": (-1, float("inf")),
             "nf": 0, "n_eval": 0}
    fp = None
    rec = None
    if rt is not None:
        fp = _rt_fp("edp_bnb", wl, constraints, engine, c, device, shard,
                    chunk_size, axes=fspace.axes, leaf=BNB_LEAF,
                    batch=BNB_BATCH, fine=BNB_FINE)
        rec = rt.resume(fp)
    unit = 0
    phase, probe_end = "probe", 0
    inc_refine = float("inf")
    if rec is not None:
        # A resumed run replays only the tail of the schedule — the head's
        # evaluated leaves never pass through this process, so no complete
        # partition can be captured.
        led = None
        unit, st, extra = rec
        leaves, lbs = _bnb_frontier(fspace, ev, constraints, c,
                                    {"n_pruned": 0, "n_bounds": 0})
        state["best"] = decode_best_indexed(st)
        state["inc"] = float(st["inc"][0])
        inc_refine = float(st["inc_refine"][0])
        state["nf"] = int(extra["nf"])
        state["n_eval"] = int(extra["n_eval"])
        stats["n_pruned"] = int(extra["n_pruned"])
        stats["n_bounds"] = int(extra["n_bounds"])
        phase, probe_end = extra["phase"], int(extra["probe_end"])
    elif warm is not None:
        leaves, lbs = _warm_leaves(warm, ev, stats)
        state["best"] = (int(warm.best[0]), float(warm.best[1]))
        if state["best"][0] >= 0:
            state["inc"] = state["best"][1]
        state["nf"] = int(warm.nf)
    else:
        leaves, lbs = _bnb_frontier(fspace, ev, constraints, c, stats, led)
    resumed_sweep = phase == "sweep"

    def evaluate(ranges_list, n_points):
        if led is not None:
            led.evaluate(np.asarray(ranges_list, np.int64).reshape(-1, 5, 2))

        def run(eng):
            if executor is not None:
                return executor.eval_edp(eng, ranges_list)
            return _bnb_eval_edp(eng, fspace, wl, constraints, c, device,
                                 ranges_list, shard, chunk_size)

        gi, e, f = (run(engine) if rt is None
                    else rt.eval_unit(engine, _bnb_thunks(run), device))
        state["nf"] += f
        state["n_eval"] += n_points
        merged = _merge_best_indexed(state["best"], (gi, e))
        if merged is not state["best"]:
            state["best"] = merged
            # The pruning incumbent is the winner's float64 reference EDP,
            # so the slab schedule is identical whichever engine proposed
            # the winner.
            cfg = PTAConfig.from_array(fspace.decode([merged[0]])[0])
            _, _, energy, latency = eval_full(cfg, wl, c)[:4]
            state["inc"] = calc_edp(energy, latency)

    def snapshot():
        st = encode_best_indexed(state["best"])
        st["inc"] = np.asarray([state["inc"]], np.float64)
        st["inc_refine"] = np.asarray([inc_refine], np.float64)
        rt.unit_done(fp, unit, st, {
            "nf": state["nf"], "n_eval": state["n_eval"],
            "n_pruned": stats["n_pruned"], "n_bounds": stats["n_bounds"],
            "phase": phase, "probe_end": probe_end})

    # Probe: evaluate best-first batches until an incumbent exists.
    order = _bnb_order(fspace, leaves, lbs)
    leaves = leaves[order]
    lbs = {k: v[order] for k, v in lbs.items()}
    sizes = _slab_sizes(leaves)
    slices = _bnb_batch_slices(sizes)
    bi = probe_end
    while (not resumed_sweep and bi < len(slices)
           and state["inc"] == float("inf")):
        s, e = slices[bi]
        evaluate(leaves[s:e], int(sizes[s:e].sum()))
        bi += 1
        if rt is not None:
            probe_end = bi
            snapshot()
            unit += 1
    rs = slices[bi][0] if bi < len(slices) else len(leaves)

    # Refine the remainder against the incumbent frozen at refine start
    # (persisted, so a resumed replay prunes exactly as the head did), then
    # sweep the survivors best-first; the sorted early exit stops once the
    # smallest remaining bound clears the live incumbent.
    if not resumed_sweep:
        inc_refine = state["inc"]
        refine_stats = stats
    else:
        refine_stats = {"n_pruned": 0, "n_bounds": 0}
    ready, rlbs = _bnb_descend(
        ev,
        lambda b: (_bnb_infeasible_mask(b, constraints)
                   | (np.asarray(b["edp"]) > inc_refine)),
        leaves[rs:], {k: v[rs:] for k, v in lbs.items()}, BNB_FINE,
        refine_stats, c, led)
    phase, probe_end = "sweep", bi
    order = _bnb_order(fspace, ready, rlbs)
    ready = ready[order]
    rlbs = {k: v[order] for k, v in rlbs.items()}
    edp_lo = rlbs["edp"] if len(ready) else np.zeros(0)
    sizes = _slab_sizes(ready)
    sweep_done = unit - bi
    for j, (s, e) in enumerate(_bnb_batch_slices(sizes)):
        if j < sweep_done:
            continue
        if edp_lo[s] > state["inc"]:
            stats["n_pruned"] += int(sizes[s:].sum())
            if led is not None:
                led.prune(ready[s:], {k: v[s:] for k, v in rlbs.items()})
            break
        live = edp_lo[s:e] <= state["inc"]
        stats["n_pruned"] += int(sizes[s:e][~live].sum())
        if led is not None:
            led.prune(ready[s:e][~live],
                      {k: v[s:e][~live] for k, v in rlbs.items()})
        evaluate(ready[s:e][live], int(sizes[s:e][live].sum()))
        if rt is not None:
            snapshot()
            unit += 1
    best = state["best"]
    row = fspace.decode([best[0]])[0] if best[0] >= 0 else None
    r = _make_result(row, state["nf"], wl, c, fspace.size, state["n_eval"],
                     time.perf_counter() - t0)
    r.n_pruned = stats["n_pruned"]
    r.n_bounds = stats["n_bounds"]
    if led is not None:
        r.ledger = led.build(fspace)
    return rt.annotate(r) if rt is not None else r


def _pareto_factorized_bnb(fspace, wl, constraints, engine, c, device,
                           objectives, shard, chunk_size, rt=None, led=None,
                           warm=None, executor=None) -> ParetoResult:
    """Bound-guided frontier search: probe the objective-sorted leaves to
    seed the running (float64-refined) frontier, refine the remainder
    against it, then evaluate the survivors in batches. A slab is pruned
    when its objective lower-bound corner is strictly dominated by a
    running-frontier point. Runtime checkpointing follows
    `_search_factorized_bnb`, with the frozen refinement frontier persisted
    beside the live one; `warm=` / `led=` / `executor=` too (warm seeds the
    running frontier from `WarmStart.rows` / `met` instead of an argmin; the
    executor fan-out's candidate union is frontier-identical to the direct
    call)."""
    from .factorized import cached_bound_evaluator
    _check_warm(warm, rt, led)
    t0 = time.perf_counter()
    d = len(objectives)
    ev = cached_bound_evaluator(fspace, wl, c)
    stats = {"n_pruned": 0, "n_bounds": 0}
    state = {"rows": _empty_run_state()[0], "met": _empty_run_state()[1],
             "pts": np.zeros((0, d)), "nf": 0, "n_eval": 0, "n_over": 0}
    fp = None
    rec = None
    if rt is not None:
        fp = _rt_fp("pareto_bnb", wl, constraints, engine, c, device,
                    shard, chunk_size, axes=fspace.axes,
                    objectives=tuple(objectives), leaf=BNB_LEAF,
                    batch=BNB_BATCH, fine=BNB_FINE)
        rec = rt.resume(fp)
    unit = 0
    phase, probe_end = "probe", 0
    pts_refine = np.zeros((0, d))
    if rec is not None:
        led = None  # a resumed run sees no complete partition
        unit, st, extra = rec
        leaves, lbs = _bnb_frontier(fspace, ev, constraints, c,
                                    {"n_pruned": 0, "n_bounds": 0})
        state["rows"], state["met"] = decode_front(st, REPORT_METRICS)
        state["pts"] = (np.stack([state["met"][k] for k in objectives],
                                 axis=1) if len(state["rows"])
                        else np.zeros((0, d)))
        pts_refine = np.asarray(st["pts_refine"],
                                np.float64).reshape(-1, d)
        state["nf"] = int(extra["nf"])
        state["n_eval"] = int(extra["n_eval"])
        state["n_over"] = int(extra["n_over"])
        stats["n_pruned"] = int(extra["n_pruned"])
        stats["n_bounds"] = int(extra["n_bounds"])
        phase, probe_end = extra["phase"], int(extra["probe_end"])
    elif warm is not None:
        leaves, lbs = _warm_leaves(warm, ev, stats)
        if warm.rows is not None and len(warm.rows):
            state["rows"] = np.asarray(warm.rows, np.int64).reshape(-1, 5)
            state["met"] = {k: np.asarray(warm.met[k], np.float64)
                            for k in REPORT_METRICS}
            state["pts"] = np.stack([state["met"][k] for k in objectives],
                                    axis=1)
        state["nf"] = int(warm.nf)
    else:
        leaves, lbs = _bnb_frontier(fspace, ev, constraints, c, stats, led)
    resumed_sweep = phase == "sweep"

    def evaluate(ranges_list, n_points):
        if led is not None:
            led.evaluate(np.asarray(ranges_list, np.int64).reshape(-1, 5, 2))

        def run(eng):
            if executor is not None:
                return executor.eval_pareto(eng, ranges_list, state["rows"])
            return _bnb_eval_pareto(eng, fspace, wl, constraints, c, device,
                                    ranges_list, shard, chunk_size,
                                    objectives, state["rows"])

        idx, f, o = (run(engine) if rt is None
                     else rt.eval_unit(engine, _bnb_thunks(run), device))
        state["nf"] += f
        state["n_eval"] += n_points
        state["n_over"] += o
        if len(idx):
            state["rows"], state["met"] = _merge_running_front(
                state["rows"], state["met"], fspace.decode(idx), wl,
                constraints, c, objectives)
            state["pts"] = (np.stack([state["met"][k] for k in objectives],
                                     axis=1) if len(state["rows"])
                            else np.zeros((0, d)))

    def snapshot():
        st = encode_front(state["rows"], state["met"], REPORT_METRICS)
        st["pts_refine"] = np.asarray(pts_refine,
                                      np.float64).reshape(-1, d)
        rt.unit_done(fp, unit, st, {
            "nf": state["nf"], "n_eval": state["n_eval"],
            "n_over": state["n_over"], "n_pruned": stats["n_pruned"],
            "n_bounds": stats["n_bounds"], "phase": phase,
            "probe_end": probe_end})

    # Probe: evaluate best-first batches until a frontier point exists.
    order = _bnb_order(fspace, leaves, lbs, objectives)
    leaves = leaves[order]
    lbs = {k: v[order] for k, v in lbs.items()}
    sizes = _slab_sizes(leaves)
    slices = _bnb_batch_slices(sizes)
    bi = probe_end
    while not resumed_sweep and bi < len(slices) and not len(state["pts"]):
        s, e = slices[bi]
        evaluate(leaves[s:e], int(sizes[s:e].sum()))
        bi += 1
        if rt is not None:
            probe_end = bi
            snapshot()
            unit += 1
    rs = slices[bi][0] if bi < len(slices) else len(leaves)
    # The frontier frozen at refine start drives the refinement prune (the
    # descent never evaluates, so freezing it is exact; persisting it makes
    # the resumed replay identical after the live frontier moves).
    if not resumed_sweep:
        pts_refine = state["pts"]
        refine_stats = stats
    else:
        refine_stats = {"n_pruned": 0, "n_bounds": 0}
    ready, rlbs = _bnb_descend(
        ev,
        lambda b: (_bnb_infeasible_mask(b, constraints)
                   | _bnb_dominated_vs(pts_refine, b, objectives)),
        leaves[rs:], {k: v[rs:] for k, v in lbs.items()}, BNB_FINE,
        refine_stats, c, led)
    phase, probe_end = "sweep", bi
    order = _bnb_order(fspace, ready, rlbs, objectives)
    ready = ready[order]
    rlbs = {k: v[order] for k, v in rlbs.items()}
    sizes = _slab_sizes(ready)
    sweep_done = unit - bi
    for j, (s, e) in enumerate(_bnb_batch_slices(sizes)):
        if j < sweep_done:
            continue
        die = _bnb_dominated_vs(state["pts"],
                                {k: v[s:e] for k, v in rlbs.items()},
                                objectives)
        stats["n_pruned"] += int(sizes[s:e][die].sum())
        if led is not None:
            led.prune(ready[s:e][die],
                      {k: v[s:e][die] for k, v in rlbs.items()})
        if not die.all():
            evaluate(ready[s:e][~die], int(sizes[s:e][~die].sum()))
        if rt is not None:
            snapshot()
            unit += 1
    res = _front_result(state["rows"], state["met"], wl, constraints, c,
                        objectives, fspace.size, state["nf"],
                        state["n_eval"], time.perf_counter() - t0,
                        n_pruned=stats["n_pruned"],
                        n_bounds=stats["n_bounds"],
                        n_overflow=state["n_over"])
    if led is not None:
        res.ledger = led.build(fspace)
    return rt.annotate(res) if rt is not None else res


def _workloads_cuda_factorized(wls, names, cons_for, fspace, c, device,
                               objective, metrics, shard, chunk_size):
    """Batched factorized driver: every span is one all-workloads decoded
    launch, with per-workload carries (best EDP / running front) between
    spans."""
    from ..kernels.ops import (dse_pareto_multi_factorized,
                               dse_search_multi_factorized)
    t0 = time.perf_counter()
    wl_list = [wls[nm] for nm in names]
    cons_list = [cons_for(nm) for nm in names]
    n_wl = 0
    if objective == "edp":
        best = {nm: (None, float("inf")) for nm in names}
        nf = {nm: 0 for nm in names}
        for s, n in _iter_spans(fspace.size, chunk_size):
            n_wl += n
            carry = [best[nm][1] for nm in names]
            bi, be, bn = dse_search_multi_factorized(
                fspace, s, n, wl_list, cons_list, c, device, shard=shard,
                carry_edp=carry)
            for nm, i, e, f in zip(names, bi, be, bn):
                nf[nm] += f
                if i >= 0:
                    best[nm] = (fspace.decode([i])[0], e)
        wall = time.perf_counter() - t0
        return {nm: _make_result(best[nm][0], nf[nm], wls[nm], c,
                                 fspace.size, n_wl, wall)
                for nm in names}

    run = {nm: _empty_run_state() for nm in names}
    nf = {nm: 0 for nm in names}
    n_over = {nm: 0 for nm in names}
    for s, n in _iter_spans(fspace.size, chunk_size):
        n_wl += n
        carry_points = [
            _cuda_front_points(run[nm][0], wls[nm], c, device, metrics)
            if len(run[nm][0]) else None
            for nm in names]
        per_wl = dse_pareto_multi_factorized(
            fspace, s, n, wl_list, cons_list, c, device, objectives=metrics,
            shard=shard, carry_points=carry_points)
        for nm, (idx, f, o) in zip(names, per_wl):
            nf[nm] += f
            n_over[nm] += o
            if len(idx):
                run[nm] = _merge_running_front(
                    run[nm][0], run[nm][1], fspace.decode(idx), wls[nm],
                    cons_for(nm), c, metrics)
    wall = time.perf_counter() - t0
    return {nm: _front_result(run[nm][0], run[nm][1], wls[nm], cons_for(nm),
                              c, metrics, fspace.size, nf[nm], n_wl, wall,
                              n_overflow=n_over[nm])
            for nm in names}


def _check_engine(engine):
    """Refuse an unknown engine, naming `torch` for the reference's jax."""
    if engine == "jax":
        raise ValueError("engine='jax' is the reference's jit-compiled "
                         "engine; repro_torch's counterpart is "
                         "engine='torch' (plain torch float32 on the "
                         "search's device)")
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; pick from "
                         f"{sorted(ENGINES)}")


def _check_workers_arg(workers, prune) -> Optional[int]:
    """The validated worker count of a slab-scheduler search (None when the
    search runs on one executor)."""
    if workers is None:
        return None
    workers = int(workers)
    if workers < 1:
        raise ValueError("workers= must be a positive integer")
    if prune != "bound":
        raise ValueError("workers= fans out the bound-guided slab queue; it "
                         "requires prune='bound' (factorized=True)")
    return workers


def _check_ledger_arg(keep_ledger, prune):
    if keep_ledger and prune != "bound":
        raise ValueError("keep_ledger=True records the bound-guided slab "
                         "partition; it requires prune='bound'")


def _check_objective(objective, engine, pareto_metrics):
    """The validated objective tuple of a pareto search, None for edp."""
    if objective == "edp":
        return None
    if objective != "pareto":
        raise ValueError(f"unknown objective {objective!r}; "
                         f"pick 'edp' or 'pareto'")
    return _check_pareto_metrics(engine, pareto_metrics)


def _check_pareto_metrics(engine: str, pareto_metrics) -> tuple:
    metrics = tuple(pareto_metrics)
    unknown = [k for k in metrics if k not in REPORT_METRICS]
    if unknown or not metrics:
        raise ValueError(f"pareto_metrics must be a non-empty subset of "
                         f"{REPORT_METRICS}, got {pareto_metrics!r}")
    if engine == "cuda" and "util" in metrics:
        raise ValueError("the cuda frontier kernels do not model 'util'; "
                         "use the python/numpy engines for it")
    return metrics


def _check_stream_args(shard, chunk_size):
    if shard is not None and int(shard) < 1:
        raise ValueError(f"shard must be >= 1, got {shard!r}")
    if chunk_size is not None and int(chunk_size) < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size!r}")


def _check_prune_arg(prune, factorized):
    if prune is None:
        return
    if prune != "bound":
        raise ValueError(f"unknown prune mode {prune!r}; the engine layer "
                         f"supports prune='bound' (branch-and-bound slab "
                         f"pruning) or None")
    if not factorized:
        raise ValueError("prune='bound' prices slabs of a product space "
                         "via the factorized axis tables; it requires "
                         "factorized=True (numpy/torch/cuda engines)")


def _check_grid(grid) -> np.ndarray:
    """Reject malformed candidate grids up front (a wrong-shaped or
    non-positive grid would surface as a silent zero-feasible result)."""
    g = np.asarray(grid)
    if g.ndim != 2 or (len(g) and g.shape[1] != 5):
        raise ValueError(f"grid must be a (G, 5) array of config rows "
                         f"(n_t, n_c, n_h, n_v, n_lambda); got shape "
                         f"{g.shape}")
    if len(g) == 0:
        raise ValueError("grid is empty: no candidate configs to search")
    if g.dtype.kind not in "iuf":
        raise ValueError(f"grid must be numeric, got dtype {g.dtype}")
    if g.dtype.kind == "f" and not np.isfinite(g).all():
        raise ValueError("grid contains non-finite (NaN/Inf) entries")
    if (g < 1).any():
        raise ValueError("grid entries are parallelism degrees and must "
                         "all be >= 1")
    return g


# ---------------------------------------------------------------------------
# Robust (worst-case-feasible) search under calibration uncertainty
#
# The MONOTONE lemma of core.calibration reduces robust search to an
# ordinary search at the calibration's worst corner, so the resolution below
# swaps the `DeviceConstants` the engines run on (on cuda the corner's
# constants reach the kernels folded to float32 on the host, like any
# other) and attaches the winner's (or frontier's) uncertainty band
# afterwards. Only calibrations with *unresolved* fields leave that path,
# through the conservative host-side vertex sweep `_robust_vertex_search`.
# ---------------------------------------------------------------------------

#: Engines robust="worst_case" supports — the vectorized backends the
#: worst-corner reduction prices in one sweep. The python engine is the
#: paper-faithful sequential oracle and stays point-calibrated.
ROBUST_ENGINES = ("numpy", "torch", "cuda")


def _resolve_robust(calibration, robust, c, engine):
    """Validate and resolve `calibration=` / `robust=` into the constants
    the engines should run at.

    Returns `(c_run, cal, fallback)`: `cal` is None on uncalibrated
    searches; `fallback=True` routes through `_robust_vertex_search`
    (unresolved fields), in which case `c_run` is None.
    """
    if calibration is None:
        if robust is not None:
            raise ValueError("robust= prices a calibration's uncertainty; "
                             "pass calibration= (a CalibratedConstants, a "
                             "{field: interval} mapping, or a preset name)")
        return c, None, False
    cal = as_calibration(calibration)
    if c != CONSTANTS:
        raise ValueError("pass either c= or calibration=, not both: the "
                         "calibration's nominal values are the point "
                         "constants")
    if robust is None:
        return cal.nominal(), cal, False
    if robust != "worst_case":
        raise ValueError(f"unknown robust mode {robust!r}; the engine "
                         f"layer supports robust='worst_case' or None")
    if engine not in ROBUST_ENGINES:
        raise ValueError(f"robust='worst_case' supports engines "
                         f"{ROBUST_ENGINES}, not {engine!r}")
    if cal.unresolved():
        return None, cal, True
    return cal.worst_case(), cal, False


def _corner_reduced_metrics(rows, wl, cal, sign, fspace=None, idx=None):
    """Per-metric elementwise extreme over the calibration's `sign`-side
    vertex corners (float64 host reference). One corner — hence one plain
    `evaluate_grid` sweep — for fully certified calibrations."""
    op = np.maximum if sign > 0 else np.minimum
    out = None
    for corner in cal.vertex_corners(sign=sign):
        m = (factorized_evaluate_grid(fspace, wl, corner, idx=idx)
             if fspace is not None else evaluate_grid(rows, wl, corner))
        out = m if out is None else {k: op(out[k], m[k])
                                     for k in REPORT_METRICS}
    return out


def _measure_band(res, cal, wl) -> Optional[RobustBand]:
    """The result's uncertainty band: float64 reference metrics of the
    winner (or each frontier row) at the calibration's worst / nominal /
    best corners. None for infeasible results."""
    if isinstance(res, ParetoResult):
        if res.size == 0:
            return None
        rows = np.asarray(res.front, np.int64)

        def to(m):
            return {k: np.asarray(m[k], np.float64) for k in REPORT_METRICS}
    else:
        if res.best_cfg is None:
            return None
        rows = np.asarray([res.best_cfg.as_array()], np.int64)

        def to(m):
            return {k: float(np.asarray(m[k])[0]) for k in REPORT_METRICS}
    worst = _corner_reduced_metrics(rows, wl, cal, +1)
    best = _corner_reduced_metrics(rows, wl, cal, -1)
    nom = evaluate_grid(rows, wl, cal.nominal())
    return RobustBand(calibration=cal, worst=to(worst), nominal=to(nom),
                      best=to(best))


def _robust_vertex_search(wl, constraints, cal, engine, grid, n_z,
                          objective, pareto_metrics, factorized, space,
                          hierarchical):
    """Conservative fallback for calibrations with unresolved fields: a
    host-side float64 sweep over the 2^k vertex corners of the uncertified
    fields (certified fields pinned at their worst end), each metric priced
    at its elementwise corner max. Sound — per-field monotone metrics
    attain their box extrema at vertices — but conservative: per-metric
    maxes may come from different corners. `chunk_size` is accepted and
    ignored (the host sweep returns the same bytes); `prune` / `runtime` /
    `keep_ledger` are rejected by `search` before this runs."""
    t0 = time.perf_counter()
    fspace = None
    if factorized:
        fspace = _factorized_space(space, grid, n_z, engine, hierarchical)
        rows = fspace.to_grid()
    else:
        if space is not None:
            raise ValueError("space= requires factorized=True (pass grid= "
                             "for materialized candidate sets)")
        rows = _full_grid(n_z) if grid is None else _check_grid(grid)
        rows = np.asarray(rows, np.int64)
    n_corners = len(cal.vertex_corners())
    worst = _corner_reduced_metrics(rows, wl, cal, +1, fspace=fspace)
    ok = np.asarray(constraints.satisfied(worst["area"], worst["power"],
                                          worst["energy"],
                                          worst["latency"]))
    n_eval = len(rows) * n_corners
    n_feasible = int(ok.sum())

    if objective == "edp":
        if not ok.any():
            return SearchResult(best_cfg=None, n_evaluated=n_eval,
                                n_feasible=0, n_workload_evals=n_eval,
                                wall_time_s=time.perf_counter() - t0)
        idx = np.where(ok)[0]
        best = int(idx[np.lexsort((idx, worst["edp"][idx]))[0]])
        res = SearchResult(
            best_cfg=PTAConfig.from_array(rows[best]),
            area_mm2=float(worst["area"][best]),
            power_w=float(worst["power"][best]),
            energy_j=float(worst["energy"][best]),
            latency_s=float(worst["latency"][best]),
            edp=float(worst["edp"][best]),
            n_evaluated=n_eval, n_feasible=n_feasible,
            n_workload_evals=n_eval,
            wall_time_s=time.perf_counter() - t0)
    else:
        metrics = _check_pareto_metrics(engine, pareto_metrics)
        if not ok.any():
            front = np.zeros((0, 5), np.int64)
            met = {k: np.zeros(0, np.float64) for k in REPORT_METRICS}
            return ParetoResult(front=front, metrics=met,
                                objectives=metrics, n_evaluated=n_eval,
                                n_feasible=0, n_workload_evals=n_eval,
                                wall_time_s=time.perf_counter() - t0)
        pts = np.stack([np.asarray(worst[k], np.float64)[ok]
                        for k in metrics], axis=1)
        mask = pareto_mask(pts)
        front = rows[ok][mask]
        order = np.lexsort(front.T[::-1])
        sel = np.where(ok)[0][mask][order]
        met = {k: np.asarray(worst[k], np.float64)[sel]
               for k in REPORT_METRICS}
        res = ParetoResult(front=front[order], metrics=met,
                           objectives=metrics, n_evaluated=n_eval,
                           n_feasible=n_feasible, n_workload_evals=n_eval,
                           wall_time_s=time.perf_counter() - t0)
    res.band = _measure_band(res, cal, wl)
    return res


def _refuse_vertex_with(cal, prune, runtime, keep_ledger):
    if prune is not None or runtime is not None or keep_ledger:
        raise ValueError(
            "this calibration has uncertified varying fields "
            f"({cal.unresolved()}): robust search runs the conservative "
            "vertex sweep, which supports neither prune='bound' nor "
            "runtime= nor keep_ledger=True — certify the field directions "
            "(core.calibration.MONOTONE) to use the worst-corner fast path")


def search(wl: Workload, constraints: Constraints = Constraints(), *,
           engine: str = "numpy", grid: Optional[np.ndarray] = None,
           n_z: int = 12, hierarchical: bool = False,
           c: DeviceConstants = CONSTANTS, device=None,
           objective: str = "edp",
           pareto_metrics: tuple = DEFAULT_OBJECTIVES,
           shard: Optional[int] = None,
           chunk_size: Optional[int] = None, factorized: bool = False,
           space=None, prune: Optional[str] = None, runtime=None,
           keep_ledger: bool = False, workers: Optional[int] = None,
           deterministic: bool = True,
           calibration=None, robust: Optional[str] = None
           ) -> Union[SearchResult, ParetoResult]:
    """Unified search over a config grid.

    Args:
      engine: one of ENGINES (python, numpy, torch, cuda). All return
        identical results. Caveat: the torch and cuda engines (and the
        hierarchical prefilter) test feasibility in float32, so a config
        within one float32 ulp of a constraint bound can classify
        differently than under the float64 python/numpy engines — real
        design points never ride that edge.
      grid: (G, 5) candidate configs; defaults to the full 1..n_z grid.
      hierarchical: area/power-only prefilter over the grid (float32, on
        `device`), then workload evaluation on the survivors only.
      device: "cuda" (default; raises without a card) or "cpu" (the plain
        PyTorch versions of the kernels).
      objective: "edp" — the feasible min-EDP point (a SearchResult) — or
        "pareto" — the whole non-dominated feasible set over
        `pareto_metrics` (a ParetoResult). Each engine proposes candidates
        its own way, then every proposal is refined through the float64
        reference model, so identical frontiers come back byte-identical.
      pareto_metrics: objectives minimized in "pareto" mode, a subset of
        REPORT_METRICS (the cuda kernels model all but "util"; torch
        models all six).
      shard: fan each evaluation out over up to `shard` devices of the
        candidate mesh (`launch.mesh.make_candidate_mesh`): on cuda and
        torch one contiguous slice of the candidates a card, clamped to the
        cards present (one device on the CPU); python and numpy split as
        many ways on the host at any device count. Any (shard, chunk_size)
        is byte-identical to the one-shot sweep; a checkpoint is bound to
        its (shard, chunk_size).
      chunk_size: stream the grid (or index space) in chunks of this many
        candidates with a running argmin / frontier carried across chunks.
      factorized: evaluate a *product space* (`space=`, default the full
        1..n_z space) from axis factor tables (numpy, torch) or decoded on
        device (cuda); hierarchical and an explicit `grid` are rejected.
      prune: "bound" runs the branch-and-bound driver over the factorized
        space; winners and frontiers stay byte-identical to the unpruned
        sweep, with the skipped volume in `n_pruned`. Requires
        factorized=True.
      runtime: a `core.runtime.RuntimePolicy` (or `SearchRuntime`)
        attaching the resilient control plane: checkpoint/resume through
        the step-atomic snapshot layer, bounded-backoff launch retries, a
        per-launch watchdog and, on the CPU only, cuda -> torch -> numpy
        degradation and NaN quarantine with host float64 re-evaluation (on
        a card a unit that exhausts its retries raises LaunchExhausted and
        a NaN-poisoned one NanDetected). Results are byte-identical with
        or without a runtime; the campaign's counters come back on the
        result.
      keep_ledger: keep the bound-guided run's slab partition — every
        pruned slab with the lower bounds it was priced at, and every
        evaluated leaf — as a `core.factorized.SlabLedger` on
        ``result.ledger``. Requires prune="bound". A checkpointed run that
        resumed returns ``ledger=None`` (it replays only the tail).
      workers: fan the bound-guided slab queue out across this many leased
        worker threads (`repro_torch.parallel.slab_sched`), each launching
        the kernels on `device`: every slab batch is taken under a
        heartbeat lease, a worker that dies or hangs has its batch requeued
        (the run ends with an explicit tiling assertion), and the
        incumbent/frontier is shared through versioned monotone merges. A
        kernel failure in a worker fails the query as it would the
        sequential driver. Requires prune="bound". Composes with
        `runtime=` and `keep_ledger=True`. Scheduler telemetry comes back
        on ``result.sched``.
      deterministic: with `workers=`, True (default) replays merges on the
        sequential drivers' fixed schedule — byte-identical to
        `workers=None` (winners, frontiers and the canonical counter set,
        `repro_torch.parallel.slab_sched.canonical_counters`). False runs
        the async work-stealing sweep: the same winner/frontier after
        float64 exact verification, coverage-complete, with
        schedule-dependent prune counters.
      calibration: a `core.calibration.CalibratedConstants` (or a
        `{field: interval}` mapping, or a shipped preset name) of per-field
        (lo, nominal, hi) intervals over the device constants; exclusive
        with a non-default `c=`. Without `robust=` the search runs at
        `calibration.nominal()` and the result carries the winner's
        uncertainty band on ``result.band``.
      robust: "worst_case" prices the search at the calibration's certified
        worst corner (numpy/torch/cuda engines): feasibility on each
        metric's worst-case value, the incumbent on worst-case metrics.
        The degenerate calibration returns an uncalibrated search's bytes.
        Calibrations with uncertified varying fields take a conservative
        host-side vertex sweep (which rejects prune/runtime/keep_ledger).
    """
    dev = resolve_device(device)
    _check_engine(engine)
    _check_stream_args(shard, chunk_size)
    _check_prune_arg(prune, factorized)
    _check_ledger_arg(keep_ledger, prune)
    workers = _check_workers_arg(workers, prune)
    c, cal, fallback = _resolve_robust(calibration, robust, c, engine)
    if fallback:
        _refuse_vertex_with(cal, prune, runtime, keep_ledger)
        _check_objective(objective, engine, pareto_metrics)
        return _robust_vertex_search(wl, constraints, cal, engine, grid,
                                     n_z, objective, pareto_metrics,
                                     factorized, space, hierarchical)
    rt = SearchRuntime.of(runtime) if runtime is not None else None
    if rt is None:
        res = _search_impl(wl, constraints, engine, grid, n_z, hierarchical,
                           c, dev, objective, pareto_metrics, shard,
                           chunk_size, factorized, space, prune, None,
                           keep_ledger, workers, deterministic)
    else:
        try:
            res = _search_impl(wl, constraints, engine, grid, n_z,
                               hierarchical, c, dev, objective,
                               pareto_metrics, shard, chunk_size, factorized,
                               space, prune, rt, keep_ledger, workers,
                               deterministic)
        finally:
            # Durability on exit, normal or not: an injected KillSearch
            # must leave the same committed snapshots a blocking save would
            # have (a real process death simply replays one extra unit).
            rt.flush()
    if cal is not None:
        res.band = _measure_band(res, cal, wl)
    return res


def _search_impl(wl, constraints, engine, grid, n_z, hierarchical, c, dev,
                 objective, pareto_metrics, shard, chunk_size, factorized,
                 space, prune, rt, keep_ledger, workers=None,
                 deterministic=True):
    if factorized:
        from .factorized import LedgerRecorder
        fspace = _factorized_space(space, grid, n_z, engine, hierarchical)
        metrics = _check_objective(objective, engine, pareto_metrics)
        led = LedgerRecorder() if keep_ledger else None
        if workers is not None:
            from ..parallel.slab_sched import parallel_bnb
            return parallel_bnb(fspace, wl, constraints, engine, c, dev,
                                shard, chunk_size, objective=objective,
                                metrics=metrics, workers=workers,
                                deterministic=deterministic, rt=rt, led=led)
        if metrics is None:
            if prune == "bound":
                return _search_factorized_bnb(fspace, wl, constraints,
                                              engine, c, dev, shard,
                                              chunk_size, rt, led)
            return _search_factorized(fspace, wl, constraints, engine, c,
                                      dev, shard, chunk_size, rt)
        if prune == "bound":
            return _pareto_factorized_bnb(fspace, wl, constraints, engine,
                                          c, dev, metrics, shard, chunk_size,
                                          rt, led)
        return _pareto_factorized(fspace, wl, constraints, engine, c, dev,
                                  metrics, shard, chunk_size, rt)
    if space is not None:
        raise ValueError("space= requires factorized=True (pass grid= for "
                         "materialized candidate sets)")
    grid = _full_grid(n_z) if grid is None else _check_grid(grid)
    metrics = _check_objective(objective, engine, pareto_metrics)
    # A runtime routes through the streamed drivers even one-shot: the
    # single-chunk streamed sweep is byte-identical to the one-shot path,
    # and it is where the unit guard and the checkpoint cursor live.
    streamed = shard is not None or chunk_size is not None or rt is not None
    if metrics is None:
        if streamed:
            return _search_streamed(grid, wl, constraints, engine,
                                    hierarchical, c, dev, shard, chunk_size,
                                    rt)
        return ENGINES[engine](grid, wl, constraints, c, hierarchical, dev)
    if streamed:
        return _pareto_streamed(grid, wl, constraints, engine, hierarchical,
                                c, dev, metrics, shard, chunk_size, rt)
    return PARETO_ENGINES[engine](grid, wl, constraints, c, hierarchical,
                                  dev, metrics)


def _union_prefiltered(chunk, wls, names, cons_for, c, hierarchical, device):
    """Union of the per-workload area/power survivor sets (the kernel still
    applies each workload's exact constraints)."""
    if not hierarchical:
        return chunk
    masks = hw_prefilter_masks(chunk, [wls[name] for name in names],
                               [cons_for(name) for name in names], c, device)
    union = np.zeros(len(chunk), dtype=bool)
    for mask in masks:
        union |= mask
    return chunk[union]


def _workloads_cuda_streamed(wls, names, cons_for, grid, hierarchical, c,
                             device, objective, metrics, shard, chunk_size):
    """Chunked (and sharded) batched driver: each chunk is one
    all-workloads launch (one per shard), with per-workload carries (best
    EDP / running front) between launches."""
    from ..kernels.ops import dse_pareto_multi, dse_search_multi
    t0 = time.perf_counter()
    n = len(grid)
    cs = int(chunk_size) if chunk_size else max(n, 1)
    wl_list = [wls[nm] for nm in names]
    cons_list = [cons_for(nm) for nm in names]
    n_wl = 0
    if objective == "edp":
        best = {nm: (None, float("inf")) for nm in names}
        nf = {nm: 0 for nm in names}
        for chunk in _iter_chunks(grid, cs):
            sub = _union_prefiltered(chunk, wls, names, cons_for, c,
                                     hierarchical, device)
            n_wl += len(sub)
            if len(sub) == 0:
                continue
            carry = [best[nm][1] for nm in names]
            bi, be, bn = dse_search_multi(sub, wl_list, cons_list, c, device,
                                          shard=shard, carry_edp=carry)
            for nm, i, e, f in zip(names, bi, be, bn):
                nf[nm] += f
                if i >= 0:
                    best[nm] = (sub[i], e)
        wall = time.perf_counter() - t0
        return {nm: _make_result(best[nm][0], nf[nm], wls[nm], c, n, n_wl,
                                 wall)
                for nm in names}

    run = {nm: _empty_run_state() for nm in names}
    nf = {nm: 0 for nm in names}
    n_over = {nm: 0 for nm in names}
    for chunk in _iter_chunks(grid, cs):
        sub = _union_prefiltered(chunk, wls, names, cons_for, c,
                                 hierarchical, device)
        n_wl += len(sub)
        if len(sub) == 0:
            continue
        carry_points = [
            _cuda_front_points(run[nm][0], wls[nm], c, device, metrics)
            if len(run[nm][0]) else None
            for nm in names]
        per_wl = dse_pareto_multi(sub, wl_list, cons_list, c, device,
                                  objectives=metrics, shard=shard,
                                  carry_points=carry_points)
        for nm, (cand_idx, f, o) in zip(names, per_wl):
            nf[nm] += f
            n_over[nm] += o
            if len(cand_idx):
                run[nm] = _merge_running_front(
                    run[nm][0], run[nm][1], sub[cand_idx], wls[nm],
                    cons_for(nm), c, metrics)
    wall = time.perf_counter() - t0
    return {nm: _front_result(run[nm][0], run[nm][1], wls[nm], cons_for(nm),
                              c, metrics, n, nf[nm], n_wl, wall,
                              n_overflow=n_over[nm])
            for nm in names}


def search_workloads(wls: Union[Mapping[str, Workload], Sequence[Workload]],
                     constraints: Union[Constraints,
                                        Mapping[str, Constraints]]
                     = Constraints(), *,
                     engine: str = "cuda",
                     grid: Optional[np.ndarray] = None, n_z: int = 12,
                     hierarchical: bool = False,
                     c: DeviceConstants = CONSTANTS, device=None,
                     objective: str = "edp",
                     pareto_metrics: tuple = DEFAULT_OBJECTIVES,
                     shard: Optional[int] = None,
                     chunk_size: Optional[int] = None,
                     factorized: bool = False, space=None,
                     prune: Optional[str] = None, runtime=None,
                     keep_ledger: bool = False,
                     workers: Optional[int] = None,
                     deterministic: bool = True,
                     calibration=None, robust: Optional[str] = None
                     ) -> Dict[str, Union[SearchResult, ParetoResult]]:
    """Batched search: many workloads against one grid.

    On the `cuda` engine all workloads are evaluated in a single fused
    kernel launch (their GEMM lists back to back in the parameter block,
    constraints as a dynamic (W, 4) operand) — the search kernel for
    objective="edp", the frontier kernel for objective="pareto"; other
    engines loop per workload. With `hierarchical=True` the compacted grid
    is the union of the per-workload area/power survivor sets.
    `chunk_size=` streams, each chunk one all-workloads launch (one per
    shard under `shard=`);
    `factorized=True` decodes the product `space` on device;
    `prune="bound"` runs the branch-and-bound search per workload. Each
    result reports the whole batch's wall time.

    `runtime=` runs the batch as a per-workload loop (full checkpoint /
    resume per workload, each under `<checkpoint_dir>/<workload name>`),
    every sub-search sharing the batch campaign's fault injector, and each
    result carries its own workload's counters. `keep_ledger=True` keeps
    each workload's slab partition (prune="bound"). `workers=` /
    `deterministic=` fan each workload's slab queue out across the leased
    scheduler exactly as in `search` (a fresh worker pool per workload: the
    slab tree is per workload, so there is nothing to share). `calibration=` /
    `robust=` are resolved once for the whole batch — the fused launches
    simply run at the worst corner — and every result carries its own
    uncertainty band.
    """
    dev = resolve_device(device)
    if not isinstance(wls, Mapping):
        wls = {wl.name: wl for wl in wls}
    _check_engine(engine)
    _check_stream_args(shard, chunk_size)
    _check_prune_arg(prune, factorized)
    _check_ledger_arg(keep_ledger, prune)
    workers = _check_workers_arg(workers, prune)
    if grid is not None:
        grid = _check_grid(grid)

    def cons_for(name):
        return constraints[name] if isinstance(constraints, Mapping) \
            else constraints

    c, cal, fallback = _resolve_robust(calibration, robust, c, engine)
    if fallback:
        _refuse_vertex_with(cal, prune, runtime, keep_ledger)
        _check_objective(objective, engine, pareto_metrics)
        out = {name: _robust_vertex_search(
                   wl, cons_for(name), cal, engine, grid, n_z, objective,
                   pareto_metrics, factorized, space, hierarchical)
               for name, wl in wls.items()}
        return _share_wall(out)
    out = _search_workloads_impl(wls, cons_for, engine, grid, n_z,
                                 hierarchical, c, dev, objective,
                                 pareto_metrics, shard, chunk_size,
                                 factorized, space, prune, runtime,
                                 keep_ledger, workers, deterministic)
    if cal is not None:
        for name, r in out.items():
            r.band = _measure_band(r, cal, wls[name])
    return out


def _share_wall(out):
    """Every result of a per-workload loop reports the batch's wall time."""
    total = sum(r.wall_time_s for r in out.values())
    for r in out.values():
        r.wall_time_s = total
    return out


def _search_workloads_impl(wls, cons_for, engine, grid, n_z, hierarchical,
                           c, dev, objective, pareto_metrics, shard,
                           chunk_size, factorized, space, prune, runtime,
                           keep_ledger, workers=None, deterministic=True):
    """The batched dispatch behind `search_workloads`, after calibration
    resolution (`c` is the corner the batch runs at)."""
    rt0 = SearchRuntime.of(runtime) if runtime is not None else None

    def rt_for(name):
        """Per-workload campaign (own counters + checkpoint subdirectory)
        sharing the batch runtime's fault injector."""
        if rt0 is None:
            return None
        pol = rt0.policy
        if pol.checkpoint_dir:
            pol = dataclasses.replace(
                pol, checkpoint_dir=os.path.join(pol.checkpoint_dir, name))
        sub = SearchRuntime(pol)
        sub.fault_injector = rt0.fault_injector
        return sub

    def per_workload(**kw):
        return _share_wall({
            name: search(wl, cons_for(name), engine=engine, n_z=n_z, c=c,
                         device=dev, objective=objective,
                         pareto_metrics=pareto_metrics, shard=shard,
                         chunk_size=chunk_size, space=space,
                         runtime=rt_for(name), **kw)
            for name, wl in wls.items()})

    if prune == "bound":
        # Same argument contract as search(): validate here rather than
        # silently searching the default product space.
        _factorized_space(space, grid, n_z, engine, hierarchical)
        return per_workload(factorized=True, prune="bound",
                            keep_ledger=keep_ledger, workers=workers,
                            deterministic=deterministic)
    if factorized and engine == "cuda" and rt0 is None:
        fspace = _factorized_space(space, grid, n_z, engine, hierarchical)
        return _workloads_cuda_factorized(
            wls, list(wls), cons_for, fspace, c, dev, objective,
            _check_objective(objective, engine, pareto_metrics), shard,
            chunk_size)
    if engine != "cuda" or rt0 is not None:
        # The runtime always takes the per-workload loop: the fused batched
        # launches return byte-identical results, and per-workload
        # campaigns are what make the checkpoint cursors and counters
        # well-defined.
        if grid is None and not factorized:
            grid = _full_grid(n_z)  # materialize once, share across workloads
        return per_workload(grid=grid, hierarchical=hierarchical,
                            factorized=factorized)
    if space is not None:
        raise ValueError("space= requires factorized=True (pass grid= for "
                         "materialized candidate sets)")
    grid = np.asarray(_full_grid(n_z) if grid is None else grid)
    names = list(wls)
    metrics = _check_objective(objective, engine, pareto_metrics)
    if shard is not None or chunk_size is not None:
        return _workloads_cuda_streamed(wls, names, cons_for, grid,
                                        hierarchical, c, dev, objective,
                                        metrics, shard, chunk_size)

    t0 = time.perf_counter()
    sub = _union_prefiltered(grid, wls, names, cons_for, c, hierarchical,
                             dev)
    n_wl = len(sub)
    if metrics is not None:
        if n_wl == 0:
            return {name: _pareto_result(sub, 0, wls[name], cons_for(name),
                                         c, metrics, len(grid), 0, t0)
                    for name in names}
        from ..kernels.ops import dse_pareto_multi
        per_wl = dse_pareto_multi(sub, [wls[n] for n in names],
                                  [cons_for(n) for n in names], c, dev,
                                  objectives=metrics)
        wall = time.perf_counter() - t0
        out = {}
        for name, (cand_idx, nf, n_over) in zip(names, per_wl):
            r = _pareto_result(sub[cand_idx], nf, wls[name], cons_for(name),
                               c, metrics, len(grid), n_wl, t0)
            r.wall_time_s = wall
            r.n_overflow = n_over
            out[name] = r
        return out

    from ..kernels.ops import dse_search_multi
    if n_wl == 0:
        wall = time.perf_counter() - t0
        return {name: _make_result(None, 0, wls[name], c, len(grid), 0, wall)
                for name in names}
    best, _, nf = dse_search_multi(sub, [wls[n] for n in names],
                                   [cons_for(n) for n in names], c, dev)
    wall = time.perf_counter() - t0
    return {name: _make_result(sub[i] if i >= 0 else None, f, wls[name], c,
                               len(grid), n_wl, wall)
            for name, i, f in zip(names, best, nf)}
