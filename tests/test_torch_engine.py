"""The port's `torch` engine against the reference's `jax` engine.

`repro_torch`'s `engine="torch", device="cpu"` runs the cost model, the
feasibility mask, the argmin and the sort-and-scan frontier pass in plain
torch float32; `repro`'s `engine="jax"` runs the same steps jit-compiled,
and its `engine="numpy"` in float64. Inputs: the five paper workloads, the
paper constraints, and grids and product spaces made from a seed with
numpy. Tolerance: exact. Winners, every counter (`n_evaluated`,
`n_feasible`, `n_workload_evals`, `n_pruned`, `n_bounds`, `n_overflow`),
the float64 reported metrics and the frontier rows and metrics must be
equal byte for byte to both reference engines, in every form the engine
layer has: flat, hierarchical, zero-feasible, chunked, factorized (the
whole space and index spans) and `prune="bound"`, in both objectives.

The float32 metric arrays are held bit for bit against the reference's
jax cost model compiled with XLA's algebraic simplifier off and LLVM at
-O0 (`STRICT`, as in `tests/test_torch_dse_kernels.py`): XLA's default CPU
pipeline moves them by an ulp (a division by a constant becomes a
reciprocal multiply, multiply-adds contract), which is what the torch
engine does not replicate. The search results above agree all the same.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
from repro.core.factorized import evaluate_space as ref_evaluate_space
from repro.core.paper_workloads import PAPER_WORKLOADS, load
from repro.core.performance_model import eval_wload_arrays as ref_eval_wload
from repro.core.performance_model import workload_statics as ref_statics
from repro.core.photonic_model import CONSTANTS as REF_C
from repro.core.photonic_model import eval_hw as ref_eval_hw
from repro.kernels import ref as r_ref
import repro_torch.core as P
from repro_torch.core.factorized import evaluate_space_tensors
from repro_torch.core.performance_model import (eval_wload_tensors,
                                                gemm_tensor, workload_statics)
from repro_torch.core.photonic_model import eval_hw
from repro_torch.interop import from_reference
from repro_torch.kernels import ref as p_ref

# `repro.core.search` the module (the package exports the function too).
r_search = importlib.import_module("repro.core.search")
p_search = importlib.import_module("repro_torch.core.search")
STRICT = {"xla_disable_hlo_passes": "algsimp",
          "xla_backend_optimization_level": 0}
C = from_reference(REF_C)
NAMES = sorted(PAPER_WORKLOADS)
CPU = torch.device("cpu")
METRICS = ("area", "power", "energy", "latency", "util", "edp")
COUNTERS = ("n_evaluated", "n_feasible", "n_workload_evals", "n_pruned",
            "n_bounds")
GRID = np.unique(np.random.default_rng(17).integers(1, 13, size=(3000, 5)),
                 axis=0)
# An uneven 720-point product space.
SPACE = ((1, 2, 3, 4, 5), (1, 2, 3, 4), (2, 4, 6), (1, 3, 5, 7), (4, 8, 12))

FORMS = {
    "flat": dict(grid=GRID),
    "hierarchical": dict(grid=GRID, hierarchical=True),
    "chunked": dict(grid=GRID, chunk_size=977),
    "factorized": dict(factorized=True, space=SPACE),
    "factorized_spans": dict(factorized=True, space=SPACE, chunk_size=97),
    "bound": dict(factorized=True, n_z=7, prune="bound"),
}


def _same(ref, got, label):
    """Byte-equal results: winner or frontier, float64 metrics, counters."""
    if isinstance(ref, R.SearchResult):
        want = None if ref.best_cfg is None else tuple(ref.best_cfg.as_array())
        have = None if got.best_cfg is None else tuple(got.best_cfg.as_array())
        assert have == want, label
        for f in ("area_mm2", "power_w", "energy_j", "latency_s", "edp"):
            a, b = getattr(ref, f), getattr(got, f)
            assert a == b or (a != a and b != b), (label, f, a, b)
    else:
        assert np.array_equal(ref.front, got.front), label
        assert set(ref.metrics) == set(got.metrics), label
        for k in ref.metrics:
            assert np.array_equal(ref.metrics[k], got.metrics[k]), (label, k)
        assert ref.n_overflow == got.n_overflow, label
    for f in COUNTERS:
        assert getattr(ref, f) == getattr(got, f), (label, f)


@pytest.mark.parametrize("objective", ["edp", "pareto"])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_torch_engine_matches_jax_and_numpy(form, objective):
    name = NAMES[sorted(FORMS).index(form) % len(NAMES)]
    wl = load(name)
    kw = dict(FORMS[form], objective=objective)
    got = P.search(from_reference(wl), P.Constraints(), engine="torch",
                   device="cpu", **kw)
    for engine in ("jax", "numpy"):
        ref = R.search(wl, R.Constraints(), engine=engine, **kw)
        _same(ref, got, (form, objective, name, engine))


@pytest.mark.parametrize("form", ["flat", "factorized", "bound"])
def test_zero_feasible(form):
    impossible = dict(area_mm2=1.0, power_w=0.01, energy_mj=1e-9,
                      latency_ms=1e-9)
    wl = load("deit-t")
    for objective in ("edp", "pareto"):
        kw = dict(FORMS[form], objective=objective)
        got = P.search(from_reference(wl), P.Constraints(**impossible),
                       engine="torch", device="cpu", **kw)
        ref = R.search(wl, R.Constraints(**impossible), engine="jax", **kw)
        _same(ref, got, (form, objective))
        assert got.n_feasible == 0


def test_pareto_util_metric_and_workloads_batch():
    """`pareto_metrics` with "util" (the cuda kernels refuse it), and the
    batched entry point looping the engine per workload."""
    wl = load("bert-l")
    metrics = ("util", "energy", "area")
    for kw in (dict(grid=GRID[:1500]), dict(factorized=True, space=SPACE)):
        ref = R.search(wl, R.Constraints(), engine="jax", objective="pareto",
                       pareto_metrics=metrics, **kw)
        got = P.search(from_reference(wl), P.Constraints(), engine="torch",
                       device="cpu", objective="pareto",
                       pareto_metrics=metrics, **kw)
        _same(ref, got, tuple(kw))
    wls = {n: load(n) for n in NAMES}
    ref = R.search_workloads(wls, R.Constraints(), engine="numpy",
                             grid=GRID, hierarchical=True)
    got = P.search_workloads(from_reference(wls), P.Constraints(),
                             engine="torch", device="cpu", grid=GRID,
                             hierarchical=True)
    for n in NAMES:
        got[n].wall_time_s = ref[n].wall_time_s
        _same(ref[n], got[n], n)


def test_dxpta_search_paper_forms():
    wl = load("deit-s")
    for kw in (dict(), dict(factorized=True), dict(prune="bound")):
        ref = R.dxpta_search(wl, R.Constraints(), engine="jax", n_z=8, **kw)
        got = P.dxpta_search(from_reference(wl), P.Constraints(),
                             engine="torch", n_z=8, device="cpu", **kw)
        _same(ref, got, tuple(kw))


def _scan_points():
    """Three objectives over two scan chunks, rows shuffled. The first
    sorted chunk holds a front of 300 mutually non-dominated points, 40
    exact duplicates of some (ties stay) and points they dominate: 340
    survivors, past the 256-row buffer. The second holds (300, 701, 5),
    which only the front's dropped last row dominates, points it dominates,
    random points and +inf rows (infeasible lanes)."""
    rng = np.random.default_rng(5)
    chunk = r_search.JAX_PARETO_CHUNK
    x = np.arange(300, dtype=np.float32)
    front = np.stack([x, 1000.0 - x, np.full(300, 5.0, np.float32)], axis=1)
    below = np.stack([rng.integers(0, 300, chunk - 340),
                      rng.integers(1001, 2000, chunk - 340),
                      rng.integers(6, 100, chunk - 340)], axis=1)
    late = np.stack([300.0 + np.arange(20, dtype=np.float32),
                     np.full(20, 701.0, np.float32),
                     np.full(20, 5.0, np.float32)], axis=1)
    spread = rng.integers(300, 1000, size=(500, 3))
    pts = np.full((2 * chunk, 3), np.inf, np.float32)
    pts[:chunk + 520] = np.concatenate(
        [front, front[rng.permutation(300)[:40]], below, late, spread])
    return pts[rng.permutation(len(pts))]


def test_pareto_scan_mask_matches_reference():
    pts = _scan_points()
    want = np.asarray(r_search._pareto_scan_mask(
        [jnp.asarray(pts[:, k]) for k in range(3)]))
    got = p_search._pareto_scan_mask(
        [torch.from_numpy(pts[:, k].copy()) for k in range(3)])
    assert got.dtype == bool and np.array_equal(got, want)
    assert want.sum() > p_search.TORCH_PARETO_MAX_FRONT  # overflowed
    assert (p_search.TORCH_PARETO_CHUNK, p_search.TORCH_PARETO_MAX_FRONT) == (
        r_search.JAX_PARETO_CHUNK, r_search.JAX_PARETO_MAX_FRONT)


def _strict(fn, *args):
    args = [jnp.asarray(a) for a in args]
    return [np.asarray(x) for x in
            jax.jit(fn).lower(*args).compile(STRICT)(*args)]


def _bits_equal(got, want, label):
    for k, w in zip(METRICS, want):
        g = got[k].numpy()
        assert g.dtype == np.float32 and np.array_equal(
            g.view(np.int32), w.view(np.int32)), (label, k)


@pytest.mark.parametrize("name", NAMES)
def test_float32_metrics_match_reference_strict(name):
    gemms, sc = ref_statics(load(name), REF_C)
    assert (gemms, sc) == workload_statics(from_reference(load(name)), C)
    garr = jnp.asarray(np.asarray(gemms, np.int64))
    cols = np.random.default_rng(NAMES.index(name)).integers(
        1, 25, size=(5, 4001)).astype(np.float32)

    def ref_grid(cols):
        n = [cols[i] for i in range(5)]
        e, lat, u = ref_eval_wload(*n, garr, *sc[:3], sc[3], REF_C, xp=jnp)
        a, p = ref_eval_hw(*n, sc[3], REF_C, xp=jnp)
        return a, p, e, lat, u, e * lat

    tc = torch.from_numpy(cols)
    g = gemm_tensor(gemms, CPU)
    e, lat, u = eval_wload_tensors(*tc, g, *sc[:3], sc[3], C)
    a, p = eval_hw(*tc, sc[3], C)
    _bits_equal(dict(zip(METRICS, (a, p, e, lat, u, e * lat))),
                _strict(ref_grid, cols), (name, "grid"))

    def ref_space(*idx):
        m = ref_evaluate_space(SPACE, np.asarray(gemms, np.int64), *sc[:3],
                               sc[3], REF_C, xp=jnp, col_dtype=np.float32,
                               idx=idx[0] if idx else None)
        return [m[k] for k in METRICS]

    idx = np.arange(11, 700, dtype=np.int32)
    _bits_equal(evaluate_space_tensors(SPACE, g, *sc[:3], sc[3], C),
                _strict(ref_space), (name, "space"))
    _bits_equal(evaluate_space_tensors(SPACE, g, *sc[:3], sc[3], C,
                                       idx=torch.from_numpy(idx)),
                _strict(ref_space, idx), (name, "span"))


def test_dse_pareto_ref_matches_reference():
    wl = load("bert-b")
    grid = GRID[:2000]
    for objectives in (("area", "power", "edp"), ("energy", "latency")):
        want = r_ref.dse_pareto_ref(grid, wl, R.Constraints(), objectives)
        got = p_ref.dse_pareto_ref(grid, from_reference(wl), P.Constraints(),
                                   objectives, C)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    import repro_torch.kernels as pk
    assert pk.dse_pareto_ref is p_ref.dse_pareto_ref


def test_torch_engine_needs_a_card_by_default(monkeypatch):
    """The default device is the card: without one the engine raises, it
    never carries on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pw = from_reference(load("deit-t"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.search(pw, engine="torch", grid=GRID[:10])
    assert "torch" in P.FACTORIZED_ENGINES and "torch" in P.ENGINES
    assert "torch" in P.PARETO_ENGINES
