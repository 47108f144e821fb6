"""The port's Pareto-frontier mode against the reference, end to end.

`repro_torch.core.search(..., objective="pareto")`, `search_workloads`,
`pareto_front` and `pareto_search_refined` run with `device="cpu"` (the
`cuda` engine then runs the frontier kernels' plain PyTorch versions) on
the `python`, `numpy` and `cuda` engines; `repro.core` runs the same calls
on its `numpy` engine and, where `n_overflow` is compared, its `pallas`
engine in interpret mode. Inputs: the five paper workloads, the paper
constraints, seeded grids and small product spaces, the golden 12^5
frontiers. Tolerance: exact — whole `ParetoResult`s (front rows, every
float64 metric array, objectives and every counter) must be equal.
"""
import functools
import json
import pathlib

import numpy as np
import pytest

import repro.core as R
from repro.core.paper_workloads import PAPER_WORKLOADS, load
from repro.kernels import dse_eval as r_dse
from repro.kernels import ops as r_ops
import repro_torch.core as P
from repro_torch.interop import from_reference
from repro_torch.kernels import dse_eval as p_dse
from repro_torch.kernels import ops as p_ops

GOLDEN = pathlib.Path(__file__).parent / "golden" / "dse_12x5.json"
NAMES = sorted(PAPER_WORKLOADS)
COUNTERS = ("objectives", "n_evaluated", "n_feasible", "n_workload_evals",
            "n_pruned", "n_bounds", "n_overflow")
SPACE = ((1, 2, 3, 4, 5), (1, 2, 3, 4), (2, 4, 6), (1, 3, 5, 7), (4, 8, 12))


def _grid(seed, size=1500):
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(1, 13, size=(size, 5)), axis=0)


def _same(ref, got, label, overflow=True):
    """Whole-result equality; `overflow=False` skips n_overflow, which only
    the cuda and pallas engines count."""
    assert type(got).__name__ == "ParetoResult", label
    assert got.front.dtype == ref.front.dtype, label
    assert np.array_equal(got.front, ref.front), label
    assert sorted(got.metrics) == sorted(ref.metrics), label
    for k in R.REPORT_METRICS:
        assert got.metrics[k].dtype == ref.metrics[k].dtype, (label, k)
        assert np.array_equal(got.metrics[k], ref.metrics[k]), (label, k)
    for f in COUNTERS:
        if f == "n_overflow" and not overflow:
            continue
        assert getattr(got, f) == getattr(ref, f), (label, f)
    assert got.pruned_fraction == ref.pruned_fraction, label


def _pair(name):
    return load(name), from_reference(load(name))


# mode -> keyword arguments shared by both packages
MODES = {
    "flat": dict(grid=_grid(1)),
    "hierarchical": dict(grid=_grid(1), hierarchical=True),
    "chunked": dict(grid=_grid(1), chunk_size=611, hierarchical=True),
    "factorized": dict(factorized=True, space=SPACE),
    "factorized_chunked": dict(factorized=True, space=SPACE, chunk_size=97),
    "bound": dict(factorized=True, space=SPACE, prune="bound"),
    "bound_chunked": dict(factorized=True, space=SPACE, prune="bound",
                          chunk_size=50),
    "bound_n_z": dict(factorized=True, n_z=7, prune="bound"),
}


@functools.lru_cache(maxsize=None)
def _ref(name, engine, mode):
    """Cached reference result (several tests compare against one)."""
    return R.search(load(name), R.Constraints(), engine=engine,
                    objective="pareto", **MODES[mode])


def test_pareto_mask_and_merge_match_reference():
    rng = np.random.default_rng(0)
    assert P.pareto_mask(np.zeros((0, 3))).tolist() == []
    cases = [np.asarray([[3.0, 7.0, 1.0]]),
             np.asarray([[1.0, 3.0], [1.0, 2.0]]),
             np.asarray([[1.0, 2.0], [1.0, 2.0], [2.0, 1.0], [2.0, 2.0]])]
    for d in (2, 3, 5):
        pts = rng.integers(0, 6, size=(300, d)).astype(np.float64)
        cases.append(pts)                      # many exact ties
        cases.append(rng.random((200, d)))
    for pts in cases:
        assert P.pareto_mask(pts).tolist() == R.pareto_mask(pts).tolist()
        half = max(len(pts) // 2, 1)
        assert P.merge_fronts(pts[:half], pts[half:]).tolist() == \
            R.merge_fronts(pts[:half], pts[half:]).tolist()
    assert P.dominates([1, 2], [1, 3]) and not P.dominates([1, 2], [1, 2])
    assert P.DEFAULT_OBJECTIVES == R.DEFAULT_OBJECTIVES


@pytest.mark.parametrize("name", NAMES)
def test_grid_engines_match_reference_per_workload(name):
    wl, pw = _pair(name)
    grid = _grid(NAMES.index(name))
    for hier in (False, True):
        ref = R.search(wl, R.Constraints(), engine="numpy", grid=grid,
                       objective="pareto", hierarchical=hier)
        assert ref.feasible
        for engine in ("python", "numpy", "cuda"):
            got = P.search(pw, P.Constraints(), engine=engine, grid=grid,
                           objective="pareto", hierarchical=hier,
                           device="cpu")
            _same(ref, got, (name, engine, hier), overflow=False)
            assert got.n_overflow == 0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_modes_match_numpy_and_pallas_reference(mode):
    kw = MODES[mode]
    wl, pw = _pair("deit-s")
    ref_np = _ref("deit-s", "numpy", mode)
    ref_pl = _ref("deit-s", "pallas", mode)
    _same(ref_np, ref_pl, (mode, "reference engines"), overflow=False)
    for engine in ("numpy", "cuda"):
        got = P.search(pw, P.Constraints(), engine=engine,
                       objective="pareto", device="cpu", **kw)
        _same(ref_pl if engine == "cuda" else ref_np, got, (mode, engine))
    if "prune" in kw:
        # every config is either evaluated or bound-pruned, never both
        assert got.n_workload_evals + got.n_pruned == got.n_evaluated
        unpruned = dict(kw, prune=None)
        full = P.search(pw, P.Constraints(), engine="cuda",
                        objective="pareto", device="cpu", **unpruned)
        assert np.array_equal(full.front, got.front)


def test_block_overflow_at_real_bound_matches_pallas():
    # A full block of duplicates of a feasible config is 2048 mutually
    # non-dominated ties, far past MAX_FRONT; a second run rides in the
    # partial last block. Both overflow, the host refines both blocks
    # whole, and every copy lands on the frontier — as in the reference.
    wl, pw = _pair("deit-t")
    best = R.search(wl, R.Constraints(), engine="numpy",
                    grid=_grid(2)).best_cfg.as_array()
    grid = np.concatenate([np.tile(best, (p_dse.BLOCK, 1)), _grid(43, 1100),
                           np.tile(best, (p_dse.MAX_FRONT + 33, 1))])
    (cand, nf, n_over), = p_ops.dse_pareto_multi(grid, [pw],
                                                 [P.Constraints()],
                                                 device="cpu")
    (r_cand, r_nf, r_over), = r_ops.dse_pareto_multi(grid, [wl],
                                                     [R.Constraints()])
    assert set(range(p_dse.BLOCK)) <= set(cand.tolist())
    assert cand.max() < len(grid) and n_over >= 2
    assert (nf, n_over) == (r_nf, r_over)
    assert np.array_equal(cand, r_cand)
    ref = R.search(wl, R.Constraints(), engine="pallas", grid=grid,
                   objective="pareto")
    got = P.search(pw, P.Constraints(), engine="cuda", grid=grid,
                   objective="pareto", device="cpu")
    _same(ref, got, "overflow")
    assert int((got.front == best).all(axis=1).sum()) == \
        p_dse.BLOCK + p_dse.MAX_FRONT + 33


@pytest.mark.parametrize("metrics", [("energy", "latency"),
                                     ("area", "power", "energy", "latency",
                                      "edp"), ("util", "edp")])
def test_custom_objectives(metrics):
    wl, pw = _pair("bert-b")
    grid = _grid(17, 1200)
    ref = R.search(wl, R.Constraints(), engine="numpy", grid=grid,
                   objective="pareto", pareto_metrics=metrics)
    engines = ("python", "numpy") if "util" in metrics else \
        ("python", "numpy", "cuda")
    for engine in engines:
        _same(ref, P.search(pw, P.Constraints(), engine=engine, grid=grid,
                            objective="pareto", pareto_metrics=metrics,
                            device="cpu"), (metrics, engine),
              overflow=False)
    if "util" in metrics:
        with pytest.raises(ValueError, match="util"):
            P.search(pw, engine="cuda", grid=grid, objective="pareto",
                     pareto_metrics=metrics, device="cpu")


def test_zero_feasible_empty_front():
    impossible = dict(area_mm2=1.0, power_w=0.01, energy_mj=1e-9,
                      latency_ms=1e-9)
    wl, pw = _pair("deit-t")
    for key, kw in MODES.items():
        ref = R.search(wl, R.Constraints(**impossible), engine="numpy",
                       objective="pareto", **kw)
        for engine in ("numpy", "cuda"):
            got = P.search(pw, P.Constraints(**impossible), engine=engine,
                           objective="pareto", device="cpu", **kw)
            assert not got.feasible and got.front.shape == (0, 5)
            _same(ref, got, (key, engine))


@pytest.mark.parametrize("kw", [
    dict(), dict(hierarchical=True), dict(chunk_size=700,
                                          hierarchical=True),
    dict(factorized=True, space=SPACE), dict(factorized=True, n_z=6,
                                             chunk_size=2000),
    dict(factorized=True, space=SPACE, prune="bound")],
    ids=["flat", "hierarchical", "chunked", "factorized", "fact_chunked",
         "bound"])
def test_search_workloads_batched_matches_reference(kw):
    kw = dict(kw)
    if not kw.get("factorized"):
        kw["grid"] = _grid(3)
    wls = {n: load(n) for n in NAMES}
    cons = {n: R.Constraints(area_mm2=30.0 + 5 * i)
            for i, n in enumerate(NAMES)}
    ref = R.search_workloads(wls, cons, engine="numpy", objective="pareto",
                             **kw)
    got = P.search_workloads(from_reference(wls), from_reference(cons),
                             engine="cuda", objective="pareto",
                             device="cpu", **kw)
    if kw.get("hierarchical"):
        # The batched launch evaluates the union of the workloads' area/
        # power survivors (the reference's pallas engine does the same).
        grid = kw["grid"]
        union = np.zeros(len(grid), bool)
        for m in R.hw_prefilter_masks(grid, list(wls.values()),
                                      [cons[n] for n in NAMES]):
            union |= m
        assert all(got[n].n_workload_evals == int(union.sum())
                   for n in NAMES)
    for n in NAMES:
        if kw.get("hierarchical"):
            got[n].n_workload_evals = ref[n].n_workload_evals
        _same(ref[n], got[n], n, overflow=False)
        assert got[n].n_overflow == 0


def test_search_workloads_flat_matches_pallas_overflow_counts():
    wls = {n: load(n) for n in NAMES}
    grid = _grid(5, 3000)
    ref = R.search_workloads(wls, R.Constraints(), engine="pallas",
                             grid=grid, objective="pareto")
    got = P.search_workloads(from_reference(wls), P.Constraints(),
                             engine="cuda", grid=grid, objective="pareto",
                             device="cpu")
    for n in NAMES:
        _same(ref[n], got[n], n)


def test_paper_workloads_match_golden_12x5():
    gold = json.loads(GOLDEN.read_text())
    assert tuple(gold["objectives"]) == P.DEFAULT_OBJECTIVES
    wls = {n: from_reference(load(n)) for n in NAMES}
    flat = P.search_workloads(wls, P.Constraints(), engine="cuda",
                              hierarchical=True, objective="pareto",
                              device="cpu")
    bnb = P.search(wls["deit-t"], P.Constraints(), engine="cuda",
                   factorized=True, prune="bound", objective="pareto",
                   device="cpu")
    for n in NAMES:
        rows = [flat[n]] + ([bnb] if n == "deit-t" else [])
        for r in rows:
            assert [[int(x) for x in row] for row in r.front] == \
                gold["workloads"][n]["front"], n
            for k in R.REPORT_METRICS:
                assert [float(v) for v in r.metrics[k]] == \
                    gold["workloads"][n]["front_metrics"][k], (n, k)
    ref = R.search(load("deit-t"), R.Constraints(), engine="numpy",
                   factorized=True, prune="bound", objective="pareto")
    _same(ref, bnb, "deit-t bound", overflow=False)


def test_bnb_24_matches_pallas_at_the_float32_edge():
    # On the 24^5 space bert-b's (1, 1, 14, 12, 10) and its (n_h, n_v) swap
    # (1, 1, 12, 14, 10) tie in float32 area and power and the swap has the
    # lower EDP, so the reference's frontier kernel drops the first; in
    # float64 their powers differ by one ulp and the numpy engine keeps it.
    # The port's cuda engine must reproduce the reference's pallas engine.
    wl, pw = _pair("bert-b")
    kw = dict(factorized=True, prune="bound", objective="pareto")
    ref = R.search(wl, R.Constraints(), engine="pallas",
                   space=R.FactorizedSpace.full(24), **kw)
    got = P.search(pw, P.Constraints(), engine="cuda",
                   space=P.FactorizedSpace.full(24), device="cpu", **kw)
    _same(ref, got, "bert-b 24^5")
    full = P.search(pw, P.Constraints(), engine="numpy",
                    space=P.FactorizedSpace.full(24), device="cpu", **kw)
    assert {tuple(r) for r in full.front} - {tuple(r) for r in got.front} \
        == {(1, 1, 14, 12, 10)}
    assert full.size == got.size + 1


def test_pareto_front_and_refined_search_match_reference():
    wl, pw = _pair("deit-t")
    grid = _grid(11)
    cons, pcons = R.Constraints(), P.Constraints()
    for kw in (dict(constraints=cons), dict(constraints=cons,
                                            hierarchical=True),
               dict(metrics=("area", "edp"))):
        pkw = dict(kw)
        if "constraints" in kw:
            pkw["constraints"] = pcons
        front, met = R.pareto_front(grid, wl, **kw)
        for engine in ("numpy", "cuda"):
            pfront, pmet = P.pareto_front(grid, pw, engine=engine,
                                          device="cpu", **pkw)
            assert np.array_equal(front, pfront), (kw, engine)
            assert sorted(met) == sorted(pmet)
            for k in met:
                assert np.array_equal(met[k], pmet[k]), (kw, engine, k)
    ref = R.pareto_search_refined(wl, cons, engine="numpy", n_z=8)
    for engine in ("numpy", "cuda"):
        got = P.pareto_search_refined(pw, pcons, engine=engine, n_z=8,
                                      device="cpu")
        _same(ref, got, engine, overflow=False)


def test_kernel_wrappers_match_reference():
    wl, pw = _pair("bert-b")
    wls, pwls = [load("deit-t"), wl], [from_reference(load("deit-t")), pw]
    cons, pcons = R.Constraints(area_mm2=45.0), P.Constraints(area_mm2=45.0)
    space = R.FactorizedSpace(SPACE)
    pspace = from_reference(space)
    slab = ((1, 4), (0, 3), (1, 2), (2, 4), (0, 2))
    for args in ((0, space.size, None), (100, 333, slab)):
        ref = r_ops.dse_pareto_multi_factorized(
            space, args[0], args[1], wls, [cons, cons], slab=args[2])
        got = p_ops.dse_pareto_multi_factorized(
            pspace, args[0], args[1], pwls, [pcons, pcons], device="cpu",
            slab=args[2])
        for (a, f, o), (b, g, q) in zip(ref, got):
            assert np.array_equal(a, b) and (f, o) == (g, q)
    items = [(0, 200, None), (200, 300, slab), (500, 220, None)]
    ref = r_ops.dse_pareto_spans_factorized(space, items, wls, [cons, cons])
    got = p_ops.dse_pareto_spans_factorized(pspace, items, pwls,
                                            [pcons, pcons], device="cpu")
    for (a, f, o), (b, g, q) in zip(ref, got):
        assert np.array_equal(a, b) and (f, o) == (g, q)
    carry = np.asarray([[20.0, 4.0, 1e-4]])
    grid = _grid(8, 2500)
    ref = r_ops.dse_pareto_multi(grid, wls, [cons, cons],
                                 carry_points=[carry, None])
    got = p_ops.dse_pareto_multi(grid, pwls, [pcons, pcons], device="cpu",
                                 carry_points=[carry, None])
    for (a, f, o), (b, g, q) in zip(ref, got):
        assert np.array_equal(a, b) and (f, o) == (g, q)
    assert (p_dse.MAX_FRONT, p_dse.CARRY_FRONT) == (r_dse.MAX_FRONT,
                                                    r_dse.CARRY_FRONT)


def test_slab_member_mask_matches_reference():
    rng = np.random.default_rng(4)
    radices = (5, 4, 3, 4, 3)
    idx = rng.integers(0, int(np.prod(radices)), size=400)
    for slab in (((1, 4), (0, 3), (1, 2), (2, 4), (0, 2)),
                 tuple((0, r) for r in radices)):
        assert np.array_equal(p_ops._slab_member_mask(radices, slab, idx),
                              r_ops._slab_member_mask(radices, slab, idx))


def test_objective_and_metric_validation():
    wl, pw = _pair("deit-t")
    for kw, match in ((dict(objective="latency"), "objective"),
                      (dict(objective="pareto",
                            pareto_metrics=("area", "speed")),
                       "pareto_metrics"),
                      (dict(objective="pareto", pareto_metrics=()),
                       "pareto_metrics")):
        with pytest.raises(ValueError, match=match):
            R.search(wl, **kw)
        with pytest.raises(ValueError, match=match):
            P.search(pw, device="cpu", **kw)
    with pytest.raises(ValueError, match="util"):
        P.search(pw, engine="cuda", objective="pareto",
                 pareto_metrics=("area", "util"), device="cpu")
    # robust= without a calibration is refused as by the reference; a
    # calibration runs (ROADMAP Queue 1 item 9 is ported)
    with pytest.raises(ValueError, match="calibration"):
        R.pareto_front(_grid(1, 50), wl, robust="worst_case")
    with pytest.raises(ValueError, match="calibration"):
        P.pareto_front(_grid(1, 50), pw, robust="worst_case", device="cpu")
    got = P.pareto_search_refined(pw, calibration="nominal", device="cpu")
    want = R.pareto_search_refined(wl, calibration="nominal")
    assert np.array_equal(got.front, want.front)
    assert got.band is not None
