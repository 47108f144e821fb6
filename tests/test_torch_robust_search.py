"""The port's robust search against the reference's: calibration intervals
through the cost model, the worst-corner reduction on every engine, the
uncertainty bands, the conservative vertex fallback and the robust service.

`repro_torch` runs with `device="cpu"` (the cuda engine then runs its
kernels' plain PyTorch versions, the worst corner's constants folded to
float32 on the host like any others); `repro` runs the same calls with its
numpy engine. Inputs: the paper workloads, the shipped calibration presets
and small product spaces. Tolerance: exact — winners, frontiers, every
float64 metric and band value, and every counter.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as R
import repro.serve as RS
from repro.core.paper_workloads import load
import repro_torch.core as P
from repro_torch.core.calibration import FIELD_NAMES
from repro_torch.interop import from_reference
from repro_torch.serve import SearchService

WL = load("deit-t")
PW = from_reference(WL)
CONS = R.Constraints()
PCONS = P.Constraints()
N_Z = 8
R_CONS = R.load_calibration_preset("conservative")
P_CONS = P.load_calibration_preset("conservative")
P_DEG = P.CalibratedConstants.degenerate()
ENGINES = ("numpy", "torch", "cuda")
COUNTERS = ("n_evaluated", "n_feasible", "n_workload_evals", "n_pruned",
            "n_bounds")


def _core(r):
    """Every comparable result field (wall time, band and ledger are run
    artifacts, not the answer); configs as tuples."""
    out = {}
    for f in dataclasses.fields(r):
        if f.name in ("wall_time_s", "band", "ledger"):
            continue
        v = getattr(r, f.name)
        if f.name == "best_cfg" and v is not None:
            v = tuple(v.as_array())
        out[f.name] = v
    return out


def assert_identical(a, b, label=""):
    ca, cb = _core(a), _core(b)
    assert ca.keys() == cb.keys(), label
    for k in ca:
        va, vb = ca[k], cb[k]
        if isinstance(va, np.ndarray):
            assert np.array_equal(va, vb), (label, k)
        elif isinstance(va, dict):
            assert va.keys() == vb.keys(), (label, k)
            for kk in va:
                assert np.array_equal(va[kk], vb[kk]), (label, k, kk)
        else:
            assert va == vb or (va != va and vb != vb), (label, k)


def assert_same_band(a, b, label=""):
    assert (a is None) == (b is None), label
    if a is None:
        return
    for side in ("worst", "nominal", "best"):
        da, db = getattr(a, side), getattr(b, side)
        assert da.keys() == db.keys()
        for k in da:
            assert np.array_equal(da[k], db[k]), (label, side, k)


def _same_answer(ref, got, label=""):
    """Port result == reference result on winner/frontier, metrics,
    counters and band."""
    if isinstance(ref, R.SearchResult):
        want = None if ref.best_cfg is None else \
            tuple(ref.best_cfg.as_array())
        have = None if got.best_cfg is None else \
            tuple(got.best_cfg.as_array())
        assert have == want, label
        for f in ("area_mm2", "power_w", "energy_j", "latency_s", "edp"):
            a, b = getattr(ref, f), getattr(got, f)
            assert a == b or (a != a and b != b), (label, f)
    else:
        assert np.array_equal(ref.front, got.front), label
        for k in ref.metrics:
            assert np.array_equal(ref.metrics[k], got.metrics[k]), (label, k)
    for f in COUNTERS:
        assert getattr(ref, f) == getattr(got, f), (label, f)
    assert_same_band(ref.band, got.band, label)


def _worst(row, cal, wl=PW):
    rows = np.asarray(row, np.int64).reshape(1, 5)
    return {k: float(v[0])
            for k, v in P.evaluate_grid(rows, wl, cal.worst_case()).items()}


# ---------------------------------------------------------------------------
# Calibrations: the reference's, field for field
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["nominal", "conservative", "node45"])
def test_presets_load_to_the_references(name):
    r, p = R.load_calibration_preset(name), P.load_calibration_preset(name)
    assert p.intervals == r.intervals and p.uncertified == r.uncertified
    for corner in ("nominal", "worst_case", "best_case"):
        assert dataclasses.asdict(getattr(p, corner)()) == \
            dataclasses.asdict(getattr(r, corner)()), corner
    assert p.varying == r.varying and p.unresolved() == r.unresolved()
    assert P.calibration_presets() == R.calibration_presets()


def test_calibration_constructors_and_corners_match():
    spec = {"a_mzm": {"rel": 0.1}, "p_dac": (1e-3, 3e-3),
            "f_clk_hz": (9e9, 10e9, 11e9)}
    r = R.CalibratedConstants.from_dict(spec, uncertified=("a_mzm",))
    p = P.CalibratedConstants.from_dict(spec, uncertified=("a_mzm",))
    assert p.intervals == r.intervals
    assert [dataclasses.asdict(c) for c in p.vertex_corners()] == \
        [dataclasses.asdict(c) for c in r.vertex_corners()]
    assert [dataclasses.asdict(c) for c in p.vertex_corners(sign=-1)] == \
        [dataclasses.asdict(c) for c in r.vertex_corners(sign=-1)]
    assert P.CalibratedConstants.from_rel(0.1).intervals == \
        R.CalibratedConstants.from_rel(0.1).intervals
    assert P_DEG.worst_case() == P.CONSTANTS and P_DEG.is_degenerate
    assert isinstance(P_DEG.worst_case().act_bits, int)
    w, b = P_CONS.worst_case(), P_CONS.best_case()
    assert w.a_mzm > P.CONSTANTS.a_mzm > b.a_mzm
    assert w.f_clk_hz < P.CONSTANTS.f_clk_hz < b.f_clk_hz
    assert P.as_calibration("conservative") == P_CONS
    assert P.as_calibration(P_CONS) is P_CONS


@pytest.mark.parametrize("bad", [
    {"a_mzm": (0.01, 0.009, 0.02)}, {"a_mzm": (-0.1, 0.01, 0.02)},
    {"a_mzm": (float("nan"), 0.01, 0.02)}, {"a_mzm": (0.0, 0.01, 0.02)},
    {"nonsense_field": {"rel": 0.1}}, {"a_mzm": "wide"}])
def test_invalid_calibrations_raise_as_in_the_reference(bad):
    with pytest.raises(ValueError):
        R.CalibratedConstants.from_dict(bad)
    with pytest.raises(ValueError):
        P.CalibratedConstants.from_dict(bad)


def test_unknown_or_oversized_calibrations_raise():
    with pytest.raises(ValueError, match="uncertified"):
        P.CalibratedConstants.from_dict({"a_mzm": {"rel": 0.1}},
                                        uncertified=("bogus",))
    with pytest.raises(ValueError, match="unknown calibration preset"):
        P.load_calibration_preset("does-not-exist")
    with pytest.raises(ValueError):
        P.as_calibration(42)
    many = P.CalibratedConstants.from_dict(
        {f: {"rel": 0.1} for f in FIELD_NAMES[1:11]},
        uncertified=FIELD_NAMES[1:11])
    with pytest.raises(ValueError, match="2\\^"):
        many.vertex_corners()


def test_monotone_table_and_audit_match():
    assert P.MONOTONE == R.MONOTONE
    for f in FIELD_NAMES:
        assert P.field_direction(f) == R.field_direction(f) is not None
    cfgs = np.random.default_rng(0).integers(1, 16, size=(128, 5))
    for name in ("deit-t", "bert-b"):
        assert P.audit_monotonicity(cfgs, from_reference(load(name))) == \
            R.audit_monotonicity(cfgs, load(name)) == []


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_each_metric_moves_in_the_certified_direction(seed):
    """The lemma point by point on seeded configs and fields: perturbing one
    constant moves every metric weakly in its certified direction (0: not
    at all)."""
    rng = np.random.default_rng(seed)
    for _ in range(6):
        row = rng.integers(1, 15, size=(1, 5))
        field = FIELD_NAMES[int(rng.integers(len(FIELD_NAMES)))]
        rel = float(rng.integers(5, 31)) / 100
        nom = getattr(P.CONSTANTS, field)
        lo = P.evaluate_grid(row, PW, dataclasses.replace(
            P.CONSTANTS, **{field: nom * (1 - rel)}))
        hi = P.evaluate_grid(row, PW, dataclasses.replace(
            P.CONSTANTS, **{field: nom * (1 + rel)}))
        for metric in P.MONOTONE:
            d = P.metric_direction(metric, field)
            delta = float(hi[metric][0]) - float(lo[metric][0])
            assert (delta == 0.0) if d == 0 else (d * delta >= 0.0), \
                (metric, field)


# ---------------------------------------------------------------------------
# Degenerate calibration == an uncalibrated search, byte for byte
# ---------------------------------------------------------------------------

KNOBS = {"plain": {}, "chunk": {"chunk_size": 9000},
         "factorized": {"factorized": True},
         "bnb": {"factorized": True, "prune": "bound"}}


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("objective", ["edp", "pareto"])
@pytest.mark.parametrize("knobs", sorted(KNOBS))
def test_degenerate_calibration_is_identity(engine, objective, knobs):
    kw = dict(engine=engine, n_z=N_Z, objective=objective, device="cpu",
              **KNOBS[knobs])
    r0 = P.search(PW, PCONS, **kw)
    r1 = P.search(PW, PCONS, calibration=P_DEG, robust="worst_case", **kw)
    assert_identical(r0, r1, (engine, objective, knobs))
    assert r1.band is not None
    for k in r1.band.worst:
        assert np.array_equal(r1.band.worst[k], r1.band.best[k])
        assert np.array_equal(r1.band.worst[k], r1.band.nominal[k])


def test_degenerate_batched_and_dxpta():
    wls = from_reference({"deit-t": WL, "deit-s": load("deit-s")})
    r0 = P.search_workloads(wls, PCONS, engine="cuda", n_z=N_Z,
                            factorized=True, device="cpu")
    r1 = P.search_workloads(wls, PCONS, engine="cuda", n_z=N_Z,
                            factorized=True, calibration=P_DEG,
                            robust="worst_case", device="cpu")
    for name in wls:
        assert_identical(r0[name], r1[name], name)
        assert r1[name].band is not None
    d0 = P.dxpta_search(PW, PCONS, engine="cuda", prune="bound",
                        device="cpu")
    d1 = P.dxpta_search(PW, PCONS, engine="cuda", prune="bound",
                        calibration=P_DEG, robust="worst_case", device="cpu")
    assert_identical(d0, d1)


def test_calibration_without_robust_runs_nominal():
    ref = R.search(WL, CONS, engine="numpy", n_z=N_Z, calibration=R_CONS)
    r0 = P.search(PW, PCONS, engine="numpy", n_z=N_Z, device="cpu")
    r1 = P.search(PW, PCONS, engine="numpy", n_z=N_Z, calibration=P_CONS,
                  device="cpu")
    assert_identical(r0, r1)
    _same_answer(ref, r1)
    assert r1.band.worst["power"] > r1.band.nominal["power"]


# ---------------------------------------------------------------------------
# Robust != nominal: the witness, on every engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_conservative_rejects_the_nominal_deit_t_winner(engine):
    """The winner-flip witness: a power bound midway between the nominal
    winner's nominal and worst-case power keeps it nominally feasible; the
    robust search must pick another config — the reference's."""
    rn = P.search(PW, PCONS, engine=engine, device="cpu")
    worst = _worst(rn.best_cfg.as_array(), P_CONS)
    assert worst["power"] > rn.power_w
    power = (rn.power_w + worst["power"]) / 2
    box, r_box = P.Constraints(power_w=power), R.Constraints(power_w=power)
    rn2 = P.search(PW, box, engine=engine, device="cpu")
    assert tuple(rn2.best_cfg.as_array()) == tuple(rn.best_cfg.as_array())
    rr = P.search(PW, box, engine=engine, calibration=P_CONS,
                  robust="worst_case", device="cpu")
    assert tuple(rr.best_cfg.as_array()) != tuple(rn.best_cfg.as_array())
    assert _worst(rr.best_cfg.as_array(), P_CONS)["power"] < power
    ref = R.search(WL, r_box, engine="numpy", calibration=R_CONS,
                   robust="worst_case")
    _same_answer(ref, rr, engine)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("preset", ["conservative", "node45"])
@pytest.mark.parametrize("knobs", ["plain", "bnb"])
def test_robust_search_equals_the_references(engine, preset, knobs):
    kw = dict(n_z=N_Z, calibration=preset, robust="worst_case",
              **KNOBS[knobs])
    for objective in ("edp", "pareto"):
        ref = R.search(WL, CONS, engine="numpy", objective=objective, **kw)
        got = P.search(PW, PCONS, engine=engine, objective=objective,
                       device="cpu", **kw)
        _same_answer(ref, got, (engine, preset, knobs, objective))


def test_robust_result_prices_the_worst_case():
    rr = P.search(PW, PCONS, engine="cuda", calibration=P_CONS,
                  robust="worst_case", device="cpu")
    w = _worst(rr.best_cfg.as_array(), P_CONS)
    assert rr.edp == w["edp"] and rr.power_w == w["power"]
    assert rr.band.worst["edp"] == rr.edp
    pr = P.search(PW, PCONS, engine="cuda", objective="pareto",
                  calibration=P_CONS, robust="worst_case", device="cpu")
    m = P.evaluate_grid(pr.front, PW, P_CONS.worst_case())
    assert np.all(PCONS.satisfied(m["area"], m["power"], m["energy"],
                                  m["latency"]))
    for k in P.REPORT_METRICS:
        assert pr.band.worst[k].shape == (pr.size,)
        assert np.all(pr.band.worst[k] >= pr.band.nominal[k])
        assert np.all(pr.band.nominal[k] >= pr.band.best[k])
    band = rr.band
    assert isinstance(band, P.RobustBand)
    with pytest.raises(dataclasses.FrozenInstanceError):
        band.worst = {}
    assert band.width("util") == 0.0


def test_batched_robust_search_equals_the_references():
    names = ("deit-t", "bert-b")
    ref = R.search_workloads({n: load(n) for n in names}, CONS,
                             engine="numpy", n_z=N_Z, factorized=True,
                             calibration=R_CONS, robust="worst_case")
    for kw in (dict(factorized=True), dict(factorized=True, chunk_size=5000),
               dict(factorized=True, prune="bound")):
        got = P.search_workloads(
            {n: from_reference(load(n)) for n in names}, PCONS,
            engine="cuda", n_z=N_Z, calibration=P_CONS, robust="worst_case",
            device="cpu", **kw)
        for n in names:
            want = ref[n]
            assert tuple(got[n].best_cfg.as_array()) == \
                tuple(want.best_cfg.as_array())
            assert got[n].edp == want.edp
            assert_same_band(want.band, got[n].band, (n, kw))


def test_pareto_wrappers_run_robust():
    r1 = P.pareto_search_refined(PW, PCONS, engine="cuda",
                                 calibration=P_CONS, robust="worst_case",
                                 device="cpu")
    r2 = P.pareto_search_refined(PW, PCONS, engine="cuda",
                                 c=P_CONS.worst_case(), device="cpu")
    ref = R.pareto_search_refined(WL, CONS, engine="numpy",
                                  calibration=R_CONS, robust="worst_case")
    assert np.array_equal(r1.front, r2.front)
    assert r1.band is not None and r2.band is None
    _same_answer(ref, r1)
    grid = np.random.default_rng(1).integers(1, 13, size=(400, 5))
    front, met = P.pareto_front(grid, PW, engine="cuda", calibration=P_CONS,
                                robust="worst_case", device="cpu")
    r_front, r_met = R.pareto_front(grid, WL, calibration=R_CONS,
                                    robust="worst_case")
    assert np.array_equal(front, r_front)
    for k in r_met:
        assert np.array_equal(met[k], r_met[k])


def test_infeasible_robust_result_has_no_band():
    rr = P.search(PW, P.Constraints(power_w=1e-6), engine="cuda",
                  calibration=P_CONS, robust="worst_case", device="cpu")
    assert not rr.feasible and rr.band is None


# ---------------------------------------------------------------------------
# Conservative vertex fallback (uncertified fields)
# ---------------------------------------------------------------------------

SPEC = {"p_mzm": {"rel": 0.15}, "f_clk_hz": {"rel": 0.1}}


@pytest.mark.parametrize("objective", ["edp", "pareto"])
@pytest.mark.parametrize("factorized", [False, True])
def test_vertex_fallback_equals_the_references(objective, factorized):
    kw = dict(n_z=N_Z, robust="worst_case", objective=objective,
              factorized=factorized)
    unc = ("p_mzm", "f_clk_hz")
    ref = R.search(WL, CONS, engine="numpy",
                   calibration=R.CalibratedConstants.from_dict(
                       SPEC, uncertified=unc), **kw)
    got = P.search(PW, PCONS, engine="cuda", device="cpu",
                   calibration=P.CalibratedConstants.from_dict(
                       SPEC, uncertified=unc), **kw)
    _same_answer(ref, got)
    cert = P.search(PW, PCONS, engine="cuda", device="cpu",
                    calibration=P.CalibratedConstants.from_dict(SPEC), **kw)
    if objective == "edp":
        assert got.best_cfg == cert.best_cfg
        assert got.n_evaluated == cert.n_evaluated * 4
    else:
        assert np.array_equal(got.front, cert.front)


def test_vertex_fallback_rejects_prune_runtime_ledger():
    unc = P.CalibratedConstants.from_dict(SPEC,
                                          uncertified=("p_mzm", "f_clk_hz"))
    for kw in ({"factorized": True, "prune": "bound"},
               {"factorized": True, "prune": "bound", "keep_ledger": True},
               {"runtime": P.RuntimePolicy()}):
        with pytest.raises(ValueError, match="uncertified"):
            P.search(PW, PCONS, engine="numpy", calibration=unc,
                     robust="worst_case", device="cpu", **kw)
    with pytest.raises(ValueError, match="uncertified"):
        SearchService(engine="numpy", calibration=unc, robust="worst_case",
                      device="cpu")
    with pytest.raises(ValueError, match="uncertified"):
        P.pareto_search_refined(PW, PCONS, calibration=unc,
                                robust="worst_case", device="cpu")


# ---------------------------------------------------------------------------
# Argument validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(robust="worst_case"), "calibration"),
    (dict(c=P.DeviceConstants(a_mzm=0.01), calibration="conservative"),
     "not both"),
    (dict(calibration="conservative", robust="expectile"), "robust"),
    (dict(engine="python", calibration="conservative",
          robust="worst_case"), "python")])
def test_robust_arguments_are_validated(kw, match):
    with pytest.raises(ValueError, match=match):
        P.search(PW, PCONS, device="cpu", **kw)


def test_python_engine_stays_point_calibrated():
    with pytest.raises(ValueError):
        P.dxpta_search(PW, PCONS, engine="python", calibration=P_CONS,
                       robust="worst_case", device="cpu")
    r = P.dxpta_search(PW, PCONS, engine="python", calibration=P_CONS,
                       device="cpu")
    ref = R.dxpta_search(WL, CONS, engine="python", calibration=R_CONS)
    _same_answer(ref, r)


# ---------------------------------------------------------------------------
# The robust service
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["cuda", "torch"])
def test_robust_service_warm_delta_matches_cold_robust(engine):
    svc = SearchService(engine=engine, n_z=N_Z, calibration=P_CONS,
                        robust="worst_case", device="cpu")
    ref = RS.SearchService(engine="numpy", n_z=N_Z, calibration=R_CONS,
                           robust="worst_case")
    for box in ({}, {"power_w": 4.5}, {"power_w": 4.5}):
        got, want = svc.query(PW, box), ref.query(WL, box)
        _same_answer(want, got, box)
        cold = P.search(PW, P.Constraints(**box), engine="numpy", n_z=N_Z,
                        factorized=True, prune="bound", calibration=P_CONS,
                        robust="worst_case", device="cpu")
        assert tuple(got.best_cfg.as_array()) == \
            tuple(cold.best_cfg.as_array()) and got.edp == cold.edp
        assert got.band is not None
    assert svc.stats == ref.stats and svc.stats["warm"] == 1


def test_constants_fingerprint_isolates_memo_and_checkpoints(tmp_path):
    mk = {"engine": "numpy", "n_z": N_Z, "device": "cpu"}
    nominal = SearchService(**mk)
    robust = SearchService(calibration=P_CONS, robust="worst_case", **mk)
    cal_only = SearchService(calibration=P_CONS, **mk)
    assert len({nominal.constants_fingerprint, robust.constants_fingerprint,
                cal_only.constants_fingerprint}) == 3
    rn, rr, rc = (s.query(PW, PCONS) for s in (nominal, robust, cal_only))
    assert rn.best_cfg == rc.best_cfg and rn.band is None \
        and rc.band is not None
    assert rr.best_cfg != rn.best_cfg
    # two services over one checkpoint root never share a directory
    root = str(tmp_path)
    a = SearchService(checkpoint_root=root, **mk)
    ra = a.query(PW, PCONS)
    b = SearchService(checkpoint_root=root, calibration=P_CONS,
                      robust="worst_case", **mk)
    rb = b.query(PW, PCONS)
    assert tuple(rb.best_cfg.as_array()) == tuple(rr.best_cfg.as_array())
    ra2 = SearchService(checkpoint_root=root, **mk).query(PW, PCONS)
    assert ra2.best_cfg == ra.best_cfg and ra2.edp == ra.edp
    assert ra2.resumed_step > 0
