"""The port's cost model against the paper's published endpoints (the
reproduction gates of `tests/test_calibration.py`), each number held equal to
the reference's, and the port's own copies of the calibration presets.

`repro_torch` runs with `device="cpu"`; `repro` runs the same calls. Inputs:
the paper's LT-base/LT-large designs, the five paper workloads and the paper
constraint box. Tolerance: the paper gates keep the reference test's
relative bounds (the paper quotes rounded figures); every port number is
equal to the reference's exactly.
"""
import filecmp
import pathlib

import pytest

import repro.core as R
from repro.core import calibration as r_calibration
from repro.core.paper_workloads import load
import repro_torch.core as P
from repro_torch.core import calibration as p_calibration
from repro_torch.interop import from_reference


def _pw(name):
    return from_reference(load(name))


def test_presets_are_the_ports_own_copies():
    here = pathlib.Path(p_calibration.PRESET_DIR)
    there = pathlib.Path(r_calibration.PRESET_DIR)
    assert here != there and here.parent.name == "core" \
        and "repro_torch" in here.parts
    names = sorted(p.name for p in here.glob("*.json"))
    assert names == sorted(p.name for p in there.glob("*.json")) \
        == ["conservative.json", "node45.json", "nominal.json"]
    for n in names:
        assert filecmp.cmp(here / n, there / n, shallow=False), n


@pytest.mark.parametrize("design,area,power,tol", [
    ("LT_BASE", 60.0, 15.0, 0.10), ("LT_LARGE", 112.0, 28.0, 0.12)])
def test_lt_endpoints(design, area, power, tol):
    a, p = P.eval_hw_config(getattr(P, design))
    assert (a, p) == R.eval_hw_config(getattr(R, design))
    assert a == pytest.approx(area, rel=0.10)   # paper: ~60 / ~112 mm^2
    assert p == pytest.approx(power, rel=tol)   # paper: ~15 / ~28 W


def test_lt_designs_violate_paper_constraints():
    c = P.Constraints()
    for cfg in (P.LT_BASE, P.LT_LARGE):
        area, power = P.eval_hw_config(cfg)
        assert area > c.area_mm2 and power > c.power_w


def test_significance_scores_match_paper_and_reference():
    s, r = P.observe_significance(), R.observe_significance()
    for name in s:
        assert (s[name].s_area, s[name].s_power) == \
            (r[name].s_area, r[name].s_power), name
    assert s["n_t"].s_power == pytest.approx(1.26, abs=0.03)
    assert s["n_t"].s_area == pytest.approx(1.24, abs=0.03)
    assert s["n_c"].s_power == pytest.approx(1.23, abs=0.03)
    assert s["n_c"].s_area == pytest.approx(1.20, abs=0.03)
    for p in ("n_h", "n_v", "n_lambda"):
        assert s[p].s_power < 1.17 and s[p].s_area < 1.08
    assert set(P.significant_params(s)) == {"n_t", "n_c"}


@pytest.mark.parametrize("wname", sorted(R.PAPER_WORKLOADS))
def test_dxpta_finds_the_references_feasible_config(wname):
    r = P.dxpta_search(_pw(wname), device="cpu")
    ref = R.dxpta_search(load(wname))
    assert r.feasible
    assert tuple(r.best_cfg.as_array()) == tuple(ref.best_cfg.as_array())
    for f in ("area_mm2", "power_w", "energy_j", "latency_s", "edp",
              "n_evaluated", "n_feasible", "n_workload_evals"):
        assert getattr(r, f) == getattr(ref, f), f
    c = P.Constraints()
    assert r.area_mm2 < c.area_mm2 and r.power_w < c.power_w
    assert r.energy_j < c.energy_j and r.latency_s < c.latency_s


def test_found_configs_within_paper_reported_maxima():
    # Paper abstract: up to 26 mm^2, 4.8 W, 39 mJ, 6 ms across all models.
    maxes = [0.0, 0.0, 0.0, 0.0]
    for wname in R.PAPER_WORKLOADS:
        r = P.dxpta_search(_pw(wname), engine="cuda", device="cpu")
        maxes = [max(a, b) for a, b in zip(
            maxes, [r.area_mm2, r.power_w, r.energy_j * 1e3,
                    r.latency_s * 1e3])]
    assert maxes[0] <= 26.0 * 1.05
    assert maxes[1] <= 5.0
    assert maxes[2] <= 39.0 * 1.05
    assert maxes[3] <= 6.0 * 1.05


@pytest.mark.parametrize("wname", ["deit-b", "bert-l"])
def test_dxpta_close_to_exhaustive_edp(wname):
    exh = P.grid_search_vectorized(_pw(wname))
    assert exh.edp == R.grid_search_vectorized(load(wname)).edp
    dx = P.dxpta_search(_pw(wname), engine="cuda", device="cpu")
    assert dx.edp <= exh.edp * 1.30


def test_search_speedup_over_exhaustive():
    pw = _pw("deit-t")
    dx = P.dxpta_search(pw, n_z=8, device="cpu")
    ex = P.exhaustive_search(pw, n_z=8)
    assert dx.n_evaluated < ex.n_evaluated
    assert dx.wall_time_s < ex.wall_time_s
    want = R.grid_search_vectorized(load("deit-t"), n_z=8)
    assert tuple(ex.best_cfg.as_array()) == tuple(want.best_cfg.as_array())
    assert dx.feasible and dx.edp <= ex.edp * 1.30
