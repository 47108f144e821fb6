"""The port's host cost model (`repro_torch.core`) against `repro.core`.

Inputs are the five paper workloads and config grids drawn from a seed with
numpy; reference objects cross over through `repro_torch.interop.
from_reference`. Tolerance: exact — every float64 metric, cycle count, table
and derived static must be equal bit for bit.
"""
import dataclasses
import importlib

import numpy as np
import pytest

from repro.core import arch_params as r_arch
from repro.core import factorized as r_fact
from repro.core import performance_model as r_perf
from repro.core import photonic_model as r_phot
from repro.core import significance as r_sig
from repro.core.paper_workloads import PAPER_WORKLOADS, load
from repro.core.workload import Gemm
from repro_torch.core import arch_params as p_arch
from repro_torch.core import factorized as p_fact
from repro_torch.core import performance_model as p_perf
from repro_torch.core import photonic_model as p_phot
from repro_torch.core import significance as p_sig
from repro_torch.core.paper_workloads import load as p_load
from repro_torch.interop import from_reference

NAMES = sorted(PAPER_WORKLOADS)
# (`core.search` the module, not the function `core` re-exports)
r_search = importlib.import_module("repro.core.search")
p_search = importlib.import_module("repro_torch.core.search")
C = from_reference(r_phot.CONSTANTS)


def _grid(seed, n=3000):
    return np.random.default_rng(seed).integers(1, 25, size=(n, 5))


def _same_dict(a, b):
    assert list(a) == list(b)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


@pytest.mark.parametrize("name", NAMES)
def test_grid_metrics_bit_identical(name):
    wl, pw = load(name), from_reference(load(name))
    grid = _grid(sum(map(ord, name)))
    _same_dict(r_search.evaluate_grid(grid, wl),
               p_search.evaluate_grid(grid, pw, C))
    sram = r_phot.sram_mb_for_workload(wl.max_act_bytes)
    assert p_phot.sram_mb_for_workload(pw.max_act_bytes, C) == sram
    cols = [grid[:, i] for i in range(5)]
    for bd in ("area_breakdown", "power_breakdown"):
        _same_dict(getattr(r_phot, bd)(*cols, sram),
                   getattr(p_phot, bd)(*cols, sram, C))
    ref = r_perf.eval_wload_arrays(*cols, wl.gemm_array, wl.elec_ops,
                                   wl.weight_bytes, wl.act_io_bytes, sram)
    got = p_perf.eval_wload_arrays(*cols, pw.gemm_array, pw.elec_ops,
                                   pw.weight_bytes, pw.act_io_bytes, sram, C)
    for a, b in zip(ref, got):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", NAMES)
def test_scalar_eval_full_and_statics_bit_identical(name):
    wl, pw = load(name), from_reference(load(name))
    for row in _grid(7, 40):
        cfg = r_arch.PTAConfig.from_array(row)
        assert p_perf.eval_full(p_arch.PTAConfig.from_array(row), pw, C) \
            == r_perf.eval_full(cfg, wl)
        assert p_phot.eval_hw(*row.tolist(), 8.0, C) \
            == r_phot.eval_hw(*row.tolist(), 8.0)
    assert p_perf.workload_statics(pw, C) == r_perf.workload_statics(wl)
    assert p_perf.fps(pw, 1e-3) == r_perf.fps(wl, 1e-3)


def test_gemm_cycles_and_factor_tables_bit_identical():
    rng = np.random.default_rng(5)
    dims = rng.integers(1, 2 ** 40, size=(3, 64))   # past int32 too
    cfg = rng.integers(1, 25, size=(5, 64))
    assert np.array_equal(p_perf.gemm_cycles(*dims, *cfg),
                          r_perf.gemm_cycles(*dims, *cfg))
    gemms = np.concatenate([rng.integers(1, 5000, size=(6, 3)),
                            np.ones((6, 1), np.int64)], axis=1)
    divs = [rng.integers(1, 145, size=n) for n in (30, 12, 40)]
    for a, b in zip(p_perf.cycle_factor_tables(gemms, *divs),
                    r_perf.cycle_factor_tables(gemms, *divs)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_int32_kernel_ceiling_is_shared():
    huge = dataclasses.replace(load("deit-t"),
                               gemms=(Gemm(2 ** 31, 8, 8),))
    with pytest.raises(ValueError, match="int32"):
        r_perf.workload_statics(huge)
    with pytest.raises(ValueError, match="int32"):
        p_perf.workload_statics(from_reference(huge), C)
    assert p_perf.I32_DIM_LIMIT == r_perf.I32_DIM_LIMIT


def test_significance_and_search_space_identical():
    ref, got = r_sig.observe_significance(), p_sig.observe_significance()
    assert {k: dataclasses.astuple(v) for k, v in ref.items()} \
        == {k: dataclasses.astuple(v) for k, v in got.items()}
    assert p_sig.significant_params(got) == r_sig.significant_params(ref)
    assert p_search.build_search_space() == r_search.build_search_space()
    assert p_search.progressive_candidates(12, 3, [64, 197]) \
        == r_search.progressive_candidates(12, 3, [64, 197])
    axes = ([1, 2, 3], [2, 4], [1, 5, 7], [3, 6], [4, 8, 12])
    assert np.array_equal(p_arch.config_grid(*axes),
                          r_arch.config_grid(*axes))


def test_from_reference_round_trips_paper_state():
    for name in NAMES:
        wl = load(name)
        pw = from_reference(wl)
        assert type(pw).__module__.startswith("repro_torch.")
        assert pw == p_load(name)
        assert dataclasses.asdict(pw) == dataclasses.asdict(wl)
        assert p_perf.workload_statics(pw, C) == r_perf.workload_statics(wl)
        assert np.array_equal(pw.gemm_array, wl.gemm_array)
    assert dataclasses.asdict(C) == dataclasses.asdict(r_phot.CONSTANTS)
    assert C == p_phot.CONSTANTS and hash(C) == hash(p_phot.CONSTANTS)
    for obj in (r_arch.Constraints(area_mm2=40.0, latency_ms=3.0),
                r_arch.LT_LARGE, r_fact.FactorizedSpace.full(5),
                r_fact.FactorizedSpace(((1, 3), (2,), (4, 8), (1,), (6,)))):
        got = from_reference(obj)
        assert type(got).__module__.startswith("repro_torch.")
        assert dataclasses.asdict(got) == dataclasses.asdict(obj)
    pair = from_reference([load("deit-t"), {"c": r_phot.CONSTANTS}])
    assert pair == [p_load("deit-t"), {"c": C}]
    assert from_reference(C) is C
    with pytest.raises(TypeError):
        from_reference(object())


@pytest.mark.parametrize("bad", [
    {"a_mzm": float("nan")}, {"f_clk_hz": 0.0}, {"p_pd": -1.0},
    {"sram_min_mb": 64.0, "sram_max_mb": 8.0}])
def test_device_constants_validation_matches(bad):
    with pytest.raises(ValueError):
        dataclasses.replace(r_phot.CONSTANTS, **bad)
    with pytest.raises(ValueError):
        dataclasses.replace(C, **bad)


@pytest.mark.parametrize("bad", [
    {"area_mm2": float("nan")}, {"power_w": 0.0}, {"latency_ms": -1.0},
    {"energy_mj": "50"}])
def test_constraints_validation_matches(bad):
    with pytest.raises(ValueError):
        r_arch.Constraints(**bad)
    with pytest.raises(ValueError):
        p_arch.Constraints(**bad)


SPACE = ((1, 2, 3, 4, 5), (1, 2, 3, 4), (2, 4, 6), (1, 3, 5, 7), (4, 8, 12))


def _slabs(rng, radices, n):
    out = []
    for _ in range(n):
        r = []
        for x in radices:
            lo = int(rng.integers(0, x))
            r.append((lo, int(rng.integers(lo + 1, x + 1))))
        out.append(tuple(r))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_factorized_metrics_and_slab_bounds_bit_identical(name):
    wl, pw = load(name), from_reference(load(name))
    rsp = r_fact.FactorizedSpace(SPACE)
    psp = from_reference(rsp)
    _same_dict(r_fact.factorized_evaluate_grid(rsp, wl),
               p_fact.factorized_evaluate_grid(psp, pw, C))
    idx = np.random.default_rng(1).integers(0, rsp.size, 200)
    _same_dict(r_fact.factorized_evaluate_grid(rsp, wl, idx=idx),
               p_fact.factorized_evaluate_grid(psp, pw, C, idx=idx))
    slabs = _slabs(np.random.default_rng(2), rsp.radices, 64)
    for dtype in (np.float64, np.float32):
        ref = r_fact.SlabBoundEvaluator.from_workload(rsp, wl, dtype=dtype)
        got = p_fact.SlabBoundEvaluator.from_workload(psp, pw, C,
                                                      dtype=dtype)
        _same_dict(ref.lower_bounds_batch(slabs),
                   got.lower_bounds_batch(slabs))
        assert ref.lower_bounds(slabs[0]) == got.lower_bounds(slabs[0])
    for ranges in slabs[:8]:
        assert np.array_equal(p_fact.slab_indices(psp.radices, ranges),
                              r_fact.slab_indices(rsp.radices, ranges))
        assert p_fact.slab_spans(psp.radices, ranges) \
            == r_fact.slab_spans(rsp.radices, ranges)
        assert p_fact.slab_bounding_span(psp.radices, ranges) \
            == r_fact.slab_bounding_span(rsp.radices, ranges)
    assert np.array_equal(psp.decode(idx), rsp.decode(idx))
