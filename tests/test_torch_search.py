"""The port's min-EDP co-search against the reference, end to end.

`repro_torch.core.search` / `search_workloads` / `dxpta_search` run with
`device="cpu"` (the `cuda` engine then runs its kernels' plain PyTorch
versions); `repro.core` runs the same calls with its `numpy` engine, or its
`pallas` engine in interpret mode, which the reference holds byte-identical
to it. Inputs: the five paper workloads, the paper constraints and product
spaces and grids made from a seed with numpy. Tolerance: exact — winners,
every float64 reported metric and every counter (`n_feasible`,
`n_workload_evals`, `n_pruned`, `n_bounds`) must be equal.
"""
import importlib
import json
import pathlib

import numpy as np
import pytest

import repro.core as R
from repro.core.paper_workloads import PAPER_WORKLOADS, load
from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
import repro_torch.core as P
from repro_torch.interop import from_reference
from repro_torch.kernels import ops as p_ops
from repro_torch.kernels import ref as p_ref

GOLDEN = pathlib.Path(__file__).parent / "golden" / "dse_12x5.json"
NAMES = sorted(PAPER_WORKLOADS)
FIELDS = ("area_mm2", "power_w", "energy_j", "latency_s", "edp",
          "n_evaluated", "n_feasible", "n_workload_evals", "n_pruned",
          "n_bounds")
# An uneven 720-point product space, and a seeded grid with a ragged size.
SPACE = ((1, 2, 3, 4, 5), (1, 2, 3, 4), (2, 4, 6), (1, 3, 5, 7), (4, 8, 12))
GRID = np.random.default_rng(2024).integers(1, 13, size=(5003, 5))
p_search = importlib.import_module("repro_torch.core.search")


def _same(ref, got, label):
    want = None if ref.best_cfg is None else tuple(ref.best_cfg.as_array())
    have = None if got.best_cfg is None else tuple(got.best_cfg.as_array())
    assert have == want, label
    for f in FIELDS:
        a, b = getattr(ref, f), getattr(got, f)
        assert a == b or (a != a and b != b), (label, f, a, b)
    assert ref.pruned_fraction == got.pruned_fraction, label


def _pair(name):
    return load(name), from_reference(load(name))


# mode -> keyword arguments shared by both packages
MODES = {
    "flat": dict(grid=GRID),
    "hierarchical": dict(grid=GRID, hierarchical=True),
    "flat_chunked": dict(grid=GRID, chunk_size=977, hierarchical=True),
    "factorized": dict(factorized=True, space=SPACE),
    "factorized_chunked": dict(factorized=True, space=SPACE, chunk_size=97),
    "bound": dict(factorized=True, space=SPACE, prune="bound"),
    "bound_chunked": dict(factorized=True, space=SPACE, prune="bound",
                          chunk_size=50),
    "bound_n_z": dict(factorized=True, n_z=7, prune="bound"),
}


@pytest.mark.parametrize("engine", ["numpy", "cuda"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_search_matches_reference(mode, engine):
    kw = MODES[mode]
    for name in ("deit-t", "bert-l"):
        wl, pw = _pair(name)
        ref = R.search(wl, R.Constraints(), engine="numpy", **kw)
        got = P.search(pw, P.Constraints(), engine=engine, device="cpu",
                       **kw)
        _same(ref, got, (mode, engine, name))


def test_python_engine_and_pallas_reference_agree():
    wl, pw = _pair("deit-s")
    grid = GRID[:700]
    ref = R.search(wl, R.Constraints(), engine="pallas", grid=grid,
                   hierarchical=True)
    for engine in ("python", "numpy", "cuda"):
        _same(ref, P.search(pw, P.Constraints(), engine=engine, grid=grid,
                            hierarchical=True, device="cpu"), engine)
    ref = R.search(wl, R.Constraints(), engine="pallas", factorized=True,
                   space=SPACE, prune="bound", chunk_size=64)
    got = P.search(pw, P.Constraints(), engine="cuda", factorized=True,
                   space=SPACE, prune="bound", chunk_size=64, device="cpu")
    _same(ref, got, "pallas bound")


@pytest.mark.parametrize("kw", [
    dict(), dict(hierarchical=True), dict(chunk_size=1500),
    dict(factorized=True, space=SPACE), dict(factorized=True, n_z=6,
                                             chunk_size=2000)],
    ids=["flat", "hierarchical", "chunked", "factorized", "fact_chunked"])
def test_search_workloads_batched_matches_reference(kw):
    kw = dict(kw)
    if not kw.get("factorized"):
        kw["grid"] = GRID
    wls = {n: load(n) for n in NAMES}
    cons = {n: R.Constraints(area_mm2=30.0 + 5 * i)
            for i, n in enumerate(NAMES)}
    ref = R.search_workloads(wls, cons, engine="numpy", **kw)
    got = P.search_workloads(from_reference(wls), from_reference(cons),
                             engine="cuda", device="cpu", **kw)
    for n in NAMES:
        r, g = ref[n], got[n]
        if kw.get("hierarchical"):
            # the batched launch evaluates the union of the survivors
            pr = R.search_workloads(wls, cons, engine="pallas", **kw)[n]
            assert g.n_workload_evals == pr.n_workload_evals, n
            g.n_workload_evals = r.n_workload_evals
        _same(r, g, n)


def test_paper_workloads_match_golden_12x5():
    gold = json.loads(GOLDEN.read_text())["workloads"]
    wls = {n: from_reference(load(n)) for n in NAMES}
    flat = P.search_workloads(wls, P.Constraints(), engine="cuda",
                              hierarchical=True, device="cpu")
    for n in NAMES:
        bnb = P.search(wls[n], P.Constraints(), engine="cuda",
                       factorized=True, prune="bound", device="cpu")
        for r in (flat[n], bnb):
            assert [int(x) for x in r.best_cfg.as_array()] == gold[n]["best"]
            assert float(r.edp) == gold[n]["edp"]
        assert flat[n].n_feasible == gold[n]["n_feasible"]
        ref = R.search(load(n), R.Constraints(), engine="numpy",
                       factorized=True, prune="bound")
        _same(ref, bnb, n)


def test_paper_level_searches_match_reference():
    wl, pw = _pair("deit-b")
    cons, pcons = R.Constraints(), P.Constraints()
    for engine, ref_engine in (("python", "python"), ("numpy", "numpy"),
                               ("cuda", "numpy")):
        _same(R.dxpta_search(wl, cons, n_z=10, engine=ref_engine),
              P.dxpta_search(pw, pcons, n_z=10, engine=engine, device="cpu"),
              engine)
    _same(R.dxpta_search(wl, cons, engine="numpy", prune="bound"),
          P.dxpta_search(pw, pcons, engine="cuda", prune="bound",
                         device="cpu"), "dxpta bound")
    _same(R.dxpta_search(wl, cons, engine="numpy", factorized=True),
          P.dxpta_search(pw, pcons, engine="cuda", factorized=True,
                         device="cpu"), "dxpta factorized")
    ref = R.dxpta_search(wl, cons, n_z=6, collect=True)
    got = P.dxpta_search(pw, pcons, n_z=6, collect=True, device="cpu")
    _same(ref, got, "collect")
    for k in ref.history:
        assert np.array_equal(ref.history[k], got.history[k],
                              equal_nan=k != "feasible"), k
    _same(R.exhaustive_search(wl, cons, n_z=4),
          P.exhaustive_search(pw, pcons, n_z=4), "exhaustive")
    _same(R.grid_search_vectorized(wl, cons, n_z=6),
          P.grid_search_vectorized(pw, pcons, n_z=6), "vectorized")


def test_zero_feasible_everywhere():
    impossible = dict(area_mm2=1.0, power_w=0.01, energy_mj=1e-9,
                      latency_ms=1e-9)
    wl, pw = _pair("deit-t")
    for kw in MODES.values():
        ref = R.search(wl, R.Constraints(**impossible), engine="numpy", **kw)
        got = P.search(pw, P.Constraints(**impossible), engine="cuda",
                       device="cpu", **kw)
        assert got.best_cfg is None and not got.feasible
        _same(ref, got, kw)


def test_hw_prefilter_masks_bit_identical():
    # The reference jits jnp float32; the port runs plain torch float32 in
    # the breakdowns' dict order. The masks must agree on every config.
    grid = R.FactorizedSpace.full(12).to_grid()
    wls = [load(n) for n in NAMES]
    cons = [R.Constraints(area_mm2=a, power_w=p)
            for a, p in ((50.0, 5.0), (37.5, 4.0), (50.0, 5.0), (61.0, 9.5),
                         (20.0, 3.0))]
    ref = R.hw_prefilter_masks(grid, wls, cons)
    got = P.hw_prefilter_masks(grid, from_reference(wls),
                               from_reference(cons), device="cpu")
    for a, b in zip(ref, got):
        assert np.array_equal(a, b)


def test_kernel_wrappers_match_reference_oracles():
    wl, pw = _pair("bert-b")
    cons, pcons = R.Constraints(area_mm2=45.0), P.Constraints(area_mm2=45.0)
    grid = GRID[:3001]
    assert np.array_equal(p_ref.dse_eval_ref(grid, pw),
                          r_ref.dse_eval_ref(grid, wl))
    want = r_ref.dse_search_ref(grid, wl, cons)
    assert p_ref.dse_search_ref(grid, pw, pcons) == want
    i, _, nf = p_ops.dse_search_grid(grid, pw, pcons, device="cpu")
    assert (i, nf) == want == r_ops.dse_search_grid(grid, wl, cons)[::2]
    got = p_ops.dse_eval_grid(grid, pw, device="cpu")
    np.testing.assert_array_equal(got.shape, (len(grid), 4))
    cfg, _ = p_ops.cuda_grid_search(grid, pw, pcons, device="cpu")
    assert tuple(cfg.as_array()) == tuple(
        r_ops.pallas_grid_search(grid, wl, cons)[0].as_array())
    space = R.FactorizedSpace(SPACE)
    pspace = from_reference(space)
    slab = ((1, 4), (0, 3), (1, 2), (2, 4), (0, 2))
    assert np.array_equal(
        p_ops.decode_rows_device(pspace, 37, 500, device="cpu", slab=slab),
        r_ops.decode_rows_device(space, 37, 500, slab=slab))
    wls, pwls = [load("deit-t"), wl], [from_reference(load("deit-t")), pw]
    for args in ((0, space.size, None), (100, 333, slab)):
        ref = r_ops.dse_search_multi_factorized(
            space, args[0], args[1], wls, [cons, cons], slab=args[2])
        got = p_ops.dse_search_multi_factorized(
            pspace, args[0], args[1], pwls, [pcons, pcons], device="cpu",
            slab=args[2])
        assert (got[0], got[2]) == (ref[0], ref[2])
    items = [(0, 200, None), (200, 300, slab), (500, 220, None)]
    ref = r_ops.dse_search_spans_factorized(space, items, wls, [cons, cons])
    got = p_ops.dse_search_spans_factorized(pspace, items, pwls,
                                            [pcons, pcons], device="cpu")
    assert (got[0], got[2]) == (ref[0], ref[2])


@pytest.mark.parametrize("kw", [
    dict(shard=2), dict(runtime="policy"),
    dict(keep_ledger=True), dict(workers=2), dict(calibration="nominal"),
    dict(robust="worst_case")],
    ids=lambda kw: next(iter(kw)) + "=" + str(next(iter(kw.values()))))
def test_later_slices_raise_not_implemented(kw):
    """Every keyword the reference's search takes is ported (shard=, the
    last, ROADMAP Queue 1 item 8): each behaves as the reference does — the
    same error for the same misuse (a runtime that is not a policy, a
    ledger without prune="bound", robust= without a calibration), the same
    result otherwise."""
    pw = from_reference(load("deit-t"))
    kw.setdefault("engine", "numpy")
    assert not hasattr(p_search, "_LATER")
    wl = load("deit-t")
    try:
        want = R.search(wl, **kw)
    except Exception as e:  # the reference's own refusal
        for call in (lambda: P.search(pw, device="cpu", **kw),
                     lambda: P.search_workloads([pw], device="cpu", **kw)):
            with pytest.raises(type(e)):
                call()
        return
    _same(want, P.search(pw, device="cpu", **kw), kw)
    _same(R.search_workloads([wl], **kw)[wl.name],
          P.search_workloads([pw], device="cpu", **kw)[pw.name], kw)


@pytest.mark.parametrize("engine", ["torch", "jax"],
                         ids=lambda e: f"engine={e}")
def test_torch_engine_runs_and_jax_names_it(engine):
    """`torch` is ported and equals numpy; `jax`, the reference's name for
    it, is refused with a ValueError that names `torch`."""
    wl, pw = _pair("deit-t")
    if engine == "jax":
        with pytest.raises(ValueError, match="engine='torch'"):
            P.search(pw, engine="jax", device="cpu")
        with pytest.raises(ValueError, match="engine='torch'"):
            P.search_workloads([pw], engine="jax", device="cpu")
        return
    for kw in (dict(grid=GRID), dict(factorized=True, space=SPACE)):
        _same(R.search(wl, engine="numpy", **kw),
              P.search(pw, engine="torch", device="cpu", **kw), kw)


def test_argument_validation_matches_reference():
    wl, pw = _pair("deit-t")
    cases = [dict(prune="bound"), dict(factorized=True, prune="nope"),
             dict(factorized=True, grid=GRID), dict(factorized=True,
                                                    hierarchical=True),
             dict(space=SPACE), dict(grid=np.zeros((3, 5))),
             dict(grid=np.ones((4, 3))), dict(chunk_size=0),
             dict(engine="tpu"), dict(factorized=True, engine="python")]
    for kw in cases:
        kw.setdefault("engine", "numpy")
        with pytest.raises(ValueError):
            R.search(wl, **kw)
        with pytest.raises(ValueError):
            P.search(pw, device="cpu", **kw)
    with pytest.raises(ValueError, match="2\\*\\*24"):
        P.search(pw, engine="cuda", factorized=True, n_z=28, device="cpu")
    assert p_search.REPORT_METRICS == R.REPORT_METRICS
    assert (p_search.BNB_LEAF, p_search.BNB_BATCH, p_search.BNB_FINE) == (
        R.search.__globals__["BNB_LEAF"], R.search.__globals__["BNB_BATCH"],
        R.search.__globals__["BNB_FINE"])


@pytest.mark.parametrize("form", ["tuples", "array"])
def test_slab_indices_batch_matches_reference(form):
    """The union of many seeded slabs (the bound-guided leaf batches), from
    a list of range tuples or a (B, 5, 2) array, equals the reference's."""
    from repro.core.factorized import slab_indices_batch as r_batch
    from repro_torch.core.factorized import slab_indices_batch as p_batch
    rng = np.random.default_rng(7)
    radices = (5, 7, 6, 8, 9)
    for n_slabs in (0, 1, 3, 40, 200):
        slabs = []
        for _ in range(n_slabs):
            lo = [int(rng.integers(0, r)) for r in radices]
            slabs.append(tuple((a, int(rng.integers(a + 1, r + 1)))
                               for a, r in zip(lo, radices)))
        want = r_batch(radices, slabs)
        arg = slabs if form == "tuples" else \
            np.asarray(slabs, np.int64).reshape(-1, 5, 2)
        got = p_batch(radices, arg)
        assert got.dtype == want.dtype and np.array_equal(got, want), n_slabs
