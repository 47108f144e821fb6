"""`shard=` on the port's factorized, bound-guided, robust and checkpointed
searches, against the reference.

The shard rows of the reference's `tests/test_factorized.py`,
`test_bnb.py`, `test_golden_reference.py`, `test_robust_search.py`
(`MATRIX_KNOBS`) and `test_resilience.py` (`MATRIX`: a kill at every
checkpoint boundary, resumed), on the port's `numpy`, `torch` and `cuda`
engines with `device="cpu"` (the cuda engine through its kernels' plain
versions, the torch engine and the cuda kernels on a one-device candidate
mesh; numpy splits spans and index vectors `shard` ways on the host). The
reference runs the same calls with its numpy engine in the same process,
each shared across a file's cases by a module fixture where several cases
hold to it; the 12^5 searches also hold to `tests/golden/dse_12x5.json`.
Tolerance: exact — winners, float64 metrics, frontier rows and every
counter (`n_feasible`, `n_workload_evals`, `n_pruned`, `n_bounds`, the
runtime's `n_checkpoints` / `resumed_step`), and the robust searches'
bands.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core.paper_workloads import PAPER_WORKLOADS, load
from repro.testing import FaultSpec as RSpec
from repro.testing import inject as r_inject
import repro_torch.core as P
from repro_torch.interop import from_reference
from repro_torch.testing import FaultSpec, inject

GOLDEN = pathlib.Path(__file__).parent / "golden" / "dse_12x5.json"
AXES = ((1, 2, 3, 4, 5), (1, 2, 3, 4), (2, 4, 6), (1, 3, 5, 7), (4, 8, 12))
SPACE, R_SPACE = P.FactorizedSpace(AXES), R.FactorizedSpace(AXES)
ENGINES = ("numpy", "torch", "cuda")
NAMES = sorted(PAPER_WORKLOADS)
COUNTERS = ("n_evaluated", "n_feasible", "n_workload_evals", "n_pruned",
            "n_bounds")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These cases run many small torch ops; beside other test processes
    on the same cores, intra-op thread pools spin against each other and
    slow them tenfold. One thread a process (restored after the file)
    gives the same results: every reduction here is exact."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(objective, ref, got, label, counters=COUNTERS):
    for f in counters:
        assert getattr(got, f) == getattr(ref, f), (label, f)
    if objective == "edp":
        want = None if ref.best_cfg is None else tuple(ref.best_cfg.as_array())
        have = None if got.best_cfg is None else tuple(got.best_cfg.as_array())
        assert have == want, label
        for f in ("area_mm2", "power_w", "energy_j", "latency_s", "edp"):
            a, b = getattr(ref, f), getattr(got, f)
            assert a == b or (a != a and b != b), (label, f)
        return
    assert np.array_equal(got.front, ref.front), label
    for k in R.REPORT_METRICS:
        assert np.array_equal(got.metrics[k], ref.metrics[k]), (label, k)


@pytest.fixture(scope="module")
def deit_s():
    """deit-s on SPACE, the reference's numpy one-shot, BnB included."""
    wl = load("deit-s")
    refs = {(objective, prune): R.search(
        wl, R.Constraints(), engine="numpy", factorized=True, space=R_SPACE,
        objective=objective, prune=prune)
        for objective in ("edp", "pareto") for prune in (None, "bound")}
    return from_reference(wl), refs


# ---------------------------------------------------------------------------
# Factorized streams and fan-out (test_factorized.py's shard rows)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("objective", ["edp", "pareto"])
@pytest.mark.parametrize("engine", ENGINES)
def test_factorized_streamed_sharded_matches_reference(engine, objective,
                                                       deit_s):
    pw, refs = deit_s
    ref = refs[objective, None]
    one = P.search(pw, P.Constraints(), engine=engine, factorized=True,
                   space=SPACE, objective=objective, device="cpu")
    for shard, cs in ((4, None), (None, 97), (2, 256), (4, SPACE.size),
                      (16, 333)):
        got = P.search(pw, P.Constraints(), engine=engine, factorized=True,
                       space=SPACE, objective=objective, shard=shard,
                       chunk_size=cs, device="cpu")
        label = f"{engine}/{objective}/shard={shard}/chunk={cs}"
        _same(objective, ref, got, label)
        if objective == "pareto":
            assert got.n_overflow == one.n_overflow, label


@pytest.mark.parametrize("engine", ENGINES)
def test_factorized_full_grid_matches_golden(engine):
    committed = json.loads(GOLDEN.read_text())["workloads"]["deit-b"]
    r = P.search(from_reference(load("deit-b")), P.Constraints(),
                 engine=engine, factorized=True, chunk_size=65536, shard=2,
                 device="cpu")
    assert [int(x) for x in r.best_cfg.as_array()] == committed["best"]
    assert r.n_feasible == committed["n_feasible"]
    assert float(r.edp) == committed["edp"]


def test_factorized_zero_feasible():
    kw = dict(area_mm2=1.0, power_w=0.01, energy_mj=1e-9, latency_ms=1e-9)
    pw = from_reference(load("deit-t"))
    for engine in ENGINES:
        r = P.search(pw, P.Constraints(**kw), engine=engine, factorized=True,
                     space=SPACE, shard=2, chunk_size=333, device="cpu")
        assert not r.feasible and r.n_feasible == 0
        assert r.n_evaluated == SPACE.size
        p = P.search(pw, P.Constraints(**kw), engine=engine, factorized=True,
                     space=SPACE, objective="pareto", shard=4, device="cpu")
        assert p.front.shape == (0, 5) and p.n_feasible == 0


@pytest.mark.parametrize("objective", ["edp", "pareto"])
def test_factorized_search_workloads_batched(objective):
    wls = {n: load(n) for n in NAMES}
    pwls = {n: from_reference(w) for n, w in wls.items()}
    ref = R.search_workloads(wls, R.Constraints(), engine="numpy", n_z=6,
                             objective=objective, factorized=True)
    for engine in ENGINES:
        got = P.search_workloads(pwls, P.Constraints(), engine=engine,
                                 n_z=6, objective=objective, factorized=True,
                                 space=P.FactorizedSpace.full(6), shard=2,
                                 chunk_size=4001, device="cpu")
        for name in wls:
            _same(objective, ref[name], got[name],
                  f"{engine}/{objective}/{name}")


# ---------------------------------------------------------------------------
# Branch-and-bound (test_bnb.py's shard row)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("objective", ["edp", "pareto"])
def test_bnb_counters_identical_across_engines_and_settings(objective,
                                                            deit_s):
    # The slab schedule is engine-independent, so the counters (and the
    # answer) agree across engines and (shard, chunk_size) settings.
    pw, refs = deit_s
    ref = refs[objective, "bound"]
    for engine in ENGINES:
        for shard, cs in ((None, None), (4, None), (None, 97), (2, 256)):
            got = P.search(pw, P.Constraints(), engine=engine,
                           factorized=True, space=SPACE, objective=objective,
                           prune="bound", shard=shard, chunk_size=cs,
                           device="cpu")
            _same(objective, ref, got, f"{engine}/{shard}/{cs}")
            assert got.n_workload_evals + got.n_pruned == SPACE.size


# ---------------------------------------------------------------------------
# The golden record (test_golden_reference.py's streamed/sharded row)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_engines_match_golden_sharded(engine):
    committed = json.loads(GOLDEN.read_text())["workloads"]
    for name in NAMES:
        gold = committed[name]
        best = P.search(from_reference(load(name)), P.Constraints(),
                        engine=engine, hierarchical=True, shard=2,
                        chunk_size=65536, device="cpu")
        assert [int(x) for x in best.best_cfg.as_array()] == gold["best"]
        assert best.edp == gold["edp"]
        assert best.n_feasible == gold["n_feasible"]


# ---------------------------------------------------------------------------
# Robust search (test_robust_search.py's MATRIX_KNOBS shard row)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("objective", ["edp", "pareto"])
@pytest.mark.parametrize("engine", ENGINES)
def test_robust_sharded_matches_reference(engine, objective):
    wl = load("deit-t")
    pw = from_reference(wl)
    deg = P.CalibratedConstants.degenerate()
    plain = P.search(pw, P.Constraints(), engine=engine, n_z=8,
                     objective=objective, shard=2, device="cpu")
    flat = P.search(pw, P.Constraints(), engine=engine, n_z=8,
                    objective=objective, shard=2, calibration=deg,
                    robust="worst_case", device="cpu")
    _same(objective, plain, flat, f"{engine}/{objective}/degenerate")
    assert flat.band is not None
    for k in flat.band.worst:
        assert np.array_equal(flat.band.worst[k], flat.band.best[k])
    ref = R.search(wl, R.Constraints(), engine="numpy", n_z=8,
                   objective=objective, shard=2, calibration="conservative",
                   robust="worst_case")
    got = P.search(pw, P.Constraints(), engine=engine, n_z=8,
                   objective=objective, shard=2, calibration="conservative",
                   robust="worst_case", device="cpu")
    _same(objective, ref, got, f"{engine}/{objective}/conservative")
    for side in ("worst", "nominal", "best"):
        a, b = getattr(ref.band, side), getattr(got.band, side)
        for k in a:
            assert np.array_equal(a[k], b[k]), (engine, side, k)


# ---------------------------------------------------------------------------
# The resilient runtime under shard= (test_resilience.py's MATRIX)
# ---------------------------------------------------------------------------

RUNTIME = ("n_checkpoints", "resumed_step", "n_retries", "n_fallbacks",
           "n_quarantined")


def _grid(seed, size=700):
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(1, 13, size=(size, 5)), axis=0)


def _killed_then_resumed(pkg, d, spec, search):
    """`search(runtime)` killed by `spec`, then resumed from `d` with a
    clean runtime; returns (result, killed)."""
    pol = pkg.RuntimePolicy(checkpoint_dir=str(d), sleep=lambda s: None)
    rt = pkg.SearchRuntime(pol)
    with (r_inject if pkg is R else inject)(rt, [spec]):
        try:
            return search(rt), False
        except pkg.KillSearch:
            pass
    return search(pkg.SearchRuntime(pol)), True


@pytest.mark.parametrize("objective", ["edp", "pareto"])
@pytest.mark.parametrize("engine", ENGINES)
def test_kill_at_every_boundary_resumes_under_shard(engine, objective,
                                                    tmp_path):
    wl = load("deit-t")
    pw = from_reference(wl)
    grid = _grid(4)
    kw = dict(grid=grid, objective=objective, shard=2, chunk_size=200)
    n_units = -(-len(grid) // 200)
    for b in range(n_units):
        want, _ = _killed_then_resumed(
            R, tmp_path / f"r{b}", RSpec("checkpoint", "kill", b),
            lambda rt: R.search(wl, R.Constraints(), engine="numpy",
                                runtime=rt, **kw))
        got, killed = _killed_then_resumed(
            P, tmp_path / f"p{b}", FaultSpec("checkpoint", "kill", b),
            lambda rt: P.search(pw, P.Constraints(), engine=engine,
                                runtime=rt, device="cpu", **kw))
        label = f"{engine}/{objective}/kill@ckpt{b}"
        assert killed, label
        _same(objective, want, got, label, COUNTERS + RUNTIME)
        assert got.resumed_step == b + 1, label


@pytest.mark.parametrize("objective", ["edp", "pareto"])
def test_bnb_kill_resume_under_shard(objective, tmp_path):
    wl = load("deit-t")
    pw = from_reference(wl)
    # the 12^5 space: a probe and sweep batches, each one checkpoint unit
    kw = dict(factorized=True, objective=objective, prune="bound", shard=4,
              chunk_size=4000, n_z=12)
    want, _ = _killed_then_resumed(
        R, tmp_path / "r", RSpec("checkpoint", "kill", 1),
        lambda rt: R.search(wl, R.Constraints(), engine="numpy", runtime=rt,
                            **kw))
    for engine in ENGINES:
        got, killed = _killed_then_resumed(
            P, tmp_path / engine, FaultSpec("checkpoint", "kill", 1),
            lambda rt: P.search(pw, P.Constraints(), engine=engine,
                                runtime=rt, device="cpu", **kw))
        assert killed and got.resumed_step == 2
        _same(objective, want, got, engine, COUNTERS + RUNTIME)


def test_checkpoints_are_bound_to_shard(tmp_path):
    """A checkpoint is bound to its (shard, chunk_size), as in the
    reference: resuming a shard=2 campaign at another shard refuses it."""
    wl = load("deit-t")
    pw = from_reference(wl)
    grid = _grid(8)
    for pkg, w, extra in ((R, wl, {}), (P, pw, {"device": "cpu"})):
        d = tmp_path / pkg.__name__
        _, killed = _killed_then_resumed(
            pkg, d, (RSpec if pkg is R else FaultSpec)("checkpoint", "kill",
                                                        0),
            lambda rt: pkg.search(w, pkg.Constraints(), engine="numpy",
                                  grid=grid, shard=2, chunk_size=200,
                                  runtime=rt, **extra))
        assert killed
        for shard in (None, 4):
            with pytest.raises(pkg.CheckpointMismatch):
                pkg.search(w, pkg.Constraints(), engine="numpy", grid=grid,
                           shard=shard, chunk_size=200, **extra,
                           runtime=pkg.SearchRuntime(pkg.RuntimePolicy(
                               checkpoint_dir=str(d), sleep=lambda s: None)))
