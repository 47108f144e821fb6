"""The port's resilient runtime against the reference's: checkpoint/resume,
retry with degradation (cuda -> torch -> numpy, on the CPU only), NaN
quarantine and the checkpoint layer; and the runtime on a card, where a
unit whose retries run out, or whose result holds NaN, fails its query.

`repro_torch` runs with `device="cpu"` (the cuda engine then runs its
kernels' plain PyTorch versions); `repro` runs the same calls with its
numpy engine, and with its pallas engine (interpret mode) only where the
degradation counters depend on the length of the fallback chain. Both
packages get the same `FaultSpec` schedules. Tolerance: exact — winners,
frontiers, every float64 metric, every counter (`n_retries`,
`n_fallbacks`, `n_quarantined`, `n_checkpoints`, `resumed_step`, the BnB
counters) and the bytes of the checkpoint files.
"""
import os

import numpy as np
import pytest
import torch

import repro.core as R
from repro.checkpoint.checkpointing import CheckpointManager as RManager
from repro.core.paper_workloads import load
from repro.testing import FaultSpec as RSpec
from repro.testing import inject as r_inject
import repro_torch.core as P
from repro_torch.checkpoint import CheckpointManager as PManager
from repro_torch.core import runtime as p_runtime
from repro_torch.interop import from_reference
from repro_torch.kernels import dse_eval as p_dse
from repro_torch.kernels import ops as p_ops
from repro_torch.testing import FaultInjector, FaultSpec, inject, \
    kill_schedule

WL = load("deit-t")
PW = from_reference(WL)
CONS = R.Constraints()
PCONS = P.Constraints()
AXES12 = tuple(tuple(range(1, 13)) for _ in range(5))
AXES6 = tuple(tuple(range(1, 7)) for _ in range(5))
COUNTERS = ("n_retries", "n_fallbacks", "n_quarantined", "n_checkpoints",
            "resumed_step")
BNB = ("n_pruned", "n_bounds")


def _grid(seed, size=700):
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(1, 13, size=(size, 5)), axis=0)


def _r_policy(d=None, **kw):
    kw.setdefault("sleep", lambda s: None)
    return R.RuntimePolicy(checkpoint_dir=str(d) if d else None, **kw)


def _p_policy(d=None, **kw):
    kw.setdefault("sleep", lambda s: None)
    return P.RuntimePolicy(checkpoint_dir=str(d) if d else None, **kw)


def _space_kw(kw, pkg):
    """`space=` in the package's own FactorizedSpace."""
    kw = dict(kw)
    if "space" in kw:
        kw["space"] = pkg.FactorizedSpace(kw["space"])
    return kw


def _same(objective, ref, got, label, counters=()):
    if objective == "edp":
        want = None if ref.best_cfg is None else \
            tuple(ref.best_cfg.as_array())
        have = None if got.best_cfg is None else \
            tuple(got.best_cfg.as_array())
        assert have == want, label
        for f in ("area_mm2", "power_w", "energy_j", "latency_s", "edp"):
            a, b = getattr(ref, f), getattr(got, f)
            assert a == b or (a != a and b != b), (label, f)
    else:
        assert np.array_equal(got.front, ref.front), label
        for k in R.REPORT_METRICS:
            assert np.array_equal(got.metrics[k], ref.metrics[k]), (label, k)
    for f in ("n_evaluated", "n_feasible", "n_workload_evals") + counters:
        assert getattr(got, f) == getattr(ref, f), (label, f)


def _r_run(d, specs, **kw):
    """The reference's run under `specs`; a KillSearch resumes from `d`
    with a clean runtime. Returns (result, killed)."""
    rt = R.SearchRuntime(_r_policy(d))
    with r_inject(rt, specs):
        try:
            return R.search(WL, CONS, runtime=rt, **_space_kw(kw, R)), False
        except R.KillSearch:
            pass
    return R.search(WL, CONS, runtime=R.SearchRuntime(_r_policy(d)),
                    **_space_kw(kw, R)), True


def _p_run(d, specs, **kw):
    rt = P.SearchRuntime(_p_policy(d))
    with inject(rt, specs):
        try:
            return P.search(PW, PCONS, runtime=rt, device="cpu",
                            **_space_kw(kw, P)), False
        except P.KillSearch:
            pass
    return P.search(PW, PCONS, runtime=P.SearchRuntime(_p_policy(d)),
                    device="cpu", **_space_kw(kw, P)), True


# ---------------------------------------------------------------------------
# Retry, backoff, degradation, quarantine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["numpy", "torch", "cuda"])
def test_transient_faults_retry_with_the_reference_backoff(engine):
    grid = _grid(0)
    specs = [("launch", "raise", 0), ("launch", "timeout", 1)]
    r_sleeps, p_sleeps = [], []
    rt = R.SearchRuntime(_r_policy(sleep=r_sleeps.append))
    with r_inject(rt, [RSpec(*s) for s in specs]):
        ref = R.search(WL, CONS, engine="numpy", grid=grid, chunk_size=200,
                       runtime=rt)
    pt = P.SearchRuntime(_p_policy(sleep=p_sleeps.append))
    with inject(pt, [FaultSpec(*s) for s in specs]):
        got = P.search(PW, PCONS, engine=engine, grid=grid, chunk_size=200,
                       runtime=pt, device="cpu")
    _same("edp", ref, got, engine, COUNTERS)
    assert (got.n_retries, got.n_fallbacks) == (2, 0)
    assert p_sleeps == r_sleeps == [0.05, 0.1]


def test_backoff_is_capped_as_in_the_reference():
    sleeps = {}
    for pkg, pol, ins, spec, w in ((R, _r_policy, r_inject, RSpec, WL),
                                   (P, _p_policy, inject, FaultSpec, PW)):
        got = []
        rt = pkg.SearchRuntime(pol(sleep=got.append, max_retries=5,
                                   backoff_cap_s=0.08))
        kw = {} if pkg is R else {"device": "cpu"}
        with ins(rt, [spec("launch", "raise", at=i) for i in range(5)]):
            pkg.search(w, pkg.Constraints(), engine="numpy", grid=_grid(0),
                       chunk_size=400, runtime=rt, **kw)
        sleeps[pkg.__name__] = got
    assert sleeps["repro_torch.core"] == sleeps["repro.core"] \
        == [0.05, 0.08, 0.08, 0.08, 0.08]


def test_numpy_engine_has_no_fallback_and_exhausts():
    rt = P.SearchRuntime(_p_policy())
    with inject(rt, [FaultSpec("launch", "raise", at=-1)]):
        with pytest.raises(P.LaunchExhausted):
            P.search(PW, PCONS, engine="numpy", grid=_grid(0),
                     chunk_size=400, runtime=rt, device="cpu")


@pytest.mark.parametrize("objective", ["edp", "pareto"])
def test_cuda_degrades_to_torch_then_numpy(objective):
    """cuda -> torch -> numpy takes the reference's pallas -> jax -> numpy
    counters under the same schedules (3 failed attempts exhaust the first
    engine, 6 the second, every attempt failing exhausts the chain)."""
    grid = _grid(1)
    kw = dict(grid=grid, objective=objective, chunk_size=len(grid))
    ref = R.search(WL, CONS, engine="numpy", grid=grid, objective=objective)
    for n_faults, fallbacks in ((3, 1), (6, 2)):
        rr = R.SearchRuntime(_r_policy())
        with r_inject(rr, [RSpec("launch", "raise", at=i)
                           for i in range(n_faults)]):
            want = R.search(WL, CONS, engine="pallas", runtime=rr, **kw)
        pt = P.SearchRuntime(_p_policy())
        with inject(pt, [FaultSpec("launch", "raise", at=i)
                         for i in range(n_faults)]):
            got = P.search(PW, PCONS, engine="cuda", runtime=pt,
                           device="cpu", **kw)
        _same(objective, ref, got, n_faults)
        _same(objective, want, got, n_faults, COUNTERS)
        assert (got.n_fallbacks, got.n_retries) == (fallbacks, n_faults)
    pt = P.SearchRuntime(_p_policy())
    with inject(pt, [FaultSpec("launch", "raise", at=-1)]):
        with pytest.raises(P.LaunchExhausted):
            P.search(PW, PCONS, engine="cuda", runtime=pt, device="cpu",
                     **kw)


def test_real_wallclock_timeout_watchdog():
    # A genuinely hung attempt is cut off by the watchdog thread and
    # retried like any transient failure.
    import time as _time
    rt = P.SearchRuntime(_p_policy(timeout_s=0.2))
    calls = {"n": 0}
    real = rt._call

    def hang_once(fn):
        calls["n"] += 1
        if calls["n"] == 1:
            return real(lambda: _time.sleep(30))
        return real(fn)

    rt._call = hang_once
    grid = _grid(2)
    ref = R.search(WL, CONS, engine="numpy", grid=grid)
    got = P.search(PW, PCONS, engine="cuda", grid=grid, chunk_size=len(grid),
                   runtime=rt, device="cpu")
    _same("edp", ref, got, "watchdog")
    assert got.n_retries == 1


@pytest.mark.parametrize("engine", ["numpy", "torch", "cuda"])
@pytest.mark.parametrize("objective", ["edp", "pareto"])
def test_nan_quarantine_rehosts_byte_identically(engine, objective):
    grid = _grid(3)
    kw = dict(engine="numpy", grid=grid, objective=objective, chunk_size=200)
    rr = R.SearchRuntime(_r_policy())
    with r_inject(rr, [RSpec("launch", "nan", at=1)]):
        ref = R.search(WL, CONS, runtime=rr, **kw)
    pt = P.SearchRuntime(_p_policy())
    kw["engine"] = engine
    with inject(pt, [FaultSpec("launch", "nan", at=1)]) as inj:
        got = P.search(PW, PCONS, runtime=pt, device="cpu", **kw)
    _same(objective, ref, got, engine, COUNTERS)
    assert got.n_quarantined == 1 and got.n_retries == 0
    assert ("launch", "nan", 1) in inj.hits


@pytest.mark.parametrize("objective", ["edp", "pareto"])
def test_nan_in_a_kernel_output_is_quarantined(objective, monkeypatch):
    """The NaN guard of the DSE block reductions: a NaN block out of a
    kernel raises KernelNaN; under a runtime on the CPU the unit is
    re-evaluated on the host, and without one the search fails."""
    name = "dse_search_padded" if objective == "edp" else \
        "dse_pareto_padded"
    real = getattr(p_dse, name)

    def poisoned(*a, **kw):
        out = real(*a, **kw)
        return torch.full_like(out, float("nan"))

    grid = _grid(4)
    ref = R.search(WL, CONS, engine="numpy", grid=grid, objective=objective)
    monkeypatch.setattr(p_dse, name, poisoned)
    got = P.search(PW, PCONS, engine="cuda", grid=grid, objective=objective,
                   runtime=_p_policy(), device="cpu")
    _same(objective, ref, got, "kernel NaN")
    assert (got.n_quarantined, got.n_retries, got.n_fallbacks) == (1, 0, 0)
    with pytest.raises(p_dse.KernelNaN):
        P.search(PW, PCONS, engine="cuda", grid=grid, objective=objective,
                 device="cpu")


def test_launch_errors_retry_and_programming_errors_do_not():
    """A hand-written kernel's failed launch (KernelLaunchError) is
    transient; a bare RuntimeError is a programming error and propagates
    at once."""
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) == 1:
            p_dse._check(700, "dse_search_padded")
        return 1.0

    rt = P.SearchRuntime(_p_policy())
    assert rt.eval_unit("cuda", {"cuda": flaky}, "cpu") == 1.0
    assert rt.counters["n_retries"] == 1 and len(calls) == 2

    def broken():
        calls.append(1)
        raise RuntimeError("a bug")

    rt = P.SearchRuntime(_p_policy())
    with pytest.raises(RuntimeError, match="a bug"):
        rt.eval_unit("cuda", {"cuda": broken, "numpy": lambda: 0.0},
                     "cpu")
    assert rt.counters["n_retries"] == 0 and rt.counters["n_fallbacks"] == 0
    assert issubclass(p_dse.KernelLaunchError, RuntimeError)


def test_a_lost_device_ends_the_unit_on_numpy():
    """On the CPU the reference's chain holds: a unit whose cuda retries
    and torch fallback fail in turn is answered by numpy — two fallbacks,
    all counted."""
    def lost():
        raise p_dse.KernelLaunchError("illegal address")

    def oom():
        raise torch.cuda.OutOfMemoryError("out of memory")

    rt = P.SearchRuntime(_p_policy())
    out = rt.eval_unit("cuda", {"cuda": lost, "torch": oom,
                                "numpy": lambda: 7}, "cpu")
    assert out == 7
    assert rt.counters["n_fallbacks"] == 2 and rt.counters["n_retries"] == 6


@pytest.mark.parametrize("engine", ["cuda", "torch"])
def test_on_a_card_exhausted_retries_raise_and_nothing_falls_back(engine):
    """On a card no engine has a fallback: a unit that fails every retry
    raises LaunchExhausted, and no other engine is asked."""
    asked = []

    def lost():
        asked.append(engine)
        raise p_dse.KernelLaunchError("illegal address")

    def other(name):
        def run():
            asked.append(name)
            return 7
        return run

    thunks = {"cuda": other("cuda"), "torch": other("torch"),
              "numpy": other("numpy")}
    thunks[engine] = lost
    rt = P.SearchRuntime(_p_policy())
    with pytest.raises(P.LaunchExhausted) as err:
        rt.eval_unit(engine, thunks, torch.device("cuda", 0))
    assert isinstance(err.value.__cause__, p_dse.KernelLaunchError)
    assert asked == [engine] * 3
    assert (rt.counters["n_retries"], rt.counters["n_fallbacks"]) == (3, 0)


@pytest.mark.parametrize("poison", ["result", "kernel"])
def test_on_a_card_a_poisoned_unit_fails_the_query(poison):
    """On a card a NaN in a unit's result (or a kernel's NaN block) raises
    NanDetected instead of re-pricing the unit on the host."""
    def nan_result():
        return (3, float("nan"), 1)

    def nan_kernel():
        p_ops._check_finite(np.full((3, 2), np.nan), "search kernel")

    host = []
    rt = P.SearchRuntime(_p_policy())
    with pytest.raises(P.NanDetected, match="cuda"):
        rt.eval_unit("cuda", {"cuda": nan_result if poison == "result"
                              else nan_kernel,
                              "numpy": lambda: host.append(1)},
                     torch.device("cuda", 0))
    assert host == [] and rt.counters["n_quarantined"] == 0


def test_nan_scan_and_poisoning_take_torch_tensors():
    t = torch.zeros(3, dtype=torch.float32)
    assert not p_runtime._has_nan((t, torch.arange(3), {"a": 1.0}))
    bad = p_runtime._poisoned((t, torch.arange(3), 2.0))
    assert torch.isnan(bad[0]).all() and bad[2] != bad[2]
    assert torch.equal(bad[1], torch.arange(3))
    assert p_runtime._has_nan([np.zeros(2), {"x": bad[0]}])


# ---------------------------------------------------------------------------
# Kill / resume byte-identity
# ---------------------------------------------------------------------------

MATRIX = [(e, o) for e in ("cuda", "torch", "numpy")
          for o in ("edp", "pareto")]


@pytest.mark.parametrize("engine,objective", MATRIX)
def test_kill_at_every_boundary_resumes_byte_identically(engine, objective,
                                                         tmp_path):
    grid = _grid(4)
    kw = dict(grid=grid, objective=objective, chunk_size=200)
    ref = R.search(WL, CONS, engine="numpy", grid=grid, objective=objective)
    clean = P.search(PW, PCONS, engine=engine, device="cpu",
                     runtime=P.SearchRuntime(_p_policy(tmp_path / "c")),
                     **kw)
    _same(objective, ref, clean, "clean")
    n_units = clean.n_checkpoints
    assert n_units == -(-len(grid) // 200)
    for b in range(n_units):
        want, _ = _r_run(tmp_path / f"r{b}", [RSpec("checkpoint", "kill", b)],
                         engine="numpy", **kw)
        got, killed = _p_run(tmp_path / f"p{b}",
                             [FaultSpec("checkpoint", "kill", b)],
                             engine=engine, **kw)
        label = f"{engine}/{objective}/kill@ckpt{b}"
        assert killed, label
        _same(objective, want, got, label, COUNTERS)
        assert got.resumed_step == b + 1, label


@pytest.mark.parametrize("engine,objective", MATRIX[::3])
def test_kill_mid_unit_resumes_byte_identically(engine, objective, tmp_path):
    # A launch-site kill dies inside a unit, before its snapshot: the
    # resumed run re-executes that unit exactly once.
    kw = dict(grid=_grid(5), objective=objective, chunk_size=200)
    for at in (1, 2):
        want, _ = _r_run(tmp_path / f"r{at}", [RSpec("launch", "kill", at)],
                         engine="numpy", **kw)
        got, killed = _p_run(tmp_path / f"p{at}",
                             [FaultSpec("launch", "kill", at)],
                             engine=engine, **kw)
        assert killed
        _same(objective, want, got, f"{engine}/kill@launch{at}", COUNTERS)
        assert got.resumed_step == at


def test_checkpoint_every_n_bounds_replay(tmp_path):
    kw = dict(grid=_grid(6), chunk_size=100)
    r_pol = _r_policy(tmp_path / "r", checkpoint_every=2)
    p_pol = _p_policy(tmp_path / "p", checkpoint_every=2)
    results = []
    for pkg, pol, ins, spec, w, extra in (
            (R, r_pol, r_inject, RSpec, WL, {}),
            (P, p_pol, inject, FaultSpec, PW, {"device": "cpu"})):
        rt = pkg.SearchRuntime(pol)
        with ins(rt, [spec("checkpoint", "kill", at=0)]):
            with pytest.raises(pkg.KillSearch):
                pkg.search(w, pkg.Constraints(), engine="numpy", runtime=rt,
                           **kw, **extra)
        results.append(pkg.search(w, pkg.Constraints(), engine="numpy",
                                  runtime=pkg.SearchRuntime(pol), **kw,
                                  **extra))
    _same("edp", results[0], results[1], "every=2", COUNTERS)
    assert results[1].resumed_step == 2


@pytest.mark.parametrize("engine,objective", MATRIX)
def test_factorized_stream_kill_resume(engine, objective, tmp_path):
    kw = dict(space=AXES6, factorized=True, objective=objective,
              chunk_size=2000)
    clean = P.search(PW, PCONS, engine=engine, device="cpu",
                     runtime=P.SearchRuntime(_p_policy(tmp_path / "c")),
                     **_space_kw(kw, P))
    assert clean.n_checkpoints == 4
    for b in range(clean.n_checkpoints):
        want, _ = _r_run(tmp_path / f"r{b}", [RSpec("checkpoint", "kill", b)],
                         engine="numpy", **kw)
        got, killed = _p_run(tmp_path / f"p{b}",
                             [FaultSpec("checkpoint", "kill", b)],
                             engine=engine, **kw)
        assert killed, b
        _same(objective, want, got, f"fact/{engine}/{objective}/kill@{b}",
              COUNTERS)


@pytest.mark.parametrize("engine,objective", MATRIX)
def test_bnb_kill_resume_every_boundary(engine, objective, tmp_path):
    """The BnB drivers checkpoint the slab-queue cursor, the frozen refine
    incumbent/frontier and the prune counters: a kill at every snapshot —
    probe and sweep phases — reproduces the winner and every counter."""
    kw = dict(space=AXES12, factorized=True, prune="bound",
              objective=objective)
    ref = R.search(WL, CONS, engine="numpy", **_space_kw(kw, R))
    clean = P.search(PW, PCONS, engine=engine, device="cpu",
                     runtime=P.SearchRuntime(_p_policy(tmp_path / "c")),
                     **_space_kw(kw, P))
    _same(objective, ref, clean, "bnb-clean", BNB)
    assert clean.n_checkpoints >= 2
    for b in range(clean.n_checkpoints):
        want, _ = _r_run(tmp_path / f"r{b}", [RSpec("checkpoint", "kill", b)],
                         engine="numpy", **kw)
        got, killed = _p_run(tmp_path / f"p{b}",
                             [FaultSpec("checkpoint", "kill", b)],
                             engine=engine, **kw)
        assert killed, b
        _same(objective, want, got, f"bnb/{engine}/{objective}/kill@{b}",
              COUNTERS + BNB)
        assert got.ledger is None


def test_bnb_kill_mid_unit_resumes(tmp_path):
    kw = dict(space=AXES12, factorized=True, prune="bound")
    want, _ = _r_run(tmp_path / "r", [RSpec("launch", "kill", 1)],
                     engine="numpy", **kw)
    got, killed = _p_run(tmp_path / "p", [FaultSpec("launch", "kill", 1)],
                         engine="cuda", **kw)
    assert killed
    _same("edp", want, got, "bnb-midunit", COUNTERS + BNB)


@pytest.mark.parametrize("seed", [3, 17, 41, 99, 256, 1234])
def test_seeded_schedule_resumes_to_the_reference(seed, tmp_path):
    grid = _grid(7, size=500)
    specs = kill_schedule(seed, n_boundaries=3, n_launches=4)
    from repro.testing import kill_schedule as r_kill_schedule
    r_specs = r_kill_schedule(seed, n_boundaries=3, n_launches=4)
    assert [(s.site, s.kind, s.at) for s in specs] == \
        [(s.site, s.kind, s.at) for s in r_specs]
    kw = dict(engine="numpy", grid=grid, chunk_size=170)
    outcome = {}
    for tag, run, sp in (("r", _r_run, r_specs), ("p", _p_run, specs)):
        try:
            outcome[tag] = run(tmp_path / tag, sp, **kw)[0]
        except (R.LaunchExhausted, P.LaunchExhausted) as e:
            outcome[tag] = type(e).__name__
    if isinstance(outcome["r"], str):
        assert outcome["p"] == outcome["r"]
    else:
        _same("edp", outcome["r"], outcome["p"], seed, COUNTERS)


# ---------------------------------------------------------------------------
# Checkpoint safety and the checkpoint layer
# ---------------------------------------------------------------------------

def test_fingerprint_mismatch_refuses_foreign_checkpoints(tmp_path):
    grid_a, grid_b = _grid(8), _grid(9)
    _, killed = _p_run(tmp_path, [FaultSpec("checkpoint", "kill", 0)],
                       engine="numpy", grid=grid_a, chunk_size=200)
    assert killed
    with pytest.raises(P.CheckpointMismatch):
        P.search(PW, PCONS, engine="numpy", grid=grid_b, chunk_size=200,
                 runtime=P.SearchRuntime(_p_policy(tmp_path)), device="cpu")
    # so is every other knob of the signature
    with pytest.raises(P.CheckpointMismatch):
        P.search(PW, PCONS, engine="numpy", grid=grid_a, chunk_size=200,
                 runtime=P.SearchRuntime(_p_policy(tmp_path)), device="cpu",
                 hierarchical=True)


def test_counters_surface_without_checkpointing():
    rt = P.SearchRuntime(_p_policy())
    with inject(rt, [FaultSpec("launch", "raise", at=0)]):
        got = P.search(PW, PCONS, engine="numpy", grid=_grid(10),
                       chunk_size=300, runtime=rt, device="cpu")
    assert got.n_retries == 1
    assert got.n_checkpoints == 0 and got.resumed_step == 0


def test_fault_injector_counts_sites_independently():
    inj = FaultInjector([FaultSpec("launch", "nan", at=1)])
    assert inj.fire("launch") is False
    assert inj.fire("checkpoint") is False
    assert inj.fire("launch") is True
    assert inj.calls == {"launch": 2, "checkpoint": 1}
    assert inj.hits == [("launch", "nan", 1)]


def _tree():
    rng = np.random.default_rng(5)
    return {"best_row": np.arange(5, dtype=np.int64),
            "met_edp": rng.random(7),
            "nested": {"b": rng.integers(0, 9, size=(2, 3)),
                       "a": [np.float64(1) / 3, np.zeros((0, 5))]},
            "zz": np.asarray([np.inf, -1.5], np.float64)}


def _files(d):
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            out[os.path.relpath(p, d)] = open(p, "rb").read()
    return out


def test_checkpoint_files_are_the_references_byte_for_byte(tmp_path):
    """The same state saved by both packages gives the same files, and each
    package restores the other's snapshot exactly (float64 kept)."""
    extra = {"fingerprint": "f" * 64, "unit": 3, "counters": {"n": 1}}
    RManager(str(tmp_path / "r")).save(3, _tree(), extra=extra)
    PManager(str(tmp_path / "p")).save(3, _tree(), extra=extra)
    assert _files(tmp_path / "r") == _files(tmp_path / "p")
    target = {"best_row": 0, "met_edp": 0, "zz": 0,
              "nested": {"a": [0, 0], "b": 0}}
    for src, mgr in (("r", PManager), ("p", RManager)):
        tree, ex, step = mgr(str(tmp_path / src)).restore(target, host=True)
        assert step == 3 and ex == extra
        want = _tree()
        for k in ("best_row", "met_edp", "zz"):
            assert tree[k].dtype == want[k].dtype
            assert np.array_equal(tree[k], want[k])
        assert np.array_equal(tree["nested"]["b"], want["nested"]["b"])
        assert tree["nested"]["a"][0] == want["nested"]["a"][0]


def test_checkpoint_manager_copies_tensors_before_writing(tmp_path):
    mgr = PManager(str(tmp_path), keep_last=2)
    t = torch.arange(4, dtype=torch.float64)
    mgr.save(1, {"t": t, "h": torch.ones(2, dtype=torch.bfloat16)},
             blocking=False)
    t.zero_()  # the caller reuses its buffer at once
    mgr.wait()
    tree, _, _ = mgr.restore({"t": 0, "h": 0}, host=True)
    assert tree["t"].dtype == np.float64
    assert np.array_equal(tree["t"], np.arange(4.0))
    assert tree["h"].dtype == torch.bfloat16 and bool((tree["h"] == 1).all())
    back, _, _ = mgr.restore({"t": torch.zeros(1), "h": 0})
    assert back["t"].dtype == torch.float64
    for s in (2, 3):
        mgr.save(s, {"t": t})
    assert mgr.committed_steps() == [2, 3]


# ---------------------------------------------------------------------------
# search_workloads: per-workload runtimes
# ---------------------------------------------------------------------------

def test_search_workloads_runtime_kill_resume(tmp_path):
    names = ["deit-t", "deit-s"]
    grid = _grid(13, size=500)
    n_units = -(-len(grid) // 170)
    out = {}
    for pkg, pol, ins, spec, kw in (
            (R, _r_policy, r_inject, RSpec, {}),
            (P, _p_policy, inject, FaultSpec, {"device": "cpu"})):
        wls = [load(n) for n in names]
        if pkg is P:
            wls = from_reference(wls)
        d = tmp_path / pkg.__name__
        rt = pkg.SearchRuntime(pol(d))
        with ins(rt, [spec("checkpoint", "kill", at=n_units + 1)]):
            with pytest.raises(pkg.KillSearch):
                pkg.search_workloads(wls, pkg.Constraints(), engine="numpy",
                                     grid=grid, chunk_size=170, runtime=rt,
                                     **kw)
        assert sorted(os.listdir(d)) == sorted(w.name for w in wls)
        out[pkg] = pkg.search_workloads(
            wls, pkg.Constraints(), engine="numpy", grid=grid,
            chunk_size=170, runtime=pkg.SearchRuntime(pol(d)), **kw)
    first, second = (load(n).name for n in names)
    for n in (first, second):
        _same("edp", out[R][n], out[P][n], n, COUNTERS)
    assert out[P][first].resumed_step == n_units
    assert out[P][second].resumed_step == 2


@pytest.mark.parametrize("engine", ["cuda", "numpy"])
def test_search_workloads_runtime_counters_are_per_workload(engine):
    wls = from_reference([load(n) for n in ("deit-t", "deit-s")])
    rt = P.SearchRuntime(_p_policy())
    with inject(rt, [FaultSpec("launch", "raise", at=0)]):
        got = P.search_workloads(wls, PCONS, engine=engine,
                                 grid=_grid(14, size=400), chunk_size=200,
                                 runtime=rt, device="cpu")
    assert got[wls[0].name].n_retries == 1
    assert got[wls[1].name].n_retries == 0
