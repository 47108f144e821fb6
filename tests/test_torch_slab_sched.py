"""The port's parallel slab scheduler against the reference's.

`repro_torch.parallel.slab_sched` (through `search(..., prune="bound",
workers=N)`) runs with `device="cpu"` — the cuda engine then launches its
kernels' plain PyTorch versions from the worker threads — beside
`repro.parallel.slab_sched` on its numpy engine (and one pallas run in
interpret mode). The contract, as the reference's own tests state it:

  * `deterministic=True` with any worker count is byte-identical to
    `workers=None` and to the reference's `workers=4` — winners, frontiers,
    the canonical counter set and the fault-free `SchedStats` — per engine
    and objective, the 12^5 golden workloads included;
  * `deterministic=False` (work stealing) keeps the winner and frontier and
    covers the space exactly;
  * a fault ("kill", "raise", "timeout") injected at every scheduler site
    leaves the answer unchanged, and a checkpointed run killed at a
    boundary resumes to it, across worker counts too;
  * a kernel failure inside a worker is not a worker fault: it reaches the
    runtime's unit guard, as in the sequential driver;
  * the kernel layer is safe for concurrent workers: launch counts are
    exact, and concurrent builds write distinct temporary files.

Faults come from the deterministic injector (`repro_torch.testing.faults`)
with the policy's injectable `sleep`; no test waits on `DEFAULT_LEASE_S` or
on a wall clock. Tolerance: exact everywhere.
"""
import dataclasses
import json
import os
import pathlib
import stat
import sys
import threading

import numpy as np
import pytest

import repro.core as R
import repro.serve as RS
from repro.core.paper_workloads import load
from repro.parallel.slab_sched import canonical_counters as r_canonical
from repro.testing import FaultSpec as RSpec
from repro.testing import inject as r_inject
import repro_torch.core as P
from repro_torch.interop import from_reference
from repro_torch.kernels import _build
from repro_torch.kernels import dse_eval as p_dse
from repro_torch.kernels import ops as p_ops
from repro_torch.parallel import (CANONICAL_COUNTER_KEYS, DEFAULT_LEASE_S,
                                  canonical_counters)
from repro_torch.serve import SearchService
from repro_torch.testing import FaultSpec, inject

AXES = ((1, 2, 3, 4, 5), (1, 2, 3, 4), (2, 4, 6), (1, 3, 5, 7), (4, 8, 12))
SPACE = P.FactorizedSpace(AXES)
R_SPACE = R.FactorizedSpace(AXES)
WL = load("deit-t")
PW = from_reference(WL)
CONS = P.Constraints()
R_CONS = R.Constraints()
ENGINES = ("numpy", "torch", "cuda")
GOLDEN = pathlib.Path(__file__).parent / "golden" / "dse_12x5.json"
SITES = ("lease", "heartbeat", "merge", "report")


def _policy(tmpdir=None, **kw):
    kw.setdefault("sleep", lambda s: None)
    return P.RuntimePolicy(checkpoint_dir=str(tmpdir) if tmpdir else None,
                           **kw)


def _run(workers=None, deterministic=True, objective="edp", engine="numpy",
         rt=None, cons=CONS, space=SPACE, wl=PW):
    return P.search(wl, cons, engine=engine, factorized=True, prune="bound",
                    space=space, objective=objective, workers=workers,
                    deterministic=deterministic, runtime=rt, device="cpu")


def _r_run(workers=None, deterministic=True, objective="edp",
           engine="numpy", rt=None, cons=R_CONS, space=R_SPACE, wl=WL):
    return R.search(wl, cons, engine=engine, factorized=True, prune="bound",
                    space=space, objective=objective, workers=workers,
                    deterministic=deterministic, runtime=rt)


def _assert_same(objective, ref, got, label):
    if objective == "edp":
        want = None if ref.best_cfg is None else tuple(ref.best_cfg.as_array())
        have = None if got.best_cfg is None else tuple(got.best_cfg.as_array())
        assert have == want, label
        for f in ("area_mm2", "power_w", "energy_j", "latency_s", "edp"):
            a, b = getattr(ref, f), getattr(got, f)
            assert a == b or (np.isnan(a) and np.isnan(b)), (label, f)
    else:
        assert np.array_equal(np.asarray(got.front), np.asarray(ref.front)), \
            label
        assert set(got.metrics) == set(ref.metrics), label
        for k in ref.metrics:
            assert np.array_equal(got.metrics[k], ref.metrics[k]), (label, k)


def _assert_covered(res, space=SPACE):
    assert res.n_pruned + res.n_workload_evals == space.size
    assert res.n_evaluated == space.size


# ---------------------------------------------------------------------------
# Deterministic byte identity: workers=None, workers=1/4, the reference's
# ---------------------------------------------------------------------------

def test_canonical_counter_keys_are_the_references():
    from repro.parallel import slab_sched as r_sched
    assert CANONICAL_COUNTER_KEYS == r_sched.CANONICAL_COUNTER_KEYS
    assert DEFAULT_LEASE_S == r_sched.DEFAULT_LEASE_S


@pytest.mark.parametrize("objective", ["edp", "pareto"])
@pytest.mark.parametrize("engine", ENGINES)
def test_deterministic_byte_identity(engine, objective):
    ref_seq = _r_run(objective=objective)
    ref_w4 = _r_run(workers=4, objective=objective)
    seq = _run(objective=objective, engine=engine)
    w1 = _run(workers=1, objective=objective, engine=engine)
    w4 = _run(workers=4, objective=objective, engine=engine)
    assert seq.sched is None and ref_seq.sched is None
    for got, label in ((seq, "seq"), (w1, "w1"), (w4, "w4")):
        _assert_same(objective, ref_seq, got, f"{engine}/{label}")
        assert canonical_counters(got) == r_canonical(ref_seq) == \
            r_canonical(ref_w4), (engine, label)
        _assert_covered(got)
    assert w4.sched.workers == 4
    assert w4.sched.deterministic and w4.sched.n_merges > 0
    # without faults the wave schedule is fixed: every SchedStats field
    # equals the reference's
    assert dataclasses.asdict(w4.sched) == dataclasses.asdict(ref_w4.sched)
    assert "sched" not in repr(w4) and w4 == dataclasses.replace(w4,
                                                                 sched=None)


def test_deterministic_matches_the_references_pallas_run():
    """One reference pallas run (interpret mode) with workers=4: the port's
    cuda engine with workers=4 returns its bytes and counters."""
    ref = _r_run(workers=4, engine="pallas")
    got = _run(workers=4, engine="cuda")
    _assert_same("edp", ref, got, "pallas")
    assert canonical_counters(got) == r_canonical(ref)


@pytest.mark.parametrize("objective", ["edp", "pareto"])
@pytest.mark.parametrize("engine", ENGINES)
def test_deterministic_full_12x5_matches_golden(engine, objective):
    """All five golden workloads on the 12^5 space: workers=4 equals the
    committed record, workers=None and the reference's workers=4."""
    golden = json.loads(GOLDEN.read_text())["workloads"]
    for name, committed in golden.items():
        wl = load(name)
        pw = from_reference(wl)
        ref = R.search(wl, R_CONS, engine="numpy", factorized=True,
                       prune="bound", objective=objective, workers=4)
        seq = P.search(pw, CONS, engine=engine, factorized=True,
                       prune="bound", objective=objective, device="cpu")
        par = P.search(pw, CONS, engine=engine, factorized=True,
                       prune="bound", objective=objective, device="cpu",
                       workers=4)
        if objective == "edp":
            assert [int(x) for x in par.best_cfg.as_array()] == \
                committed["best"], name
            assert float(par.edp) == committed["edp"], name
        else:
            assert par.front.tolist() == committed["front"], name
        for got in (seq, par):
            _assert_same(objective, ref, got, (engine, name))
        assert canonical_counters(par) == canonical_counters(seq) == \
            r_canonical(ref), (engine, name)


# ---------------------------------------------------------------------------
# Async mode: same winner/frontier, complete coverage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("objective", ["edp", "pareto"])
@pytest.mark.parametrize("engine", ENGINES)
def test_async_same_winner_and_coverage(engine, objective):
    ref = _r_run(workers=4, deterministic=False, objective=objective)
    got = _run(workers=4, deterministic=False, objective=objective,
               engine=engine)
    _assert_same(objective, ref, got, "async")
    _assert_covered(got)
    assert got.sched is not None and not got.sched.deterministic


def test_async_pareto_at_the_float32_edge_matches_the_references_pallas():
    # bert-b on 24^5, Pareto BnB, work stealing: the sequential pallas and
    # cuda engines return 165 rows here ((1, 1, 14, 12, 10) ties its
    # (n_h, n_v) swap in float32), the numpy engine 166. The reference's
    # own async pallas run returns 166 too, and the port's async cuda run
    # must equal it: frontier, metrics, coverage and the slab bounds. The
    # other canonical counters depend on the stealing order in this mode
    # (`repro/parallel/slab_sched.py:47-54`): three reference runs gave
    # 88080, 88080 and 87972 workload evaluations.
    wl = load("bert-b")
    ref = R.search(wl, R_CONS, engine="pallas", factorized=True,
                   space=R.FactorizedSpace.full(24), prune="bound",
                   objective="pareto", workers=4, deterministic=False)
    space = P.FactorizedSpace.full(24)
    got = P.search(from_reference(wl), CONS, engine="cuda", factorized=True,
                   space=space, prune="bound", objective="pareto", workers=4,
                   deterministic=False, device="cpu")
    _assert_same("pareto", ref, got, "async bert-b 24^5")
    assert len(got.front) == 166
    for res in (ref, got):
        _assert_covered(res, space)
    assert (got.n_evaluated, got.n_bounds) == (ref.n_evaluated, ref.n_bounds)


def test_workers_validation():
    with pytest.raises(ValueError, match="positive integer"):
        _run(workers=0)
    with pytest.raises(ValueError, match="prune='bound'"):
        P.search(PW, CONS, engine="numpy", factorized=True, space=SPACE,
                 workers=2, device="cpu")
    with pytest.raises(ValueError, match="prune='bound'"):
        P.search_workloads([PW], CONS, engine="numpy", workers=2,
                           device="cpu")
    # shard= (ROADMAP item 8) composes with workers=: the reference's bytes
    kw = dict(engine="numpy", factorized=True, prune="bound", workers=2,
              shard=2)
    ref = R.search(WL, R_CONS, space=R_SPACE, **kw)
    got = P.search(PW, CONS, space=SPACE, device="cpu", **kw)
    _assert_same("edp", ref, got, "shard=2 workers=2")
    assert canonical_counters(got) == r_canonical(ref)


# ---------------------------------------------------------------------------
# Fault matrix: every site x every kind, both modes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("deterministic", [True, False])
@pytest.mark.parametrize("kind", ["kill", "raise", "timeout"])
@pytest.mark.parametrize("site", SITES)
def test_fault_at_every_boundary(site, kind, deterministic):
    seq = _r_run()
    rt = P.SearchRuntime(_policy())
    with inject(rt, [FaultSpec(site, kind, at=0)]) as inj:
        got = _run(workers=4, deterministic=deterministic, rt=rt)
    assert (site, kind, 0) in inj.hits
    _assert_same("edp", seq, got, f"{site}/{kind}")
    _assert_covered(got)
    if deterministic:
        assert canonical_counters(got) == r_canonical(seq)
    s = got.sched
    if kind == "kill":
        assert s.n_deaths >= 1 and s.n_requeued >= 1
    elif kind == "timeout":
        # a simulated hang force-expires the lease; the slab is requeued
        # and redone while the original worker may still report
        assert s.n_requeued >= 1
    # the scheduler's faults never reach the runtime's unit guard
    assert (got.n_retries, got.n_fallbacks, got.n_quarantined) == (0, 0, 0)


@pytest.mark.parametrize("objective", ["edp", "pareto"])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("site", SITES)
def test_kill_at_every_boundary_every_engine(site, engine, objective):
    seq = _r_run(objective=objective)
    rt = P.SearchRuntime(_policy())
    with inject(rt, [FaultSpec(site, "kill", at=0)]) as inj:
        got = _run(workers=4, deterministic=False, objective=objective,
                   engine=engine, rt=rt)
    assert (site, "kill", 0) in inj.hits
    _assert_same(objective, seq, got, f"{site}/{engine}")
    _assert_covered(got)
    assert got.sched.n_deaths >= 1


def test_duplicate_completion_idempotent():
    # A simulated hang (timeout at the lease) force-expires the lease; the
    # slab is requeued and redone, and the original worker's completion
    # arrives against a gone lease. Whichever lands first is merged; the
    # other is dropped — merging twice must not double-count.
    seq = _r_run()
    rt = P.SearchRuntime(_policy())
    with inject(rt, [FaultSpec("lease", "timeout", at=0)]):
        got = _run(workers=4, rt=rt)
    _assert_same("edp", seq, got, "dup")
    assert canonical_counters(got) == r_canonical(seq)
    s = got.sched
    assert s.n_requeued >= 1 and (s.n_late + s.n_dup) >= 1


def test_all_workers_dead_falls_back_inline():
    # Kill every worker at its first lease: the pool dies faster than the
    # respawn budget; the coordinator drains the queue inline (the same
    # engine on the same device) and the answer is still byte-identical,
    # as in the reference under the same schedule.
    seq = _r_run()
    specs = [FaultSpec("lease", "kill", at=0, worker=w) for w in range(16)]
    rt = P.SearchRuntime(_policy())
    with inject(rt, specs):
        got = _run(workers=2, rt=rt, engine="cuda")
    r_rt = R.SearchRuntime(R.RuntimePolicy(sleep=lambda s: None))
    with r_inject(r_rt, [RSpec("lease", "kill", at=0, worker=w)
                         for w in range(16)]):
        ref = _r_run(workers=2, rt=r_rt)
    for res in (ref, got):
        _assert_same("edp", seq, res, "inline")
        assert canonical_counters(res) == r_canonical(seq)
    assert got.sched.n_deaths >= 2 and got.sched.n_inline >= 1
    assert got.sched.n_respawns == ref.sched.n_respawns == 2


# ---------------------------------------------------------------------------
# Kernel failures inside a worker go through the runtime, not the scheduler
# ---------------------------------------------------------------------------

def _fail_in_a_worker(monkeypatch, exc, times=1):
    """The first `times` host reductions of a kernel's output that run on
    a worker thread raise `exc` (a failed launch or a NaN block)."""
    real = p_ops._check_finite
    fired = []

    def check(out, what):
        if (threading.current_thread() is not threading.main_thread()
                and len(fired) < times):
            fired.append(what)
            raise exc(f"injected in a worker ({what})")
        return real(out, what)

    monkeypatch.setattr(p_ops, "_check_finite", check)
    return fired


@pytest.mark.parametrize("deterministic", [True, False])
def test_a_failed_launch_in_a_worker_is_retried_by_the_runtime(
        deterministic, monkeypatch):
    seq = _r_run()
    fired = _fail_in_a_worker(monkeypatch, p_dse.KernelLaunchError)
    got = _run(workers=4, deterministic=deterministic, engine="cuda",
               rt=P.SearchRuntime(_policy()))
    assert len(fired) == 1
    _assert_same("edp", seq, got, "retried")
    _assert_covered(got)
    assert (got.n_retries, got.n_fallbacks, got.n_quarantined) == (1, 0, 0)
    assert got.sched.n_deaths == 0 and got.sched.n_requeued == 0


@pytest.mark.parametrize("deterministic", [True, False])
def test_a_failed_launch_in_a_worker_fails_the_query_without_a_runtime(
        deterministic, monkeypatch):
    _fail_in_a_worker(monkeypatch, p_dse.KernelLaunchError)
    with pytest.raises(p_dse.KernelLaunchError, match="in a worker"):
        _run(workers=4, deterministic=deterministic, engine="cuda")


@pytest.mark.parametrize("deterministic", [True, False])
def test_a_nan_block_in_a_worker_is_quarantined_on_the_cpu(
        deterministic, monkeypatch):
    """On the CPU the reference's quarantine holds for a worker's NaN
    block; on a card the same unit raises NanDetected
    (`tests/test_torch_resilience.py` holds the runtime's card path)."""
    seq = _r_run(objective="pareto")
    _fail_in_a_worker(monkeypatch, p_dse.KernelNaN)
    got = _run(workers=4, deterministic=deterministic, engine="cuda",
               objective="pareto", rt=P.SearchRuntime(_policy()))
    _assert_same("pareto", seq, got, "quarantined")
    assert (got.n_retries, got.n_quarantined) == (0, 1)


@pytest.mark.parametrize("deterministic", [True, False])
def test_an_exhausted_unit_in_a_worker_fails_the_query(deterministic):
    """A launch that fails every retry on every engine exhausts its unit;
    the search raises LaunchExhausted instead of respawning workers or
    draining the queue inline."""
    rt = P.SearchRuntime(_policy())
    with inject(rt, [FaultSpec("launch", "raise", at=-1)]):
        with pytest.raises(P.LaunchExhausted):
            _run(workers=4, deterministic=deterministic, engine="cuda",
                 rt=rt)


# ---------------------------------------------------------------------------
# Zero-feasible spaces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("deterministic", [True, False])
@pytest.mark.parametrize("objective", ["edp", "pareto"])
def test_zero_feasible(objective, deterministic):
    cons = P.Constraints(area_mm2=1e-9)
    got = _run(workers=4, deterministic=deterministic, objective=objective,
               cons=cons)
    if objective == "edp":
        assert not got.feasible
    else:
        assert got.size == 0
    assert got.n_feasible == 0
    _assert_covered(got)


# ---------------------------------------------------------------------------
# Checkpoint kill + resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("deterministic", [True, False])
@pytest.mark.parametrize("boundary", [0, 1, 2])
def test_checkpoint_kill_resume(tmp_path, boundary, deterministic):
    seq = _r_run()
    pol = _policy(tmp_path, checkpoint_every=1)
    rt = P.SearchRuntime(pol)
    with inject(rt, [FaultSpec("checkpoint", "kill", at=boundary)]) as inj:
        try:
            got = _run(workers=4, deterministic=deterministic, rt=rt)
            fired = False
        except P.KillSearch:
            fired = True
    if fired:
        assert ("checkpoint", "kill", boundary) in inj.hits
        got = _run(workers=4, deterministic=deterministic,
                   rt=P.SearchRuntime(pol))
        assert got.resumed_step is not None and got.resumed_step > 0
    _assert_same("edp", seq, got, f"ckpt{boundary}")
    _assert_covered(got)


@pytest.mark.parametrize("deterministic", [True, False])
def test_resume_across_worker_counts(tmp_path, deterministic):
    # The snapshot fingerprint excludes the worker count: a search
    # checkpointed under workers=4 resumes under workers=2, and a
    # deterministic one under workers=None (the sequential driver).
    seq = _r_run()
    pol = _policy(tmp_path, checkpoint_every=1)
    rt = P.SearchRuntime(pol)
    at = 1 if not deterministic else 0  # the fixed schedule has two units
    with inject(rt, [FaultSpec("checkpoint", "kill", at=at)]):
        with pytest.raises(P.KillSearch):
            _run(workers=4, deterministic=deterministic, rt=rt)
    got = _run(workers=2 if not deterministic else None,
               deterministic=deterministic, rt=P.SearchRuntime(pol))
    assert got.resumed_step is not None and got.resumed_step > 0
    _assert_same("edp", seq, got, "cross-worker resume")
    _assert_covered(got)


def test_pareto_async_checkpoint_resume(tmp_path):
    seq = _r_run(objective="pareto")
    pol = _policy(tmp_path, checkpoint_every=1)
    rt = P.SearchRuntime(pol)
    with inject(rt, [FaultSpec("checkpoint", "kill", at=1)]):
        with pytest.raises(P.KillSearch):
            _run(workers=4, deterministic=False, objective="pareto", rt=rt)
    got = _run(workers=4, deterministic=False, objective="pareto",
               rt=P.SearchRuntime(pol))
    _assert_same("pareto", seq, got, "pareto resume")
    _assert_covered(got)


# ---------------------------------------------------------------------------
# search_workloads and the resident service
# ---------------------------------------------------------------------------

def test_search_workloads_forwards_workers():
    wls = {n: load(n) for n in ("deit-t", "deit-s")}
    pwls = {n: from_reference(w) for n, w in wls.items()}
    ref = R.search_workloads(wls, {n: R_CONS for n in wls}, engine="numpy",
                             factorized=True, prune="bound", space=R_SPACE,
                             workers=2)
    seq = P.search_workloads(pwls, {n: CONS for n in pwls}, engine="cuda",
                             factorized=True, prune="bound", space=SPACE,
                             device="cpu")
    par = P.search_workloads(pwls, {n: CONS for n in pwls}, engine="cuda",
                             factorized=True, prune="bound", space=SPACE,
                             device="cpu", workers=2)
    for n in wls:
        _assert_same("edp", ref[n], par[n], n)
        assert canonical_counters(par[n]) == canonical_counters(seq[n]) \
            == r_canonical(ref[n])
        assert par[n].sched.workers == 2


@pytest.mark.parametrize("deterministic", [True, False])
@pytest.mark.parametrize("objective", ["edp", "pareto"])
def test_service_with_workers_equals_the_single_executor_service(
        objective, deterministic):
    """SearchService(workers=4): cold queries (through the scheduler) and
    warm deltas (always the deterministic wave fan-out) equal a
    workers=None service, and the reference's workers=4 service, answer
    for answer and stat for stat."""
    boxes = (P.Constraints(), P.Constraints(power_w=4.5),
             P.Constraints(power_w=4.0, area_mm2=45.0))
    r_boxes = (R.Constraints(), R.Constraints(power_w=4.5),
               R.Constraints(power_w=4.0, area_mm2=45.0))
    kw = dict(space=SPACE, engine="cuda", device="cpu")
    one = SearchService(**kw)
    par = SearchService(workers=4, deterministic=deterministic, **kw)
    ref = RS.SearchService(space=R_SPACE, engine="numpy", workers=4,
                           deterministic=deterministic)
    counters = CANONICAL_COUNTER_KEYS if deterministic else ()
    for box, r_box in zip(boxes, r_boxes):
        want = one.query(PW, box, objective=objective)
        got = par.query(PW, box, objective=objective)
        theirs = ref.query(WL, r_box, objective=objective)
        for other in (want, theirs):
            _assert_same(objective, other, got, box)
            for k in counters:
                assert getattr(got, k) == getattr(other, k), (box, k)
    assert par.stats == one.stats == ref.stats
    assert par.stats["warm"] == 2


def test_launch_dse_with_workers(capsys):
    from repro_torch.launch import serve as launch
    launch.main(["dse", "--n-z", "4", "--device", "cpu", "--workers", "4",
                 "--scenario", "power_w=4.0", "--scenario", "power_w=4.0"])
    out = capsys.readouterr().out
    assert "served 3 queries: 1 cold, 1 warm, 1 memoized" in out


# ---------------------------------------------------------------------------
# The kernel layer under concurrent workers
# ---------------------------------------------------------------------------

def _run_threads(n, target, timeout=60.0):
    """Start `n` threads on `target`, join each with a timeout and check
    that all of them finished."""
    threads = [threading.Thread(target=target) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads)


class _SlowStore(dict):
    """A counts dict whose store is Python code: the interpreter may switch
    threads between an increment's read and its write, as it may on any
    build without a global lock."""

    def __setitem__(self, key, value):
        dict.__setitem__(self, key, value)


def test_launch_counts_are_exact_under_concurrent_workers():
    """More threads than cores, switching every microsecond: an unlocked
    read-modify-write loses increments here (it counts a quarter of them
    without `count_launch`'s lock)."""
    counts = _SlowStore(k=0)
    n_threads, n_each = 2 * (os.cpu_count() or 4), 5000
    barrier = threading.Barrier(n_threads)

    def work():
        barrier.wait()
        for _ in range(n_each):
            _build.count_launch(counts, "k")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _run_threads(n_threads, work)
    finally:
        sys.setswitchinterval(interval)
    assert counts["k"] == n_threads * n_each


def _stub_nvcc(tmp_path):
    """A CUDA_HOME whose bin/nvcc compiles nothing: it writes an empty
    file at its -o path."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    ': > "$2"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    return home


def test_concurrent_builds_write_distinct_temporary_files(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(_stub_nvcc(tmp_path)))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    jobs = []
    barrier = threading.Barrier(2)

    def start():
        barrier.wait()
        jobs.append(_build._start("dse_eval"))

    _run_threads(2, start)
    assert len(jobs) == 2 and all(j is not None for j in jobs)
    tmps = [j[2] for j in jobs]
    assert tmps[0] != tmps[1]
    assert all(j[3] == _build.library_path("dse_eval") for j in jobs)
    for _, proc, tmp, _, _ in jobs:
        proc.communicate()
        assert proc.returncode == 0 and tmp.exists()
        assert str(os.getpid()) in tmp.name


def test_concurrent_loads_build_and_load_once(monkeypatch):
    builds, loads = [], []

    def build_all(names):
        builds.append(names)
        threading.Event().wait(0.05)  # a build that takes a while
        return {n: 0.0 for n in names}

    class Lib:
        def __init__(self, path):
            loads.append(path)

        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "build_all", build_all)
    monkeypatch.setattr(_build.ctypes, "CDLL", Lib)
    got = []
    barrier = threading.Barrier(4)

    def load():
        barrier.wait()
        got.append(_build.load_library("lm_kernels"))

    _run_threads(4, load)
    assert builds == [("lm_kernels",)] and len(loads) == 1
    assert len(got) == 4 and all(lib is got[0] for lib in got)
