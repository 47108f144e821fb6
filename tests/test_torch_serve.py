"""The port's resident DSE service against the reference's: canonical memo
keys, warm constraint-delta byte-identity, batching, the slab ledger, the
service-owned checkpoints and the `dse` launcher.

`repro_torch.serve.SearchService` runs with `device="cpu"` (the cuda engine
then runs its kernels' plain PyTorch versions) beside `repro.serve`'s
service on its numpy engine, and a cold `search()` of each box is the
twin of every warm answer. Inputs: the paper workloads and constraint
boxes, a small uneven product space and the golden 12^5 space. Tolerance:
exact — winners, frontiers, every float64 metric, slab ledgers array for
array, and the services' `stats` counters.
"""
import dataclasses
import json
import os
import pathlib

import numpy as np
import pytest
import torch

import repro.core as R
import repro.serve as RS
from repro.core.paper_workloads import load
import repro_torch.core as P
import repro_torch.serve as PS
from repro_torch.core.factorized import LedgerRecorder, SlabLedger
from repro_torch.core.photonic_model import CONSTANTS
from repro_torch.core.runtime import (QueryTimeout, gc_checkpoints,
                                      query_checkpoint_dir, query_policy)
from repro_torch.core.search import WarmStart, _search_factorized_bnb
from repro_torch.interop import from_reference
from repro_torch.serve import (QueryBatcher, SearchService, ServeQuery,
                               box_constraints, box_contains, canonical_box,
                               query_key, workload_key)

AXES = ((1, 2, 3, 4, 5), (1, 2, 3, 4), (2, 4, 6), (1, 3, 5, 7), (4, 8, 12))
SPACE = P.FactorizedSpace(AXES)
R_SPACE = R.FactorizedSpace(AXES)
WL = load("deit-t")
PW = from_reference(WL)
ENGINES = ("numpy", "torch", "cuda")


def _svc(**kw):
    kw.setdefault("space", SPACE)
    kw.setdefault("engine", "numpy")
    return SearchService(device="cpu", **kw)


def _r_svc(**kw):
    kw.setdefault("space", R_SPACE)
    kw.setdefault("engine", "numpy")
    return RS.SearchService(**kw)


def _cold(pw, cons, objective="edp", engine="numpy", **kw):
    kw.setdefault("space", SPACE)
    return P.search(pw, cons, engine=engine, factorized=True, prune="bound",
                    objective=objective, device="cpu", **kw)


# The work counters of a warm answer differ from its cold twin's by design
# (it evaluates only the revived slabs); against the reference's service
# answering the same query they are equal too.
WORK = ("n_feasible", "n_workload_evals", "n_pruned", "n_bounds")


def _same_edp(a, b, label="", counters=()):
    want = None if a.best_cfg is None else tuple(a.best_cfg.as_array())
    have = None if b.best_cfg is None else tuple(b.best_cfg.as_array())
    assert have == want, label
    for f in ("area_mm2", "power_w", "energy_j", "latency_s", "edp"):
        av, bv = getattr(a, f), getattr(b, f)
        assert av == bv or (np.isnan(av) and np.isnan(bv)), (label, f)
    for f in counters:
        assert getattr(a, f) == getattr(b, f), (label, f)


def _same_pareto(a, b, label="", counters=()):
    assert np.array_equal(np.asarray(a.front), np.asarray(b.front)), label
    assert set(a.metrics) == set(b.metrics), label
    for k in a.metrics:
        assert np.array_equal(a.metrics[k], b.metrics[k]), (label, k)
    for f in counters:
        assert getattr(a, f) == getattr(b, f), (label, f)


def _cons(pkg, **kw):
    return pkg.Constraints(**kw)


# ---------------------------------------------------------------------------
# Canonical keys: the reference's, digest for digest
# ---------------------------------------------------------------------------

def test_canonical_box_spelling_invariance():
    a = canonical_box({"power_w": 4, "area_mm2": 45.0})
    b = canonical_box({"area_mm2": 45, "power_w": 4.0})
    c = canonical_box(P.Constraints(power_w=4.0, area_mm2=45.0))
    assert a == b == c == RS.canonical_box({"power_w": 4, "area_mm2": 45})
    assert canonical_box({}) == canonical_box(P.Constraints())
    with pytest.raises(ValueError, match="unknown constraint field"):
        canonical_box({"watts": 5.0})
    box = canonical_box({"power_w": 4.5})
    assert box_constraints(box) == P.Constraints(power_w=4.5)


def test_box_contains_is_elementwise_tightening():
    base = canonical_box({})
    assert box_contains(base, canonical_box({"power_w": 4.0}))
    assert box_contains(base, base)
    assert not box_contains(base, canonical_box({"power_w": 6.0}))
    assert not box_contains(
        canonical_box({"power_w": 4.0}),
        canonical_box({"power_w": 3.0, "area_mm2": 60.0}))


def test_keys_equal_the_references():
    """Workload and query keys are content digests; the port's equal the
    reference's for the same workload, box, space and objective."""
    for name in ("deit-t", "bert-l"):
        assert workload_key(from_reference(load(name))) == \
            RS.workload_key(load(name))
    wk = workload_key(PW)
    for box, obj, metrics in (({"power_w": 4}, "edp", None),
                              ({}, "pareto", ("area", "edp"))):
        assert query_key(wk, canonical_box(box), SPACE.axes, obj, metrics,
                         constants="c") == \
            RS.query_key(wk, RS.canonical_box(box), R_SPACE.axes, obj,
                         metrics, constants="c")
    assert workload_key(PW) != workload_key(dataclasses.replace(PW,
                                                                name="alias"))
    k1 = query_key(wk, canonical_box({"power_w": 4}), SPACE.axes, "edp",
                   None)
    assert k1 != query_key(wk, canonical_box({}), SPACE.axes, "edp", None)
    assert k1 != query_key(wk, canonical_box({"power_w": 4}),
                           P.FactorizedSpace.full(3).axes, "edp", None)


# ---------------------------------------------------------------------------
# Memo and warm deltas
# ---------------------------------------------------------------------------

def test_memo_hit_returns_identical_object():
    svc = _svc()
    r1 = svc.query(PW, P.Constraints())
    assert svc.query(PW, P.Constraints()) is r1
    assert svc.query(PW, {"latency_ms": 10, "power_w": 5, "area_mm2": 50,
                          "energy_mj": 50}) is r1
    assert svc.query(PW, P.Constraints(), objective="edp",
                     pareto_metrics=("area", "edp")) is r1
    assert svc.stats["cold"] == 1 and svc.stats["memo_hits"] == 3


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("objective", ("edp", "pareto"))
def test_warm_delta_matches_cold_twin(engine, objective):
    """Every warm answer equals a cold search of its box, and the port's
    service serves the same query sequence as the reference's (same
    answers, same stats)."""
    svc = _svc(engine=engine)
    ref_svc = _r_svc()
    base = svc.query(PW, P.Constraints(), objective=objective)
    r_base = ref_svc.query(WL, R.Constraints(), objective=objective)
    if objective == "edp":
        _same_edp(r_base, base, "base", WORK)
        boxes = [dict(power_w=4.5), dict(power_w=float(base.power_w)),
                 dict(latency_ms=1e-6)]
    else:
        _same_pareto(r_base, base, "base", WORK)
        boxes = [dict(power_w=4.5), dict(power_w=4.0, area_mm2=45.0),
                 dict(latency_ms=1e-6)]
    for box in boxes:
        before = dict(svc.stats)
        got = svc.query(PW, box, objective=objective)
        want = ref_svc.query(WL, box, objective=objective)
        assert svc.stats["warm"] == before["warm"] + 1, box
        twin = _cold(PW, _cons(P, **box), objective, engine)
        if objective == "edp":
            _same_edp(want, got, box, WORK)
            _same_edp(twin, got, box)
        else:
            _same_pareto(want, got, box, WORK)
            _same_pareto(twin, got, box)
    assert svc.stats == ref_svc.stats
    last = svc.query(PW, boxes[-1], objective=objective)
    assert (last.best_cfg is None) if objective == "edp" else last.size == 0


def test_warm_chain_loosened_and_incomparable_boxes():
    """Stats of a query sequence that chains deltas, loosens and crosses
    boxes equal the reference service's, step by step."""
    seq = [dict(), dict(power_w=4.5), dict(power_w=4.0),
           dict(power_w=4.6, area_mm2=48.0), dict(power_w=4.2),
           dict(power_w=5.0), dict(power_w=4.0, area_mm2=60.0),
           dict(power_w=4.1)]
    svc, ref = _svc(), _r_svc()
    for box in seq:
        got, want = svc.query(PW, box), ref.query(WL, box)
        _same_edp(want, got, box, WORK)
        assert svc.stats == ref.stats, box
    _same_edp(_cold(PW, P.Constraints(power_w=4.0)),
              svc.query(PW, P.Constraints(power_w=4.0)))


def test_golden_12x5_cold_batch_and_deltas():
    """The five paper workloads: one batched cold wave lands on the golden
    record, and every workload's tightened box answers warm, equal to its
    cold twin."""
    committed = json.loads(
        (pathlib.Path(__file__).parent / "golden" /
         "dse_12x5.json").read_text())["workloads"]
    svc = SearchService(n_z=12, engine="cuda", device="cpu")
    names = sorted(committed)
    for name in names:
        svc.submit(from_reference(load(name)), P.Constraints())
    for name, res in zip(names, svc.drain()):
        assert [int(x) for x in res.best_cfg.as_array()] == \
            committed[name]["best"], name
        assert float(res.edp) == committed[name]["edp"], name
    assert svc.stats["batched_calls"] == 1
    tight = P.Constraints(power_w=4.5)
    for name in names:
        pw = from_reference(load(name))
        got = svc.query(pw, tight)
        _same_edp(P.search(pw, tight, engine="numpy", factorized=True,
                           n_z=12, prune="bound", device="cpu"), got, name)
    assert svc.stats["warm"] == len(names)


# ---------------------------------------------------------------------------
# Batching
# ---------------------------------------------------------------------------

def test_drain_matches_sequential_queries_and_the_reference():
    asks = [("deit-t", {}), ("deit-s", dict(power_w=4.5)), ("deit-t", {}),
            ("deit-s", dict(power_w=4.0))]
    seq = _svc()
    want = [seq.query(from_reference(load(n)), box) for n, box in asks]
    bat, r_bat = _svc(), _r_svc()
    for n, box in asks:
        bat.submit(from_reference(load(n)), box)
        r_bat.submit(load(n), box)
    got, r_got = bat.drain(), r_bat.drain()
    for g, w, rg in zip(got, want, r_got):
        _same_edp(w, g)
        _same_edp(rg, g, "", WORK)
    assert bat.stats == r_bat.stats
    assert (bat.stats["cold"], bat.stats["memo_hits"],
            bat.stats["batched_calls"]) == (3, 1, 2)
    assert got[0] is got[2]


def test_batcher_groups_by_signature_and_name():
    qs = [ServeQuery(wl=from_reference(load("deit-t")),
                     constraints=P.Constraints()),
          ServeQuery(wl=from_reference(load("deit-s")),
                     constraints=P.Constraints()),
          ServeQuery(wl=from_reference(load("deit-t")),
                     constraints=P.Constraints(power_w=4.0)),
          ServeQuery(wl=from_reference(load("deit-b")),
                     constraints=P.Constraints(), objective="pareto",
                     pareto_metrics=("area", "edp"))]
    waves = QueryBatcher.group(qs)
    assert [len(w) for _, w in waves] == [2, 1, 1]
    assert [sig for sig, _ in waves] == [("edp", None), ("edp", None),
                                         ("pareto", ("area", "edp"))]


def test_deadline_timeout_surfaces_in_drain():
    wl2 = from_reference(load("deit-s"))
    svc = _svc()
    svc.submit(PW, P.Constraints(), deadline_s=0.0)
    svc.submit(wl2, P.Constraints())
    out = svc.drain()
    assert isinstance(out[0], QueryTimeout)
    assert out[0].query_name == PW.name
    assert SearchService.timed_out(out) == [PW.name]
    assert svc.stats["timeouts"] == 1
    _same_edp(_cold(wl2, P.Constraints()), out[1])
    _same_edp(_cold(PW, P.Constraints()), svc.query(PW, P.Constraints()))
    with pytest.raises(ValueError, match="deadline_s"):
        svc.submit(PW, P.Constraints(), deadline_s=-1.0)


# ---------------------------------------------------------------------------
# The slab ledger
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("objective", ("edp", "pareto"))
def test_ledger_equals_the_references(engine, objective, tmp_path):
    ref = R.search(WL, R.Constraints(), engine="numpy", factorized=True,
                   space=R_SPACE, prune="bound", objective=objective,
                   keep_ledger=True).ledger
    led = _cold(PW, P.Constraints(), objective, engine,
                keep_ledger=True).ledger
    assert isinstance(led, SlabLedger)
    assert led.axes == ref.axes == SPACE.axes
    assert np.array_equal(led.pruned, ref.pruned)
    assert np.array_equal(led.evaluated, ref.evaluated)
    assert set(led.bounds) == set(ref.bounds) == \
        set(LedgerRecorder.METRIC_KEYS)
    for k in ref.bounds:
        assert np.array_equal(led.bounds[k], ref.bounds[k]), k
    assert led.accounted() == SPACE.size
    assert led.nbytes() == ref.nbytes()
    path = tmp_path / "led.npz"
    led.save(str(path))
    back = SlabLedger.load(str(path))
    assert np.array_equal(back.pruned, led.pruned)
    for k in led.bounds:
        assert np.array_equal(back.bounds[k], led.bounds[k])


def test_keep_ledger_requires_bound_prune():
    with pytest.raises(ValueError, match="keep_ledger"):
        P.search(PW, P.Constraints(), engine="numpy", factorized=True,
                 space=SPACE, keep_ledger=True, device="cpu")
    with pytest.raises(ValueError, match="keep_ledger"):
        P.search_workloads({"deit-t": PW}, P.Constraints(), engine="numpy",
                           factorized=True, space=SPACE, keep_ledger=True,
                           device="cpu")


def test_ledger_recorder_rejects_partial_accounting():
    rec = LedgerRecorder()
    rec.prune(np.asarray([[(0, 1)] * 5], np.int64),
              {k: np.zeros(1) for k in LedgerRecorder.METRIC_KEYS})
    with pytest.raises(AssertionError, match="slab ledger accounts"):
        rec.build(SPACE)


def test_warm_excludes_runtime_and_ledger():
    warm = WarmStart(start=np.zeros((0, 5, 2), np.int64))
    dev = torch.device("cpu")
    with pytest.raises(ValueError, match="warm.*runtime"):
        _search_factorized_bnb(SPACE, PW, P.Constraints(), "numpy",
                               CONSTANTS, dev, None, None, rt=object(),
                               warm=warm)
    with pytest.raises(ValueError, match="warm.*ledger"):
        _search_factorized_bnb(SPACE, PW, P.Constraints(), "numpy",
                               CONSTANTS, dev, None, None, led=object(),
                               warm=warm)


# ---------------------------------------------------------------------------
# Service-owned checkpoints, eviction, GC
# ---------------------------------------------------------------------------

def test_query_checkpoint_dir_layout(tmp_path):
    root = str(tmp_path / "ckpt")
    d1 = query_checkpoint_dir(root, "a" * 64)
    assert d1.startswith(root) and ("a" * 24) in d1 and os.path.isdir(d1)
    d2 = query_checkpoint_dir(root, "b" * 64, create=False)
    assert not os.path.exists(d2)
    pol = query_policy(root, "a" * 64, checkpoint_every=2)
    assert pol.checkpoint_dir == d1 and pol.checkpoint_every == 2


@pytest.mark.parametrize("engine", ["cuda", "numpy"])
def test_service_checkpoint_root_resume(engine, tmp_path):
    root = str(tmp_path / "svc")
    r_root = str(tmp_path / "ref")
    ref = _cold(PW, P.Constraints())
    svc = _svc(engine=engine, checkpoint_root=root)
    r1 = svc.query(PW, P.Constraints())
    _same_edp(ref, r1)
    assert r1.n_checkpoints > 0 and len(os.listdir(root)) == 1
    # A restarted service resumes from the committed snapshots; a resumed
    # run carries no ledger, so the follow-up tighten goes cold.
    svc2 = _svc(engine=engine, checkpoint_root=root)
    r2 = svc2.query(PW, P.Constraints())
    _same_edp(ref, r2)
    assert r2.resumed_step > 0 and r2.ledger is None
    tight = P.Constraints(power_w=4.5)
    _same_edp(_cold(PW, tight), svc2.query(PW, tight))
    assert (svc2.stats["warm"], svc2.stats["cold"]) == (0, 2)
    # the reference's service counts the same session the same way
    _r_svc(checkpoint_root=r_root).query(WL, R.Constraints())
    r_svc2 = _r_svc(checkpoint_root=r_root)
    rr2 = r_svc2.query(WL, R.Constraints())
    r_svc2.query(WL, R.Constraints(power_w=4.5))
    assert svc2.stats == r_svc2.stats
    assert (rr2.resumed_step, rr2.n_checkpoints) == \
        (r2.resumed_step, r2.n_checkpoints)


def test_lru_and_byte_budget_eviction_match_the_reference():
    seq = [("deit-t", {}), ("deit-s", {}), ("deit-t", dict(power_w=4.5)),
           ("deit-b", {}), ("deit-t", dict(power_w=4.0)),
           ("deit-s", dict(power_w=4.0)), ("deit-t", dict(power_w=3.5))]
    for kw in (dict(max_bases=1), dict(max_bases=2),
               dict(max_ledger_bytes=1)):
        svc, ref = _svc(**kw), _r_svc(**kw)
        for n, box in seq:
            _same_edp(ref.query(load(n), box),
                      svc.query(from_reference(load(n)), box), (kw, n, box),
                      WORK)
            assert svc.stats == ref.stats, (kw, n, box)
    with pytest.raises(ValueError, match="max_ledger_bytes"):
        _svc(max_ledger_bytes=-1)


def test_gc_checkpoints_prunes_and_skips_foreign(tmp_path):
    root = str(tmp_path / "root")
    svc = _svc(checkpoint_root=root)
    svc.query(PW, P.Constraints())
    svc.query(PW, P.Constraints(power_w=4.0), objective="pareto")
    dirs = sorted(os.listdir(root))
    assert len(dirs) == 2
    os.makedirs(os.path.join(root, "not-ours"))
    open(os.path.join(root, "not-ours", "data.bin"), "w").close()
    os.makedirs(os.path.join(root, "a" * 24))
    open(os.path.join(root, "a" * 24, "user.txt"), "w").close()
    kept = gc_checkpoints(root, keep=1)
    assert len(kept) == 1 and kept[0].startswith(root)
    left = sorted(os.listdir(root))
    assert "not-ours" in left and "a" * 24 in left
    assert len([d for d in left if d in dirs]) == 1
    assert gc_checkpoints(root, keep=0,
                          known=[d for d in left if d in dirs]) == []
    with pytest.raises(ValueError):
        gc_checkpoints(root, keep=-1)
    assert gc_checkpoints(str(tmp_path / "missing"), keep=0) == []


# ---------------------------------------------------------------------------
# The card by default; what is not ported
# ---------------------------------------------------------------------------

def test_service_and_launcher_need_the_card_unless_told(monkeypatch, capsys):
    from repro_torch.launch import serve as launch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: SearchService(), lambda: SearchService(
            engine="numpy"), lambda: PS.SearchService(engine="torch")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.main(["dse", "--n-z", "4"])
    assert SearchService(n_z=4, device="cpu").engine == "cuda"
    launch.main(["dse", "--n-z", "6", "--device", "cpu", "--scenario",
                 "power_w=4.0", "--scenario", "power_w=4.0"])
    out = capsys.readouterr().out
    assert "cuda engine on cpu" in out
    assert "served 3 queries: 1 cold, 1 warm, 1 memoized" in out


def test_workers_and_unknown_engines_are_refused():
    # workers= is ported (ROADMAP Queue 1 item 13): a worker count below 1
    # is refused at the first cold search, as the reference's service
    # refuses it (tests/test_torch_slab_sched.py holds workers=N services).
    with pytest.raises(ValueError, match="positive integer"):
        _r_svc(workers=0).query(WL)
    with pytest.raises(ValueError, match="positive integer"):
        _svc(workers=0).query(PW)
    with pytest.raises(ValueError, match="torch"):
        _svc(engine="jax")
    from repro_torch.launch import serve as launch
    with pytest.raises(ValueError, match="positive integer"):
        launch.main(["dse", "--device", "cpu", "--n-z", "4", "--workers",
                     "0"])


# ---------------------------------------------------------------------------
# shard= (ROADMAP Queue 1 item 8): the service and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_sharded_service_equals_unsharded_and_the_reference(engine):
    """`SearchService(shard=2)` forwards shard= to every cold, warm and
    batched search: answers, work counters and `stats` equal a shard=None
    service's and the reference's shard=2 service's."""
    boxes = [P.Constraints(), P.Constraints(power_w=4.5)]
    r_boxes = [R.Constraints(), R.Constraints(power_w=4.5)]
    one, two = _svc(engine=engine), _svc(engine=engine, shard=2)
    ref = _r_svc(shard=2)
    for box, r_box in zip(boxes, r_boxes):
        for objective in ("edp", "pareto"):
            want = ref.query(WL, r_box, objective=objective)
            a = one.query(PW, box, objective=objective)
            b = two.query(PW, box, objective=objective)
            same = _same_edp if objective == "edp" else _same_pareto
            same(a, b, (engine, objective), WORK)
            same(want, b, (engine, objective), WORK)
    bert = load("bert-b")
    for svc, pkg, wls in ((one, P, (PW, from_reference(bert))),
                          (two, P, (PW, from_reference(bert))),
                          (ref, R, (WL, bert))):
        for wl in wls:
            svc.submit(wl, pkg.Constraints(power_w=5.0))
    drained = [svc.drain() for svc in (one, two, ref)]
    for a, b, want in zip(*drained):
        _same_edp(a, b, "drain", WORK)
        _same_edp(want, b, "drain", WORK)
    assert one.stats == two.stats == ref.stats
    assert two.shard == 2


def test_launch_dse_shard_equals_unsharded(capsys):
    from repro_torch.launch import serve as launch

    def printed(extra):
        launch.main(["dse", "--device", "cpu", "--n-z", "6", "--workload",
                     "all", "--scenario", "power_w=4.5"] + extra)
        return [ln.split("ms", 1)[-1] if "ms" in ln else ln
                for ln in capsys.readouterr().out.splitlines()]

    base = printed([])
    assert printed(["--shard", "4"]) == base
    assert "served 10 queries: 5 cold, 5 warm, 0 memoized" in base[-1]
    with pytest.raises(ValueError, match="shard"):
        printed(["--shard", "0"])
