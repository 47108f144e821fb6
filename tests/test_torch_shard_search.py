"""`shard=` on the port's materialized-grid search, against the reference.

The port of `tests/test_sharded_search.py`: `repro_torch.search(...,
shard=, chunk_size=)` on `device="cpu"` must return the reference's bytes
for every engine (`python`, `numpy`, `torch`, and `cuda` through its
kernels' plain versions) and both objectives, under any fan-out and
chunking — the uneven last chunk, chunks with no feasible point, duplicate
rows meeting across chunks — and so must the batched `search_workloads`.
On the CPU the cuda and torch engines' candidate mesh has one device (the
reference's CPU host has one too), so they run the sharded layout on one
shard; the python and numpy engines split each chunk `shard` ways on the
host at any device count. The reference runs in the same process: its
numpy engine one-shot for each file-level grid (shared by a module
fixture), its own engine where that is as cheap (python, numpy).
Tolerance: exact — winners, every float64 metric, frontier rows and every
counter (`n_evaluated`, `n_feasible`, `n_workload_evals`, `n_overflow`).
"""
import importlib

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core.paper_workloads import PAPER_WORKLOADS, load
import repro_torch.core as P
from repro_torch.interop import from_reference
from repro_torch.launch.mesh import make_candidate_mesh, shard_mesh
from repro_torch.serve import SearchService

ENGINES = ("python", "numpy", "torch", "cuda")
SHARDS = (None, 1, 2, 4)
NAMES = sorted(PAPER_WORKLOADS)


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


def _sample_grid(seed, size=3000):
    rng = np.random.default_rng(seed)
    return np.unique(rng.integers(1, 13, size=(size, 5)), axis=0)


def _pair(name):
    return load(name), from_reference(load(name))


def _same(objective, ref, got, label):
    for f in ("n_evaluated", "n_feasible", "n_workload_evals"):
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
    assert got.objectives == ref.objectives, label
    for k in R.REPORT_METRICS:
        assert np.array_equal(got.metrics[k], ref.metrics[k]), (label, k)


def _p(pw, engine, **kw):
    return P.search(pw, P.Constraints(), engine=engine, device="cpu", **kw)


# ---------------------------------------------------------------------------
# The differential matrix: engine x objective x shard x chunk_size
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def matrix_refs():
    """The reference's one-shot numpy results on the matrix grids, both
    objectives (the python grid is smaller, as the reference's test keeps
    its oracle affordable)."""
    wl = load("deit-t")
    out = {}
    for size in (900, 2500):
        grid = _sample_grid(size, size=size)
        for objective in ("edp", "pareto"):
            out[size, objective] = grid, R.search(
                wl, R.Constraints(), engine="numpy", grid=grid,
                objective=objective)
    return out


@pytest.mark.parametrize("objective", ["edp", "pareto"])
@pytest.mark.parametrize("engine", ENGINES)
def test_streamed_sharded_matches_reference(engine, objective, matrix_refs):
    grid, ref = matrix_refs[900 if engine == "python" else 2500, objective]
    pw = from_reference(load("deit-t"))
    one = _p(pw, engine, grid=grid, objective=objective)
    _same(objective, ref, one, f"{engine}/{objective}/one-shot")
    for shard in SHARDS:
        for cs in (None, 97, 256, len(grid)):
            if shard is None and cs is None:
                continue
            got = _p(pw, engine, grid=grid, objective=objective,
                     shard=shard, chunk_size=cs)
            label = f"{engine}/{objective}/shard={shard}/chunk={cs}"
            _same(objective, ref, got, label)
            if objective == "pareto":
                assert got.n_overflow == one.n_overflow, label


@pytest.mark.parametrize("objective", ["edp", "pareto"])
@pytest.mark.parametrize("engine", ["numpy", "torch", "cuda"])
def test_streamed_sharded_hierarchical_matches_reference(engine, objective):
    wl, pw = _pair("bert-l")
    grid = _sample_grid(11, size=2000)
    ref = R.search(wl, R.Constraints(), engine="numpy", grid=grid,
                   objective=objective, hierarchical=True)
    for shard, cs in ((4, None), (None, 311), (2, 1024), (4, len(grid))):
        got = _p(pw, engine, grid=grid, objective=objective,
                 hierarchical=True, shard=shard, chunk_size=cs)
        _same(objective, ref, got,
              f"{engine}/{objective}/hier/shard={shard}/chunk={cs}")


@pytest.mark.parametrize("objective", ["edp", "pareto"])
@pytest.mark.parametrize("engine", ENGINES)
def test_chunk_with_zero_feasible_points(engine, objective):
    # The first chunk is 128 copies of the all-max config, infeasible under
    # the default box: "nothing yet" rides across a fully infeasible chunk
    # (and, at shard=2, across two infeasible shards).
    wl, pw = _pair("deit-t")
    dead = np.full((128, 5), 12, dtype=np.int64)
    assert not _p(pw, "numpy", grid=dead).feasible
    grid = np.concatenate([dead, _sample_grid(5, size=900)], axis=0)
    ref = R.search(wl, R.Constraints(), engine="numpy", grid=grid,
                   objective=objective)
    for cs in (128, 64, len(grid)):
        got = _p(pw, engine, grid=grid, objective=objective, chunk_size=cs,
                 shard=2)
        _same(objective, ref, got, f"{engine}/{objective}/dead/{cs}")


@pytest.mark.parametrize("objective", ["edp", "pareto"])
@pytest.mark.parametrize("engine", ENGINES)
def test_zero_feasible_everywhere_streamed(engine, objective):
    wl, pw = _pair("deit-t")
    grid = _sample_grid(7, size=500)
    kw = dict(area_mm2=1.0, power_w=0.01, energy_mj=1e-9, latency_ms=1e-9)
    ref = R.search(wl, R.Constraints(**kw), engine=engine
                   if engine in ("python", "numpy") else "numpy", grid=grid,
                   objective=objective, shard=2, chunk_size=101)
    got = P.search(pw, P.Constraints(**kw), engine=engine, grid=grid,
                   objective=objective, shard=2, chunk_size=101,
                   device="cpu")
    _same(objective, ref, got, f"{engine}/{objective}/impossible")
    assert not got.feasible and got.n_feasible == 0
    assert got.n_evaluated == len(grid)
    if objective == "pareto":
        assert got.front.shape == (0, 5)


@pytest.mark.parametrize("objective", ["edp", "pareto"])
def test_duplicate_rows_across_chunks_and_shards(objective):
    # Every row twice, in different chunks (chunk_size == the base grid's
    # length) or different shards (shard=2 over the doubled grid): tied
    # frontier points meet only through the cross-chunk/shard merge.
    wl, pw = _pair("deit-s")
    base = _sample_grid(23, size=700)
    doubled = np.concatenate([base, base], axis=0)
    ref = R.search(wl, R.Constraints(), engine="numpy", grid=doubled,
                   objective=objective)
    for engine in ("numpy", "torch", "cuda"):
        for kw in (dict(chunk_size=len(base)), dict(shard=2),
                   dict(shard=4, chunk_size=len(base))):
            got = _p(pw, engine, grid=doubled, objective=objective, **kw)
            _same(objective, ref, got, f"{engine}/{objective}/dup/{kw}")
            if objective == "pareto":
                _, counts = np.unique(got.front, axis=0, return_counts=True)
                assert (counts == 2).all()


@pytest.mark.parametrize("objective", ["edp", "pareto"])
@pytest.mark.parametrize("engine", ENGINES)
def test_search_workloads_sharded_matches_reference(engine, objective):
    wls = {n: load(n) for n in NAMES}
    pwls = {n: from_reference(w) for n, w in wls.items()}
    grid = _sample_grid(3, size=500 if engine == "python" else 1200)
    cs = 499 if engine == "cuda" else 193
    ref = R.search_workloads(wls, R.Constraints(), engine="numpy", grid=grid,
                             objective=objective)
    got = P.search_workloads(pwls, P.Constraints(), engine=engine, grid=grid,
                             objective=objective, shard=4, chunk_size=cs,
                             device="cpu")
    for name in wls:
        _same(objective, ref[name], got[name],
              f"batch/{engine}/{objective}/{name}")


def test_search_workloads_sharded_per_workload_constraints():
    wls = {n: load(n) for n in ("deit-t", "bert-l")}
    pwls = {n: from_reference(w) for n, w in wls.items()}
    cons = {"deit-t": R.Constraints(),
            "bert-l": R.Constraints(area_mm2=1.0, power_w=0.01)}
    pcons = {"deit-t": P.Constraints(),
             "bert-l": P.Constraints(area_mm2=1.0, power_w=0.01)}
    grid = _sample_grid(5, size=1200)
    ref = R.search_workloads(wls, cons, engine="numpy", grid=grid,
                             hierarchical=True, shard=2, chunk_size=601)
    got = P.search_workloads(pwls, pcons, engine="cuda", grid=grid,
                             hierarchical=True, shard=2, chunk_size=601,
                             device="cpu")
    _same("edp", ref["deit-t"], got["deit-t"], "deit-t")
    # n_workload_evals: the batched cuda launch counts the union of the
    # workloads' area/power survivors, the numpy loop each workload's own
    assert not got["bert-l"].feasible and not ref["bert-l"].feasible


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_shard_clamps_to_available_devices(engine):
    # More shards than devices clamp, not crash — and stay identical.
    wl, pw = _pair("deit-t")
    grid = _sample_grid(13, size=600)
    ref = R.search(wl, R.Constraints(), engine="jax", grid=grid, shard=16)
    for shard in (None, 16):
        _same("edp", ref, _p(pw, engine, grid=grid, shard=shard),
              f"{engine}/shard={shard}")
    assert make_candidate_mesh(16, "cpu") == (torch.device("cpu"),)
    assert shard_mesh(1, "cpu") is None and shard_mesh(None, "cpu") is None


def test_stream_arg_validation():
    wl, pw = _pair("deit-t")
    for pkg, w, kw in ((R, wl, {}), (P, pw, {"device": "cpu"})):
        with pytest.raises(ValueError, match="shard"):
            pkg.search(w, shard=0, **kw)
        with pytest.raises(ValueError, match="chunk_size"):
            pkg.search(w, chunk_size=0, **kw)
        with pytest.raises(ValueError, match="chunk_size"):
            pkg.search_workloads({"w": w}, chunk_size=-3, **kw)
    with pytest.raises(ValueError, match="shard"):
        P.search_workloads({"w": pw}, shard=-1, device="cpu")
    # the service refuses it at its first search, as the reference's does
    with pytest.raises(ValueError, match="shard"):
        SearchService(n_z=4, device="cpu", shard=0).query(pw)


# ---------------------------------------------------------------------------
# The host split and the running argmin it feeds
# ---------------------------------------------------------------------------

def test_host_split_is_the_references():
    r_search = importlib.import_module("repro.core.search")
    p_search = importlib.import_module("repro_torch.core.search")
    for n in (0, 1, 3, 7, 100):
        chunk = np.arange(n)
        for shard in (None, 1, 2, 3, 4, 16):
            want = r_search._host_shards(chunk, shard)
            got = p_search._host_shards(chunk, shard)
            assert [list(a) for a in got] == [list(a) for a in want]
            assert p_search._span_parts(5, n, shard) == \
                r_search._span_parts(5, n, shard)
