"""The port's scenario sweep against the reference's: grid expansion and
dedup, the extraction fingerprints, the decode-length and int32-ceiling
regressions, swept winners on every engine, the memo of repeated sweeps,
the report and the `scenarios` launcher.

`repro_torch.scenarios` runs with `device="cpu"` (the cuda engine then runs
its kernels' plain PyTorch versions) beside `repro.scenarios` on its numpy
engine (and one pallas sweep in interpret mode), over the same grids of
reduced zoo configs and a small uneven product space. Tolerance: exact —
scenario names and `scenario_key` strings, extracted workloads field for
field, winners and frontiers with every float64 metric, the sweeps' stats
deltas and `SweepReport.format()` text.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import repro.configs as RC
import repro.core as R
import repro.scenarios as RSC
import repro.serve as RS
import repro_torch.configs as PC
import repro_torch.core as P
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.extract import workload_for
from repro_torch.core.performance_model import gemm_cycles, workload_statics
from repro_torch.core.workload import Gemm, Workload
from repro_torch.scenarios import (Scenario, ScenarioGrid, dedup_scenarios,
                                   resolve_constraints, scenario_key,
                                   scenario_shape, sweep)
from repro_torch.serve import SearchService

AXES = ((1, 2, 3, 4, 5), (1, 2, 3, 4), (2, 4, 6), (1, 3, 5, 7), (4, 8, 12))
SPACE = P.FactorizedSpace(AXES)
R_SPACE = R.FactorizedSpace(AXES)
ENGINES = ("numpy", "torch", "cuda")
MODELS = ("qwen2.5-3b", "rwkv6-7b", "olmoe-1b-7b")
GRID_KW = dict(models=MODELS, kinds=("train", "prefill", "decode"),
               seq_lens=(128,), batches=(2,), new_tokens=(8, 16),
               reduce=True)
GRID = ScenarioGrid(**GRID_KW)
R_GRID = RSC.ScenarioGrid(**GRID_KW)


def _svc(engine="numpy", **kw):
    return SearchService(space=SPACE, engine=engine, device="cpu", **kw)


def _r_svc(engine="numpy"):
    return RS.SearchService(space=R_SPACE, engine=engine)


def _wl_fields(wl):
    return repr(dataclasses.asdict(wl))


def _same_answer(a, b, label=""):
    """One swept answer (SearchResult or ParetoResult) against another,
    winner or frontier and every float64 metric."""
    if hasattr(a, "front"):
        assert np.array_equal(np.asarray(a.front), np.asarray(b.front)), label
        for k in a.metrics:
            assert np.array_equal(a.metrics[k], b.metrics[k]), (label, k)
        return
    want = None if a.best_cfg is None else tuple(a.best_cfg.as_array())
    have = None if b.best_cfg is None else tuple(b.best_cfg.as_array())
    assert have == want, label
    for f in ("area_mm2", "power_w", "energy_j", "latency_s", "edp"):
        av, bv = getattr(a, f), getattr(b, f)
        assert av == bv or (np.isnan(av) and np.isnan(bv)), (label, f)


def _same_report(ref, got):
    assert [r.scenario.name for r in got.results] == \
        [r.scenario.name for r in ref.results]
    for a, b in zip(ref.results, got.results):
        assert _wl_fields(b.workload) == _wl_fields(a.workload)
        assert dataclasses.asdict(b.constraints) == \
            dataclasses.asdict(a.constraints)
        _same_answer(a.result, b.result, a.scenario.name)
    assert got.stats == ref.stats
    assert got.format() == ref.format()


# ---------------------------------------------------------------------------
# Grid expansion: dedup, collision-free names, canonical shapes.
# ---------------------------------------------------------------------------

def test_grid_expands_collision_free():
    scs = GRID.expand()
    # 3 models x (train + prefill + 2 decode lengths) = 12 distinct cells.
    assert len(scs) == 12
    assert len({sc.name for sc in scs}) == 12
    assert len({sc.key() for sc in scs}) == 12
    wl_names = [sc.workload().name for sc in scs]
    assert len(set(wl_names)) == 12  # serve memo keys include the name
    ref = R_GRID.expand()
    assert [sc.name for sc in scs] == [sc.name for sc in ref]
    assert [sc.key() for sc in scs] == [sc.key() for sc in ref]
    assert [_wl_fields(sc.workload()) for sc in scs] == \
        [_wl_fields(sc.workload()) for sc in ref]


def test_grid_collapses_new_tokens_for_non_decode():
    # new_tokens is a decode-only knob: a prefill-only grid must not
    # multiply by the decode-length axis.
    kw = dict(models=("qwen2.5-3b",), kinds=("prefill",), seq_lens=(128,),
              batches=(1,), new_tokens=(8, 16, 32), reduce=True)
    assert ScenarioGrid(**kw).size == RSC.ScenarioGrid(**kw).size == 1


def test_zoo_covers_every_arch():
    kw = dict(kinds=("decode",), seq_lens=(64,), batches=(1,), reduce=True)
    scs = ScenarioGrid.zoo(**kw).expand()
    ref = RSC.ScenarioGrid.zoo(**kw).expand()
    assert len(scs) == 10
    for sc, r in zip(scs, ref):  # every family extracts a searchable workload
        wl = sc.workload()
        assert wl.total_macs > 0 and wl.elec_ops > 0
        assert sc.key() == r.key() and _wl_fields(wl) == _wl_fields(
            r.workload())


def test_zoo_at_published_configs_keys_equal_the_references():
    """The full-width zoo grid of the card's sweep (40 scenarios): the
    same names, fingerprints and workloads as the reference's."""
    kw = dict(kinds=("train", "prefill", "decode"), seq_lens=(2048,),
              batches=(8,), new_tokens=(16, 64))
    scs = ScenarioGrid.zoo(**kw).expand()
    ref = RSC.ScenarioGrid.zoo(**kw).expand()
    assert len(scs) == len(ref) == 40
    assert [(sc.name, sc.key()) for sc in scs] == \
        [(sc.name, sc.key()) for sc in ref]
    assert [_wl_fields(sc.workload()) for sc in scs] == \
        [_wl_fields(sc.workload()) for sc in ref]


def test_grid_rejects_name_collision():
    a = PC.reduced(PC.get_config("qwen2.5-3b"))
    b = dataclasses.replace(a, d_ff=a.d_ff * 2)  # same name, different cfg
    with pytest.raises(ValueError, match="collision"):
        ScenarioGrid(models=(a, b), kinds=("prefill",),
                     seq_lens=(64,), batches=(1,)).expand()


def test_scenario_key_is_extraction_content():
    cfg = PC.reduced(PC.get_config("qwen2.5-3b"))
    r_cfg = RC.reduced(RC.get_config("qwen2.5-3b"))
    # The shape *name* never feeds extraction: respelled shapes share keys.
    s1 = ShapeConfig("a", 128, 2, "prefill")
    s2 = ShapeConfig("b", 128, 2, "prefill", new_tokens=99)  # ignored knob
    assert scenario_key(cfg, s1) == scenario_key(cfg, s2)
    # Decode lengths are distinct questions.
    d1 = scenario_shape("decode", 128, 2, 8)
    d2 = scenario_shape("decode", 128, 2, 16)
    assert scenario_key(cfg, d1) != scenario_key(cfg, d2)
    # The key string is the reference's (memo and checkpoint directories
    # depend on it).
    for shape in (s1, d1, d2):
        r_shape = RC.ShapeConfig(shape.name, shape.seq_len,
                                 shape.global_batch, shape.kind,
                                 shape.new_tokens)
        assert scenario_key(cfg, shape) == RSC.scenario_key(r_cfg, r_shape)


def test_scenario_shape_validates():
    with pytest.raises(ValueError, match="kind"):
        scenario_shape("serve", 128, 1)
    with pytest.raises(ValueError, match=">= 1"):
        scenario_shape("decode", 128, 0)
    assert dataclasses.asdict(scenario_shape("decode", 64, 2, 8)) == \
        dataclasses.asdict(RSC.scenario_shape("decode", 64, 2, 8))


def test_dedup_scenarios_preserves_order():
    cfg = PC.reduced(PC.get_config("rwkv6-7b"))
    a = Scenario(cfg, scenario_shape("prefill", 64, 1))
    b = Scenario(cfg, scenario_shape("decode", 64, 1, 8))
    assert dedup_scenarios([a, b, a]) == [a, b]


# ---------------------------------------------------------------------------
# Regressions: ShapeConfig.new_tokens threads through workload_for.
# ---------------------------------------------------------------------------

def test_decode_length_threads_through_workload_for():
    cfg = PC.reduced(PC.get_config("qwen2.5-3b"))
    # Decode MACs/elec scale linearly in new_tokens.
    wl8 = workload_for(cfg, ShapeConfig("s", 128, 2, "decode", new_tokens=8))
    wl32 = workload_for(cfg, ShapeConfig("s", 128, 2, "decode",
                                         new_tokens=32))
    assert wl8.total_macs * 4 == wl32.total_macs
    assert wl8.elec_ops * 4 == wl32.elec_ops
    assert wl8.name != wl32.name  # distinct questions, distinct memo keys


def test_assigned_shapes_keep_default_decode_length():
    for nm in ("decode_32k", "long_500k"):
        assert PC.SHAPES_BY_NAME[nm].new_tokens == 32
        assert dataclasses.asdict(PC.SHAPES_BY_NAME[nm]) == \
            dataclasses.asdict(RC.SHAPES_BY_NAME[nm])


# ---------------------------------------------------------------------------
# Regressions: int32 wrap past M = batch * seq >= 2**31.
# ---------------------------------------------------------------------------

def test_host_gemm_cycles_exact_past_int32():
    m = 2**31 + 1000          # int32 would wrap to a negative dim
    cyc = float(gemm_cycles(m, 64, 64, 2, 2, 8, 8, 8))
    assert cyc == math.ceil(m / 16) * math.ceil(64 / 8) * math.ceil(64 / 16)
    assert cyc == float(R.gemm_cycles(m, 64, 64, 2, 2, 8, 8, 8))


def test_device_baking_rejects_past_int32():
    wl = Workload(name="huge", gemms=(Gemm(2**31 + 1000, 64, 64, 1),),
                  elec_ops=1.0, weight_bytes=1.0, act_io_bytes=1.0,
                  max_act_bytes=1.0)
    with pytest.raises(ValueError, match="int32 cycle-count limit"):
        workload_statics(wl)
    # ... while the boundary itself is admitted.
    P.require_i32_dims(np.array([[P.I32_DIM_LIMIT, 64, 64, 1]]))
    assert P.I32_DIM_LIMIT == R.I32_DIM_LIMIT


@pytest.mark.parametrize("engine", ["torch", "cuda"])
def test_sweep_rejects_overscale_scenario_early_on_device_engines(engine):
    cfg = PC.reduced(PC.get_config("qwen2.5-3b"))
    sc = Scenario(cfg, scenario_shape("prefill", 2**22, 1024))  # M = 2**32
    svc = _svc(engine)
    with pytest.raises(ValueError, match="prefill4194304b1024") as err:
        sweep([sc], service=svc)
    assert f"{engine} engine" in str(err.value)
    assert svc.stats["queries"] == 0  # nothing was searched
    # The numpy service runs the same scenario on the exact int64 path.
    rep = sweep([sc], service=_svc("numpy"))
    assert len(rep.results) == 1


# ---------------------------------------------------------------------------
# Sweeps through the service: memo behavior, engine byte identity.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
def test_sweep_memoizes_repeated_scenarios(engine):
    svc = _svc(engine)
    first = sweep(GRID, service=svc)
    assert first.stats["cold"] == len(first.results) == 12
    assert first.stats["batched_calls"] >= 1
    again = sweep(GRID, service=svc)
    assert again.stats["memo_hits"] == 12
    assert again.stats["cold"] == 0
    for a, b in zip(first.results, again.results):
        assert a.result is b.result  # the identical memoized object
    r_svc = _r_svc()
    _same_report(RSC.sweep(R_GRID, service=r_svc), first)
    _same_report(RSC.sweep(R_GRID, service=r_svc), again)


@pytest.mark.parametrize("engine", ENGINES)
def test_sweep_winners_byte_identical_across_engines(engine):
    kw = dict(models=("qwen2.5-3b",), kinds=("train", "prefill", "decode"),
              seq_lens=(128,), batches=(2,), reduce=True)
    ref = RSC.sweep(RSC.ScenarioGrid(**kw), service=_r_svc())
    got = sweep(ScenarioGrid(**kw), service=_svc(engine))
    _same_report(ref, got)


def test_sweep_matches_the_references_pallas_sweep():
    """One reference sweep on its pallas engine (interpret mode): the
    port's cuda sweep returns the same winners."""
    kw = dict(models=("rwkv6-7b",), kinds=("prefill", "decode"),
              seq_lens=(64,), batches=(1,), reduce=True)
    ref = RSC.sweep(RSC.ScenarioGrid(**kw), service=_r_svc("pallas"))
    got = sweep(ScenarioGrid(**kw), service=_svc("cuda"))
    for a, b in zip(ref.results, got.results):
        _same_answer(a.result, b.result, a.scenario.name)
    assert got.format() == ref.format()


@pytest.mark.parametrize("engine", ENGINES)
def test_sweep_per_class_constraints(engine):
    tight = {"decode": P.Constraints(power_w=0.001)}  # kills decode only
    rep = sweep(GRID, tight, service=_svc(engine))
    for r in rep.results:
        if r.scenario.kind == "decode":
            assert r.result.best_cfg is None
            assert r.constraints.power_w == 0.001
        else:
            assert r.result.best_cfg is not None
    ref = RSC.sweep(R_GRID, {"decode": R.Constraints(power_w=0.001)},
                    service=_r_svc())
    _same_report(ref, rep)


def test_resolve_constraints_spellings():
    box = P.Constraints(power_w=4.0)
    assert resolve_constraints(box, "decode") is box
    per_kind = {"decode": box}
    assert resolve_constraints(per_kind, "decode") is box
    assert resolve_constraints(per_kind, "train") == P.Constraints()
    # A plain box mapping applies to every class (field names and kind
    # names are disjoint vocabularies).
    assert resolve_constraints({"power_w": 4.0}, "train") == box
    assert resolve_constraints({"decode": {"latency_ms": 2}}, "decode") == \
        P.Constraints(latency_ms=2)


def test_report_summary_ranks_params():
    rep = sweep(GRID, service=_svc("cuda"))
    classes = rep.by_class()
    assert set(classes) == {"train", "prefill", "decode"}
    means = rep.class_param_means()
    for kind in classes:
        assert set(means[kind]) == {"n_t", "n_c", "n_h", "n_v", "n_lambda"}
    shift = rep.param_shift()
    assert [p for p, _ in shift] != [] and all(v >= 0 for _, v in shift)
    assert sorted((v for _, v in shift), reverse=True) == [v for _, v
                                                          in shift]
    text = rep.format()
    assert "cross-class parameter shift" in text
    assert all(r.scenario.name in text for r in rep.results)
    ref = RSC.sweep(R_GRID, service=_r_svc())
    assert means == ref.class_param_means()
    assert shift == ref.param_shift()
    assert text == ref.format()


@pytest.mark.parametrize("engine", ENGINES)
def test_sweep_pareto_objective(engine):
    kw = dict(models=("rwkv6-7b",), kinds=("prefill", "decode"),
              seq_lens=(64,), batches=(1,), reduce=True)
    rep = sweep(ScenarioGrid(**kw), service=_svc(engine),
                objective="pareto")
    for r in rep.results:
        assert len(r.result.front) >= 1
    assert rep.param_shift()  # frontier rows feed the class means too
    ref = RSC.sweep(RSC.ScenarioGrid(**kw), service=_r_svc(),
                    objective="pareto")
    _same_report(ref, rep)


def test_stats_delta_is_span_local():
    svc = _svc()
    wl = Scenario(PC.reduced(PC.get_config("rwkv6-7b")),
                  scenario_shape("prefill", 64, 1)).workload()
    svc.query(wl)  # history before the measured span
    before = dict(svc.stats)
    svc.query(wl)
    delta = svc.stats_delta(before)
    assert delta["queries"] == 1 and delta["memo_hits"] == 1
    assert delta["cold"] == 0


def test_sweep_builds_a_service_on_the_card_unless_asked():
    kw = dict(models=("rwkv6-7b",), kinds=("decode",), seq_lens=(64,),
              batches=(1,), reduce=True)
    rep = sweep(ScenarioGrid(**kw), space=SPACE, device="cpu")
    ref = RSC.sweep(RSC.ScenarioGrid(**kw), space=R_SPACE, engine="numpy")
    _same_report(ref, rep)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sweep(ScenarioGrid(**kw), space=SPACE)


def _sweeps(text):
    """The launcher's output less the lines that carry a wall time or name
    the engine (the two packages print their own)."""
    return [ln for ln in text.splitlines()
            if not ln.startswith(("sweep ", "service:"))]


def test_launch_scenarios_subcommand(capsys):
    from repro.launch.serve import main as r_main
    from repro_torch.launch.serve import main
    args = ["scenarios", "--model", "qwen2.5-3b", "--model", "rwkv6-7b",
            "--model", "olmoe-1b-7b", "--reduced", "--n-z", "4",
            "--seq-len", "64", "--batch", "1", "--repeat", "2"]
    main(args + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "12 scenarios (12 cold" in out        # >=3 models x >=4 shapes
    assert "12 scenarios (0 cold, 0 warm, 12 memoized" in out
    assert "cross-class parameter shift" in out
    assert "cuda engine on cpu" in out
    r_main(args + ["--engine", "numpy"])
    assert _sweeps(out) == _sweeps(capsys.readouterr().out)


def test_launch_scenarios_defaults_on_the_cpu(capsys):
    """`scenarios --device cpu --reduced --n-z 6`: the defaults (3 models,
    all three kinds, seq 2048, batch 8, decode lengths 16 and 64, two
    sweeps) on the cuda engine's plain versions, equal the reference's."""
    from repro.launch.serve import main as r_main
    from repro_torch.launch.serve import main
    main(["scenarios", "--device", "cpu", "--reduced", "--n-z", "6"])
    out = capsys.readouterr().out
    assert "-> 12 scenarios" in out and "12 scenarios (12 cold" in out
    r_main(["scenarios", "--reduced", "--n-z", "6"])
    assert _sweeps(out) == _sweeps(capsys.readouterr().out)


def test_launch_scenarios_shard_equals_unsharded(capsys):
    """`scenarios --shard 2`: the same sweeps, winners and report as the
    unsharded launcher and the reference's `--shard 2`."""
    from repro.launch.serve import main as r_main
    from repro_torch.launch.serve import main
    args = ["scenarios", "--model", "qwen2.5-3b", "--model", "rwkv6-7b",
            "--reduced", "--n-z", "4", "--seq-len", "64", "--batch", "1",
            "--repeat", "1"]
    main(args + ["--device", "cpu"])
    base = capsys.readouterr().out
    main(args + ["--device", "cpu", "--shard", "2"])
    assert _sweeps(capsys.readouterr().out) == _sweeps(base)
    r_main(args + ["--engine", "numpy", "--shard", "2"])
    assert _sweeps(capsys.readouterr().out) == _sweeps(base)
