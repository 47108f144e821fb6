"""The port's training substrate against the reference's on the CPU: the
data pipeline, the health monitor and recovery plan, checkpoints of
training state, the trainer's resume and preemption, and the interop of
parameters and optimizer state both ways. Ports of `tests/test_substrate.py`
(its pipeline, checkpoint, trainer-resume and health tests) and
`tests/test_elastic_restore.py` (on one device) sit beside the parity
checks; AdamW is `tests/test_torch_train_adamw.py`'s. Tolerance: exact
everywhere (batches, plans, round trips, checkpoint paths and restored
state).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as RM
from repro.checkpoint.checkpointing import CheckpointManager as RefManager
from repro.checkpoint.checkpointing import _tree_paths as ref_tree_paths
from repro.configs import get_config as ref_get_config
from repro.configs import list_archs
from repro.configs import reduced as ref_reduced
from repro.configs.base import ShapeConfig as RefShape
from repro.data.pipeline import SyntheticTokenSource as RefSource
from repro.optim import adamw as RA
from repro.train import fault_tolerance as RFT
import repro_torch.models as PM
from repro_torch.checkpoint.checkpointing import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import SyntheticTokenSource
from repro_torch.interop import (opt_state_from_reference,
                                 opt_state_to_reference,
                                 params_from_reference, params_to_reference,
                                 reference_leaf)
from repro_torch.optim import adamw
from repro_torch.train.fault_tolerance import (HealthConfig, HealthMonitor,
                                               recovery_plan)
from repro_torch.train.trainer import Trainer, TrainerConfig

CFG = reduced(get_config("qwen2.5-3b"))
SHAPE = ShapeConfig("tiny", seq_len=16, global_batch=4, kind="train")
FAMILY_ARCHS = ("qwen2.5-3b", "llava-next-34b", "olmoe-1b-7b",
                "deepseek-v3-671b", "zamba2-7b", "rwkv6-7b",
                "seamless-m4t-medium")


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ref_params(arch, seed=0):
    rcfg = ref_reduced(ref_get_config(arch))
    key = jax.random.key(seed)
    params = jax.jit(RM.init_params, static_argnums=1).lower(
        key, rcfg).compile({"xla_backend_optimization_level": 0})(key)
    return rcfg, reduced(get_config(arch)), params


def _leaf(tree, name, cfg):
    path, index = reference_leaf(name, cfg)
    for key in path:
        tree = tree[key]
    return _f32(tree)[index]


# ---------------------------------------------------------------------------
# Data pipeline (port of test_substrate.py:54-64, then parity)
# ---------------------------------------------------------------------------

def test_pipeline_deterministic_by_step():
    src1 = SyntheticTokenSource(CFG, SHAPE, seed=7)
    src2 = SyntheticTokenSource(CFG, SHAPE, seed=7)
    np.testing.assert_array_equal(src1.batch_at(5)["tokens"],
                                  src2.batch_at(5)["tokens"])
    assert not np.array_equal(src1.batch_at(5)["tokens"],
                              src1.batch_at(6)["tokens"])
    assert src1.batch_at(0)["tokens"].shape == (4, 16)
    assert src1.batch_at(0)["tokens"].max() < CFG.vocab


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_batch_at_matches_reference(arch):
    ref = RefSource(ref_reduced(ref_get_config(arch)),
                    RefShape("tiny", 32, 4, "train"), seed=11)
    got = SyntheticTokenSource(reduced(get_config(arch)),
                               ShapeConfig("tiny", 32, 4, "train"), seed=11)
    for step in (0, 3, 1000):
        a, b = ref.batch_at(step), got.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), \
                (arch, step, k)
    it = iter(got)
    next(it)
    assert got.state_dict() == {"step": 1, "seed": 11}
    got.load_state_dict({"step": 9, "seed": 11})
    assert np.array_equal(next(iter(got))["tokens"],
                          ref.batch_at(9)["tokens"])


# ---------------------------------------------------------------------------
# Health monitor and recovery plan (test_substrate.py:111-129)
# ---------------------------------------------------------------------------

def test_health_monitor_stragglers_and_spikes():
    hm = HealthMonitor(HealthConfig(straggler_grace=2.0,
                                    straggler_patience=3))
    for i in range(10):
        hm.report("w0", 1.0, now=float(i))
        hm.report("w1", 1.0 if i < 5 else 5.0, now=float(i))
    assert hm.stragglers() == ["w1"]
    assert hm.check_step(1.0) and hm.check_step(1.1)
    assert not hm.check_step(float("nan"))
    assert not hm.check_step(1e6)
    assert hm.dead_workers(now=100.0) == ["w0", "w1"]
    assert hm.dead_workers(now=9.5) == []


def test_recovery_plan_shrinks_data_axes_only():
    plan = recovery_plan(256, {"pod": 2, "data": 16, "model": 16})
    assert plan["model"] == 16
    assert plan["pod"] * plan["data"] * plan["model"] <= 256
    with pytest.raises(RuntimeError):
        recovery_plan(8, {"data": 1, "model": 16})


@pytest.mark.parametrize("n,mesh", [
    (256, {"pod": 2, "data": 16, "model": 16}),
    (300, {"pod": 2, "data": 16, "model": 16}),
    (17, {"data": 8, "model": 2}),
    (512, {"pod": 2, "data": 16, "model": 16}),
])
def test_recovery_plan_matches_reference(n, mesh):
    assert recovery_plan(n, mesh) == RFT.recovery_plan(n, mesh)


# ---------------------------------------------------------------------------
# Checkpoints (test_substrate.py:65-110, test_elastic_restore.py)
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_integrity(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    tree = {"a": torch.arange(6).reshape(2, 3).float(),
            "n": {"b": torch.ones((4,), dtype=torch.bfloat16)}}
    mgr.save(3, tree, extra={"pipeline": {"step": 3, "seed": 0}})
    restored, extra, step = mgr.restore(tree)
    assert step == 3 and extra["pipeline"]["step"] == 3
    assert torch.equal(restored["a"], tree["a"])
    assert restored["n"]["b"].dtype == torch.bfloat16
    arr_file = tmp_path / "step_000003" / "arrays" / "0.npy"
    data = bytearray(arr_file.read_bytes())
    data[-1] ^= 0xFF
    arr_file.write_bytes(bytes(data))
    with pytest.raises(IOError):
        mgr.restore(tree)


def test_checkpoint_gc_keeps_last(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    tree = {"a": torch.zeros((2,))}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.committed_steps() == [3, 4]


def test_optimizer_state_paths_are_the_references(tmp_path):
    # A namedtuple's leaves go under ".field" keys in field order, as JAX
    # names them; plain tuples and lists keep their indices.
    ref_tree = {"params": {"a": jnp.ones((2, 2)), "b": (jnp.zeros(1),
                                                        [jnp.ones(2)])},
                "opt": RA.init(RA.AdamWConfig(), {"a": jnp.ones((2, 2))})}
    port_tree = {"params": {"a": torch.ones((2, 2)),
                            "b": (torch.zeros(1), [torch.ones(2)])},
                 "opt": adamw.init(adamw.AdamWConfig(),
                                   {"a": torch.ones((2, 2))})}
    want = ref_tree_paths(ref_tree)[0]
    assert want == ["opt/.step", "opt/.mu/a", "opt/.nu/a", "params/a",
                    "params/b/0", "params/b/1/0"]
    mgr = CheckpointManager(str(tmp_path / "port"))
    mgr.save(1, port_tree)
    import json
    with open(tmp_path / "port" / "step_000001" / "manifest.json") as fh:
        assert [leaf["path"] for leaf in json.load(fh)["leaves"]] == want
    back, _, _ = mgr.restore(port_tree)
    assert isinstance(back["opt"], adamw.OptState)
    assert isinstance(back["params"]["b"], tuple)
    assert isinstance(back["params"]["b"][1], list)
    # and each package restores the other's optimizer state
    got, _, _ = RefManager(str(tmp_path / "port")).restore(ref_tree)
    assert int(got["opt"].step) == 0
    RefManager(str(tmp_path / "ref")).save(2, ref_tree)
    back, _, step = CheckpointManager(str(tmp_path / "ref")).restore(
        port_tree)
    assert step == 2 and torch.equal(back["opt"].mu["a"],
                                     torch.zeros((2, 2)))


def test_restore_onto_another_device_layout(tmp_path):
    # test_elastic_restore.py on one device: a checkpoint of a model's
    # reference layout restores whole, whatever device the new run uses,
    # and fills the model bit for bit.
    cfg = reduced(get_config("granite-3-2b"))
    model = PM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mgr = CheckpointManager(str(tmp_path))
    tree = {"params": params_to_reference(model, cfg, numpy=False)}
    mgr.save(7, tree)
    restored, _, step = mgr.restore(tree)
    assert step == 7
    fresh = params_from_reference(restored["params"], cfg, "cpu")
    for (n, a), (_, b) in zip(model.named_parameters(),
                              fresh.named_parameters()):
        assert torch.equal(a, b), n


def test_recovery_plan_then_restore_shape_math():
    plan = recovery_plan(300, {"pod": 2, "data": 16, "model": 16})
    assert plan["model"] == 16
    assert plan["pod"] * plan["data"] * plan["model"] <= 300
    # whole logical arrays on disk: any mesh's model axis divides them as
    # before (the vocab shards over model=16 at the published width)
    assert get_config("granite-3-2b").vocab % 1 == 0
    assert plan == RFT.recovery_plan(300, {"pod": 2, "data": 16,
                                           "model": 16})


def test_trainer_resume_after_simulated_failure(tmp_path):
    tcfg = TrainerConfig(total_steps=6, ckpt_every=2,
                         ckpt_dir=str(tmp_path), log_every=100)
    t1 = Trainer(CFG, SHAPE, tcfg=tcfg, device="cpu")
    r1 = t1.run(num_steps=4)        # "crash" after step 4 (checkpointed)
    assert r1["final_step"] == 4
    t2 = Trainer(CFG, SHAPE, tcfg=tcfg, device="cpu")
    assert t2.start_step == 4
    assert t2.data.state.step == 4  # pipeline state restored: no skipped data
    for (n, a), (_, b) in zip(t1.state["params"].named_parameters(),
                              t2.state["params"].named_parameters()):
        assert torch.equal(a, b), n
    for n in t1.state["opt"].mu:
        assert torch.equal(t1.state["opt"].mu[n], t2.state["opt"].mu[n])
        assert torch.equal(t1.state["opt"].nu[n], t2.state["opt"].nu[n])
    assert int(t2.state["opt"].step) == 4
    r2 = t2.run(num_steps=2)
    assert r2["final_step"] == 6
    assert all(np.isfinite(r2["losses"]))
    assert np.mean(r2["losses"]) < np.mean(r1["losses"][:2]) + 0.05
    assert sorted(os.listdir(tmp_path)) == [
        "step_000002", "step_000002.COMMITTED", "step_000004",
        "step_000004.COMMITTED", "step_000006", "step_000006.COMMITTED"]


def test_trainer_preemption_takes_a_checkpoint(tmp_path):
    tcfg = TrainerConfig(total_steps=6, ckpt_every=100,
                         ckpt_dir=str(tmp_path))
    t = Trainer(CFG, SHAPE, tcfg=tcfg, device="cpu")
    real = t._train_step

    def step_then_signal(*a):
        out = real(*a)
        t._preempted = True      # what the SIGTERM handler sets
        return out
    t._train_step = step_then_signal
    out = t.run()
    assert out["final_step"] == 1
    assert CheckpointManager(str(tmp_path)).committed_steps() == [1]


# ---------------------------------------------------------------------------
# Interop of training state: reference -> port -> reference, bit for bit
# ---------------------------------------------------------------------------

def _bits(x):
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.fixture(scope="module")
def ref_params():
    """Per arch, built on first use: `_ref_params(arch)`."""
    built = {}

    def get(arch):
        if arch not in built:
            built[arch] = _ref_params(arch)
        return built[arch]
    return get


@pytest.mark.parametrize("arch", list_archs())
def test_params_round_trip_bit_exact(ref_params, arch):
    rcfg, pcfg, params = ref_params(arch)
    ref = jax.tree.map(np.asarray, params)
    model = params_from_reference(ref, pcfg, "cpu")
    back = params_to_reference(model, pcfg)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(ref),
                                 jax.tree.leaves(back)):
        w = _bits(want)
        assert got.dtype == w.dtype and got.shape == w.shape, path
        assert np.array_equal(got, w), path
    # and the uint16 bits come back in as bf16
    again = params_from_reference(back, pcfg, "cpu")
    for (n, a), (_, b) in zip(model.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list_archs())
def test_opt_state_round_trip_bit_exact(ref_params, arch, moments):
    rcfg, pcfg, params = ref_params(arch)
    rng = np.random.default_rng(5)
    cfg = RA.AdamWConfig(moment_dtype=jnp.dtype(moments))
    state = RA.init(cfg, params)
    state = RA.OptState(jnp.int32(17), *(jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype), t)
        for t in (state.mu, state.nu)))
    ref = jax.tree.map(np.asarray, state)
    model = params_from_reference(jax.tree.map(np.asarray, params), pcfg,
                                  "cpu")
    port = opt_state_from_reference(ref, model, pcfg)
    assert int(port.step) == 17 and port.step.dtype == torch.int32
    assert all(t.dtype == getattr(torch, moments)
               for t in port.mu.values())
    back = opt_state_to_reference(port, pcfg)
    assert int(back.step) == 17 and back.step.dtype == np.int32
    for what in ("mu", "nu"):
        want_t, got_t = getattr(ref, what), getattr(back, what)
        assert jax.tree.structure(got_t) == jax.tree.structure(want_t)
        for want, got in zip(jax.tree.leaves(want_t), jax.tree.leaves(got_t)):
            assert np.array_equal(got, _bits(want))
