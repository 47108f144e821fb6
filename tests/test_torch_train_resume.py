"""Each package resumes the other's training checkpoint (CPU).

The reference's `Trainer` (reduced qwen2.5-3b, seq 16, batch 4) runs 4
steps with `ckpt_every=2`; the port's `Trainer` (`device="cpu"`) resumes at
step 4 from a copy of that directory and runs 2 more steps, beside the
reference's own 2 more steps from the original. Then the same the other
way round: the port trains 4 steps, the reference resumes. Either resume
starts from the other package's parameters, AdamW moments, step and data
pipeline position, so the two continuations see the same state and the
same batches.

Tolerances: the losses within LOSS_ATOL = 0.06 (the forward's,
`tests/test_torch_families.py`; measured <= 1.2e-4). The parameters after
the two steps: each leaf within P_TOL = 2^-8 of its largest magnitude (one
bf16 ulp there or less: an element whose update crosses a bf16 rounding
lands an ulp away; measured <= 6.7e-4, the embedding) plus STEP_TOL, two
learning rates a step (2 x (lr_5 + lr_6) = 6.6e-5): the packages'
gradients differ by up to 2^-5 of a leaf (`tests/test_torch_train_grads.py`),
and where a gradient is noise — the key bias, to which the softmax is
nearly blind — AdamW's normalized step (magnitude about 1) may take either
sign, so two steps part by up to 2 lr each (measured 3.0e-5, 0.45 of
STEP_TOL, on `layers/attn/bk`). The checkpoints' manifests have the same
leaf paths, shapes and dtypes in both packages.
"""
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.configs.base import ShapeConfig as RefShape
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.interop import reference_leaf
from repro_torch.optim.adamw import schedule
from repro_torch.train.trainer import Trainer, TrainerConfig

LOSS_ATOL = 0.06
P_TOL = 2.0 ** -8
ARCH = "qwen2.5-3b"


def _ref_trainer(d):
    return RefTrainer(ref_reduced(ref_get_config(ARCH)),
                      RefShape("tiny", 16, 4, "train"),
                      tcfg=RefTrainerConfig(total_steps=6, ckpt_every=2,
                                            ckpt_dir=str(d)))


def _port_trainer(d):
    return Trainer(reduced(get_config(ARCH)), ShapeConfig("tiny", 16, 4,
                                                          "train"),
                   tcfg=TrainerConfig(total_steps=6, ckpt_every=2,
                                      ckpt_dir=str(d)), device="cpu")


def _manifest(d, step):
    with open(d / f"step_{step:06d}" / "manifest.json") as fh:
        m = json.load(fh)
    return [(leaf["path"], leaf["shape"], leaf["dtype"])
            for leaf in m["leaves"]], m["extra"]


def _check_continuations(ref, port):
    """Both resumed at step 4 and ran 2 more steps: losses and params."""
    assert ref.start_step == port.start_step == 4
    assert ref.data.state.step == port.data.state.step == 6
    cfg = port.cfg
    params = ref.state["params"]
    lr = [float(schedule(port.opt_cfg, torch.tensor(s, dtype=torch.int32)))
          for s in (5, 6)]
    step_tol = 2 * sum(lr)
    for name, p in port.state["params"].named_parameters():
        path, index = reference_leaf(name, cfg)
        want = params
        for key in path:
            want = want[key]
        want = np.asarray(jnp.asarray(want, jnp.float32))[index]
        got = p.detach().float().numpy()
        assert np.abs(got - want).max() <= \
            P_TOL * np.abs(want).max() + step_tol, name
    assert int(port.state["opt"].step) == int(ref.state["opt"].step) == 6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both directions, each package's 4 first steps checkpointed."""
    base = tmp_path_factory.mktemp("resume")
    out = {}
    r_dir, p_dir = base / "ref", base / "port"
    out["ref_first"] = _ref_trainer(r_dir).run(num_steps=4)
    out["port_first"] = _port_trainer(p_dir).run(num_steps=4)
    for src, name in ((r_dir, "ref"), (p_dir, "port")):
        shutil.copytree(src, base / f"{name}_copy")
    out["dirs"] = (r_dir, p_dir, base / "ref_copy", base / "port_copy")
    return out


def test_port_resumes_the_references_checkpoint(runs):
    r_dir, _, r_copy, _ = runs["dirs"]
    ref = _ref_trainer(r_dir)
    port = _port_trainer(r_copy)
    want, got = ref.run(num_steps=2), port.run(num_steps=2)
    assert got["final_step"] == want["final_step"] == 6
    assert all(np.isfinite(got["losses"]))
    for a, b in zip(got["losses"], want["losses"]):
        assert abs(a - b) <= LOSS_ATOL, (a, b)
    _check_continuations(ref, port)


def test_reference_resumes_the_ports_checkpoint(runs):
    _, p_dir, _, p_copy = runs["dirs"]
    port = _port_trainer(p_dir)
    ref = _ref_trainer(p_copy)
    got, want = port.run(num_steps=2), ref.run(num_steps=2)
    assert want["final_step"] == got["final_step"] == 6
    assert all(np.isfinite(want["losses"]))
    for a, b in zip(got["losses"], want["losses"]):
        assert abs(a - b) <= LOSS_ATOL, (a, b)
    _check_continuations(ref, port)


def test_checkpoints_have_the_same_layout(runs):
    r_dir, p_dir, _, _ = runs["dirs"]
    for step in (2, 4):
        (ref_leaves, ref_extra), (port_leaves, port_extra) = (
            _manifest(r_dir, step), _manifest(p_dir, step))
        assert port_leaves == ref_leaves
        assert port_extra == ref_extra == {
            "pipeline": {"step": step, "seed": 0},
            "arch": reduced(get_config(ARCH)).name}
    paths = [p for p, _, _ in ref_leaves]
    assert paths[0] == "opt/.step" and "opt/.mu/embed/table" in paths
    assert len(paths) == 1 + 3 * len(jax.tree.leaves(
        _ref_trainer(r_dir).state["params"]))
