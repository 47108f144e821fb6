"""Gradients of the port's `lm_loss` against `jax.value_and_grad` of
`repro.models.lm_loss` on the CPU: the dense, vlm and moe families here
(qwen2.5-3b, llava-next-34b, gemma3-4b for the sliding window and tied
embeddings, olmoe-1b-7b), the others in
`tests/test_torch_train_grads_families.py`, which shares this file's
helpers.

The reference's random parameters carry across bit for bit
(`interop.params_from_reference`); the batch is the data pipeline's
(`SyntheticTokenSource`, Zipf token ids, seq 16, batch 2), the same numpy
arrays on both sides. The reference runs jitted with exec-safe products
and compiled with `xla_allow_excess_precision` off (`STRICT`, as in
`tests/test_torch_families.py`), with its default `remat=True`; the port
runs `lm_loss(...).backward()` with `device="cpu"`, also with `remat=True`.
Each port gradient is held against the reference leaf that
`interop.reference_leaf` names (a parameter the loss does not reach, the
aux-free route bias, has no port gradient and a zero reference one).

Tolerances, from a measurement of these eight archs at this batch:
  * the reference against itself: its STRICT-jitted gradients and its
    op-by-op ones (`jax.disable_jit()`) differ by up to 0.021 of a leaf's
    largest magnitude (qwen2.5-3b's `layers/attn/bk`; 0.018 deepseek-v3,
    0.010 zamba2, <= 0.006 elsewhere), with a cosine over all leaves of at
    least 0.99996;
  * the port against the STRICT reference: up to 0.024 (zamba2-7b's
    `mamba_groups/m/a_log`, 0.023 its `conv_w`; 0.019 deepseek-v3, <= 0.017
    the others) and a cosine of at least 0.99993 (zamba2-7b), except
    rwkv6-7b, 0.057 (`layers/time/w_lora_b`, `w_base` 0.054), cosine
    0.99995. rwkv6-7b's forward logits already differ by 0.019 at this
    batch (within the forward's LOGIT_ATOL 0.03), and the WKV recurrence's
    backward pass carries that through every step.
The sources are the forward's (bf16 roundings that land on the other side
after f32 sums in another order; `tests/test_torch_families.py`) and the
backward's own bf16 sums: the embedding gradient is a scatter-add of the
rows of repeated Zipf ids into a bf16 table, a tied table (gemma3-4b) or
a shared block (zamba2-7b's `shared_attn`, applied twice) adds its
contributions in bf16, and a broadcast bias's gradient is a bf16 sum over
the batch; each runs in another order in XLA and in PyTorch. So:
  * LOSS_ATOL = 0.06, the forward's loss tolerance
    (`tests/test_torch_families.py`; measured <= 4.2e-4, rwkv6-7b);
  * GRAD_TOL = 2^-5 = 0.03125 of each leaf's largest magnitude (1.3x the
    largest measurement outside rwkv6-7b), 2^-4 for rwkv6-7b (1.1x its
    0.057);
  * COS_MIN = 0.9999 over all leaves flattened (1 - cos measured <= 6.8e-5).
`remat=True` and `remat=False` give equal gradients (`torch.equal`):
recomputation runs the same ops on the same inputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as RM
import repro_torch.models as PM
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.configs.base import ShapeConfig
from repro.data.pipeline import SyntheticTokenSource
from repro.models import layers as ref_layers
from repro_torch.configs import get_config, reduced
from repro_torch.interop import params_from_reference, reference_leaf

LOSS_ATOL = 0.06
GRAD_TOL = 2.0 ** -5
GRAD_TOL_BY_ARCH = {"rwkv6-7b": 2.0 ** -4}
COS_MIN = 0.9999
STRICT = {"xla_allow_excess_precision": False}
SHAPE = ShapeConfig("tiny", seq_len=16, global_batch=2, kind="train")
ARCHS = ("qwen2.5-3b", "llava-next-34b", "gemma3-4b", "olmoe-1b-7b")


@dataclasses.dataclass
class Case:
    pcfg: object
    model: torch.nn.Module
    batch: dict              # numpy
    loss: float              # the reference's
    grads: dict              # the reference's, numpy f32 leaves


def build_case(arch):
    """The reference's reduced config, params, pipeline batch and STRICT
    value_and_grad (compiled once), and the port's model carrying the
    params."""
    prev = ref_layers._EXEC_SAFE
    ref_layers.set_exec_safe(True)
    try:
        rcfg = ref_reduced(ref_get_config(arch))
        key = jax.random.key(0)
        params = jax.jit(RM.init_params, static_argnums=1).lower(
            key, rcfg).compile({"xla_backend_optimization_level": 0})(key)
        batch = SyntheticTokenSource(rcfg, SHAPE, seed=0).batch_at(0)

        def vg(p, b):
            return jax.value_and_grad(
                lambda p_: RM.lm_loss(p_, rcfg, b)[0])(p)
        loss, grads = jax.jit(vg).lower(params, batch).compile(STRICT)(
            params, batch)
    finally:
        ref_layers.set_exec_safe(prev)
    pcfg = reduced(get_config(arch))
    model = params_from_reference(jax.tree.map(np.asarray, params), pcfg,
                                  "cpu")
    grads = jax.tree.map(lambda g: np.asarray(jnp.asarray(g, jnp.float32)),
                         grads)
    return Case(pcfg, model, batch, float(loss), grads)


def cases_fixture():
    built = {}

    def get(arch):
        if arch not in built:
            built[arch] = build_case(arch)
        return built[arch]
    return get


@pytest.fixture(scope="module")
def cases():
    return cases_fixture()


def port_grads(case, remat=True):
    """(loss, {name: f32 numpy gradient}) of the port's lm_loss; a
    parameter the loss does not reach gets zeros."""
    model = case.model
    model.requires_grad_(True)
    model.zero_grad(set_to_none=True)
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in
             case.batch.items()}
    loss, _ = PM.lm_loss(model, case.pcfg, batch, remat=remat)
    loss.backward()
    out = {n: (p.grad.float().numpy().copy() if p.grad is not None
               else np.zeros(tuple(p.shape), np.float32))
           for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    model.requires_grad_(False)
    return float(loss.detach()), out


def check_grads(case, arch):
    loss, grads = port_grads(case)
    assert abs(loss - case.loss) <= LOSS_ATOL, (arch, loss, case.loss)
    tol = GRAD_TOL_BY_ARCH.get(arch, GRAD_TOL)
    dot = na = nb = 0.0
    taken = set()
    for name, got in grads.items():
        path, index = reference_leaf(name, case.pcfg)
        want = case.grads
        for key in path:
            want = want[key]
        want = want[index]
        taken.add(path)
        assert got.shape == want.shape, name
        assert np.isfinite(got).all(), name
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        assert err <= tol * scale or (scale == 0 and err == 0), \
            (arch, name, err, scale)
        dot += float(np.dot(got.ravel().astype(np.float64),
                            want.ravel().astype(np.float64)))
        na += float(np.sum(np.square(got.astype(np.float64))))
        nb += float(np.sum(np.square(want.astype(np.float64))))
    assert len(taken) == len(jax.tree.leaves(case.grads))
    cos = dot / np.sqrt(na * nb)
    assert cos >= COS_MIN, (arch, cos)


def check_remat(case):
    l1, g1 = port_grads(case, remat=True)
    l0, g0 = port_grads(case, remat=False)
    assert l1 == l0
    assert g1.keys() == g0.keys()
    for name in g1:
        assert torch.equal(torch.from_numpy(g1[name]),
                           torch.from_numpy(g0[name])), name


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_grads_match_reference(cases, arch):
    check_grads(cases(arch), arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_gradient(cases, arch):
    check_remat(cases(arch))
