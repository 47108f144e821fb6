"""The port's AdamW (`repro_torch.optim.adamw`) against
`repro.optim.adamw` on the CPU, and ports of `tests/test_substrate.py`'s
optimizer tests. The reference's `apply` runs op by op (eagerly): jitted,
XLA contracts its multiply-adds (432,556 of a reduced qwen2.5-3b's 821,632
updated f32 moments move at the default optimization level, 1 at -O0),
which the port does not do.

Tolerances:
  * AdamW without clipping (`grad_clip=0`): exact (`torch.equal`) over 5
    steps on a reduced qwen2.5-3b's real gradients, f32 and bf16 moments —
    the update is elementwise and the port keeps the reference's f32
    rounding points op for op;
  * with clipping (the default `grad_clip=1`): `global_norm` sums 821,632
    squares in another order than XLA (measured up to 6.7e-7 relative over
    the 5 steps), so GNORM_RTOL = 2^-20 relative; the clip scale moves with
    it, so f32 moments lie within MOMENT_RTOL = 2^-19 of their leaf's
    largest magnitude (measured 1.35e-6 for mu, 1.41e-6 for nu: nu goes
    with the scale's square) and bf16 moments within 2^-8 of it (one bf16
    ulp at the largest magnitude or less; measured 1.9e-3). A parameter
    element whose f32 update lands on the other side of a bf16 rounding
    differs by one ulp of its own value, so each leaf lies within
    P_TOL = 2^-8 of its largest magnitude (measured 2.3e-3), and at most
    P_DIFF_MAX = 1e-4 of all elements differ (measured at most 21 of
    821,632 a step);
  * the schedule and weight decay's leaf set: exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as RM
from repro.configs.base import ShapeConfig as RefShape
from repro.data.pipeline import SyntheticTokenSource as RefSource
from repro.optim import adamw as RA
from repro_torch.interop import (opt_state_from_reference,
                                 params_from_reference, reference_leaf)
from repro_torch.optim import adamw
from test_torch_train import _f32, _leaf, _ref_params

GNORM_RTOL = 2.0 ** -20
MOMENT_RTOL = 2.0 ** -19
P_TOL = 2.0 ** -8
P_DIFF_MAX = 1e-4


# ---------------------------------------------------------------------------
# AdamW (ports of test_substrate.py:25-53, then parity)
# ---------------------------------------------------------------------------

def test_adamw_converges_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                            total_steps=200, grad_clip=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = adamw.init(cfg, params)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}        # d/dw sum(w^2)
        params, state, _ = adamw.apply(cfg, params, grads, state)
    assert float(torch.max(torch.abs(params["w"]))) < 0.05


def test_adamw_bf16_moments():
    cfg = adamw.AdamWConfig(moment_dtype=torch.bfloat16)
    params = {"w": torch.ones((4, 4))}
    state = adamw.init(cfg, params)
    assert state.mu["w"].dtype == torch.bfloat16
    grads = {"w": torch.ones((4, 4))}
    p2, s2, m = adamw.apply(cfg, params, grads, state)
    assert torch.isfinite(m["grad_norm"])
    assert s2.mu["w"].dtype == s2.nu["w"].dtype == torch.bfloat16


def test_schedule_warmup_and_decay():
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                            min_lr_ratio=0.1)

    def sched(step):
        return float(adamw.schedule(cfg, torch.tensor(step,
                                                      dtype=torch.int32)))
    assert sched(5) == pytest.approx(0.5)
    assert sched(10) == pytest.approx(1.0)
    assert sched(100) == pytest.approx(0.1)


@pytest.mark.parametrize("step", [0, 1, 50, 100, 101, 4321, 10000, 12000])
def test_schedule_matches_reference(step):
    # warmup (0-100), the peak (100), the cosine and its end (10000+)
    want = float(RA.schedule(RA.AdamWConfig(), jnp.int32(step)))
    got = float(adamw.schedule(adamw.AdamWConfig(),
                               torch.tensor(step, dtype=torch.int32)))
    assert got == want, (step, got, want)


@pytest.fixture(scope="module")
def qwen_grads():
    """A reduced qwen2.5-3b's reference params and the real gradients of 5
    pipeline batches taken along a reference AdamW run (lr 1e-2)."""
    rcfg, pcfg, params = _ref_params("qwen2.5-3b")
    src = RefSource(rcfg, RefShape("tiny", 16, 2, "train"), seed=0)
    gfn = jax.jit(jax.grad(lambda p, b: RM.lm_loss(p, rcfg, b)[0]))
    return rcfg, pcfg, params, src, gfn


def _opt_cfgs(moments, clip):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, grad_clip=clip)
    return (RA.AdamWConfig(moment_dtype=jnp.dtype(moments), **kw),
            adamw.AdamWConfig(moment_dtype=getattr(torch, moments), **kw))


@pytest.mark.parametrize("clip", [0.0, 1.0])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_matches_reference_over_five_steps(qwen_grads, moments, clip):
    rcfg, pcfg, params, src, gfn = qwen_grads
    rc, pc = _opt_cfgs(moments, clip)
    state = RA.init(rc, params)
    model = params_from_reference(jax.tree.map(np.asarray, params), pcfg,
                                  "cpu")
    pstate = opt_state_from_reference(jax.tree.map(np.asarray, state), model,
                                      pcfg)
    named = dict(model.named_parameters())
    for step in range(5):
        grads = gfn(params, src.batch_at(step))
        pg = {n: params_from_reference_leaf(grads, n, pcfg, p)
              for n, p in named.items()}
        named, pstate, pm = adamw.apply(pc, named, pg, pstate,
                                        model_cfg=pcfg)
        params, state, rm = RA.apply(rc, params, grads, state)
        assert float(pm["lr"]) == float(rm["lr"])
        assert int(pstate.step) == int(state.step) == step + 1
        gn, rgn = float(pm["grad_norm"]), float(rm["grad_norm"])
        assert abs(gn - rgn) <= GNORM_RTOL * rgn, (step, gn, rgn)
        n_diff = n_all = 0
        for n, p in named.items():
            want_p = _leaf(params, n, pcfg)
            want_m, want_v = (_leaf(state.mu, n, pcfg),
                              _leaf(state.nu, n, pcfg))
            got_p, got_m, got_v = (p.float().numpy(),
                                   pstate.mu[n].float().numpy(),
                                   pstate.nu[n].float().numpy())
            assert pstate.mu[n].dtype == getattr(torch, moments)
            if clip == 0.0:
                for got, want in ((got_p, want_p), (got_m, want_m),
                                  (got_v, want_v)):
                    assert np.array_equal(got, want), (step, n)
                continue
            assert np.abs(got_p - want_p).max() <= \
                P_TOL * np.abs(want_p).max(), (step, n)
            n_diff += int((got_p != want_p).sum())
            n_all += got_p.size
            rtol = MOMENT_RTOL if moments == "float32" else P_TOL
            for got, want in ((got_m, want_m), (got_v, want_v)):
                assert np.abs(got - want).max() <= \
                    rtol * np.abs(want).max(), (step, n)
        assert n_diff <= P_DIFF_MAX * max(n_all, 1), (step, n_diff)


def params_from_reference_leaf(tree, name, cfg, like):
    """The slice of a reference gradient pytree that the port's parameter
    `name` takes, as a tensor of that parameter's dtype."""
    path, index = reference_leaf(name, cfg)
    for key in path:
        tree = tree[key]
    return torch.from_numpy(_f32(tree)[index].copy()).to(like.dtype)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "zamba2-7b"])
def test_weight_decay_follows_the_reference_leaf_rank(arch):
    # Zero gradients leave only the decay term: lr * wd * p on exactly the
    # leaves the reference decays (rank >= 2 counting a stack's layer axes).
    rcfg, pcfg, params = _ref_params(arch)
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape).astype(np.float32), x.dtype), params)
    rc, pc = _opt_cfgs("float32", 1.0)
    # lr 1 and wd 0.1: a decayed bf16 element moves by a tenth of itself,
    # past any rounding
    rc = dataclasses.replace(rc, lr=1.0, warmup_steps=0)
    pc = dataclasses.replace(pc, lr=1.0, warmup_steps=0)
    zeros = jax.tree.map(jnp.zeros_like, params)
    new, _, _ = RA.apply(rc, params, zeros, RA.init(rc, params))
    model = params_from_reference(jax.tree.map(np.asarray, params), pcfg,
                                  "cpu")
    named = dict(model.named_parameters())
    got, _, _ = adamw.apply(pc, named, {}, adamw.init(pc, named),
                            model_cfg=pcfg)
    decayed = set()
    for n, p in got.items():
        want = _leaf(new, n, pcfg)
        assert np.array_equal(p.float().numpy(), want), n
        if not np.array_equal(p.float().numpy(), _leaf(params, n, pcfg)):
            decayed.add(n)
    ref_decayed = set()
    for n in named:
        path, _ = reference_leaf(n, pcfg)
        leaf = params
        for key in path:
            leaf = leaf[key]
        if leaf.ndim >= 2:                  # the reference's rule
            ref_decayed.add(n)
    assert decayed == ref_decayed
    if arch == "qwen2.5-3b":
        assert "layers.0.ln1.scale" in decayed          # (L, d) leaf
        assert "final_norm.scale" not in decayed        # (d,)
    else:
        assert "shared_attn.ln1.scale" not in decayed   # (d,)
        assert "mamba_tail.0.m.a_log" in decayed        # (1, H) f32
        assert "mamba_groups.0.m.a_log" in decayed      # (g, a, H)
