"""The reference's layout switches in the port: `layers.set_gqa_mode`
("grouped" | "repeat_kv"), `layers.set_xent_mode` ("gather" | "onehot"),
the module defaults `moe.DISPATCH_MODE` and `rwkv.WKV_MODE`, and the
dry-run's `apply_perf_flags` with its `--gqa-mode` / `--xent-mode` flags.

* `repeat_kv` against `grouped` on reduced qwen2.5-3b (8 query heads, 1 KV
  head) and gemma3-4b (8 and 4, sliding window, tied table): the forward
  logits equal bit for bit (each score and context element sums the same
  head-dim or key products in the same order either way); each mode
  against the reference in the same mode, jitted with exec-safe products
  as the serving tests run it, within `tests/test_torch_lm.py`'s
  LOGIT_ATOL = 0.03 (its docstring says why).
* `onehot` against `gather`: the gold logit is the one nonzero term of its
  masked sum, so loss and gradients equal bit for bit; `softmax_xent` in
  each mode against the reference's on the same f32 logits within 1e-6 of
  the loss (logsumexp sums in another order).
* `apply_perf_flags` leaves the same state as the reference's: the four
  module globals and the context-parallel switch.
* The dry-run CLI passes its flags on (the cell stubbed), and its cheapest
  cell (granite-3-2b decode_32k on the 256-card mesh, ~7 s in a
  subprocess) traces with `--gqa-mode repeat_kv --xent-mode onehot` (a
  decode cell has no loss: the cross-entropy mode is set, not exercised).
A fixture restores every switch in both packages after each test.
"""
import json
import os
import subprocess
import sys

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
from repro.launch import dryrun as ref_dryrun
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro.models import rwkv as ref_rwkv
from repro_torch.configs import get_config, reduced
from repro_torch.interop import params_from_reference
from repro_torch.launch import dryrun
from repro_torch.models import layers, moe, rwkv

LOGIT_ATOL = 0.03
XENT_RTOL = 1e-6
ARCHS = ("qwen2.5-3b", "gemma3-4b")
SHAPE = ShapeConfig("tiny", seq_len=16, global_batch=2, kind="train")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(lay, moe_mod, rwkv_mod, dry):
    return (lay.GQA_MODE, lay.XENT_MODE, moe_mod.DISPATCH_MODE,
            rwkv_mod.WKV_MODE, dry._CONTEXT_PARALLEL)


def _restore(lay, moe_mod, rwkv_mod, dry, state):
    (lay.GQA_MODE, lay.XENT_MODE, moe_mod.DISPATCH_MODE, rwkv_mod.WKV_MODE,
     dry._CONTEXT_PARALLEL) = state


@pytest.fixture(autouse=True)
def switches():
    mods = ((ref_layers, ref_moe, ref_rwkv, ref_dryrun),
            (layers, moe, rwkv, dryrun))
    saved = [_state(*m) for m in mods]
    exec_safe = ref_layers._EXEC_SAFE
    ref_layers.set_exec_safe(True)
    yield
    for m, s in zip(mods, saved):
        _restore(*m, s)
    ref_layers.set_exec_safe(exec_safe)


_MODELS = {}


def _model(arch):
    """The reference's reduced params and pipeline batch, and the port's
    model carrying the params."""
    if arch not in _MODELS:
        rcfg = ref_reduced(ref_get_config(arch))
        key = jax.random.key(0)
        params = jax.jit(RM.init_params, static_argnums=1).lower(
            key, rcfg).compile({"xla_backend_optimization_level": 0})(key)
        batch = SyntheticTokenSource(rcfg, SHAPE, seed=0).batch_at(0)
        pcfg = reduced(get_config(arch))
        model = params_from_reference(jax.tree.map(np.asarray, params),
                                      pcfg, "cpu")
        _MODELS[arch] = (rcfg, params, batch, pcfg, model)
    return _MODELS[arch]


def _port_logits(pcfg, model, batch):
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    with torch.no_grad():
        return PM.forward(model, pcfg, tb)["logits"].float().numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_repeat_kv_equals_grouped_and_the_reference(arch):
    rcfg, params, batch, pcfg, model = _model(arch)
    assert pcfg.n_heads // pcfg.n_kv_heads > 1
    got = {}
    for mode in ("grouped", "repeat_kv"):
        layers.set_gqa_mode(mode)
        ref_layers.set_gqa_mode(mode)
        got[mode] = _port_logits(pcfg, model, batch)
        want = jax.jit(lambda p, b: RM.forward(p, rcfg, b)["logits"])(
            params, batch)
        want = np.asarray(jnp.asarray(want, jnp.float32))
        assert float(np.abs(got[mode] - want).max()) <= LOGIT_ATOL, mode
    assert np.array_equal(got["grouped"], got["repeat_kv"])


def test_repeat_kv_decode_equals_grouped():
    """The decode step too (K/V from the cache, repeated per step)."""
    _, _, batch, pcfg, model = _model("qwen2.5-3b")
    toks = torch.from_numpy(np.asarray(batch["tokens"]))
    out = {}
    for mode in ("grouped", "repeat_kv"):
        layers.set_gqa_mode(mode)
        with torch.no_grad():
            _, cache = PM.prefill(model, pcfg, {"tokens": toks[:, :-1]})
            cache = {k: torch.nn.functional.pad(
                v, (0, 0) * (v.ndim - 3) + (0, 1)) if k in ("k", "v")
                else v for k, v in cache.items()}
            out[mode], _ = PM.decode_step(model, pcfg, toks[:, -1:],
                                          toks.shape[1] - 1, cache)
    assert torch.equal(out["grouped"], out["repeat_kv"])


def _loss_and_grads(pcfg, model, batch):
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    model.requires_grad_(True)
    model.zero_grad(set_to_none=True)
    try:
        loss, _ = PM.lm_loss(model, pcfg, tb, remat=True)
        loss.backward()
        return loss.detach(), {n: p.grad.clone()
                               for n, p in model.named_parameters()
                               if p.grad is not None}
    finally:
        model.zero_grad(set_to_none=True)
        model.requires_grad_(False)


def test_onehot_equals_gather():
    _, _, batch, pcfg, model = _model("qwen2.5-3b")
    got = {}
    for mode in ("gather", "onehot"):
        layers.set_xent_mode(mode)
        got[mode] = _loss_and_grads(pcfg, model, batch)
    (l0, g0), (l1, g1) = got["gather"], got["onehot"]
    assert torch.equal(l0, l1) and g0.keys() == g1.keys()
    assert all(torch.equal(g0[n], g1[n]) for n in g0)


@pytest.mark.parametrize("mode", ["gather", "onehot"])
def test_softmax_xent_matches_reference(mode):
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((2, 7, 97)) * 3).astype(np.float32)
    targets = rng.integers(0, 97, size=(2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) > 0.3).astype(np.float32)
    layers.set_xent_mode(mode)
    ref_layers.set_xent_mode(mode)
    for m in (None, mask):
        got = float(layers.softmax_xent(
            torch.from_numpy(logits), torch.from_numpy(targets),
            None if m is None else torch.from_numpy(m)))
        want = float(ref_layers.softmax_xent(jnp.asarray(logits),
                                             jnp.asarray(targets),
                                             None if m is None
                                             else jnp.asarray(m)))
        assert abs(got - want) <= XENT_RTOL * abs(want)


def test_mode_switches_refuse_unknown_modes():
    for setter in (layers.set_gqa_mode, layers.set_xent_mode):
        with pytest.raises(AssertionError):
            setter("other")


@pytest.mark.parametrize("flags", [
    ("cumsum", "chunked", True, "repeat_kv", "onehot"),
    (None, None, False, None, None),
    ("sort", None, False, "grouped", "gather"),
])
def test_apply_perf_flags_sets_the_reference_state(flags):
    ref_dryrun.apply_perf_flags(*flags)
    dryrun.apply_perf_flags(*flags)
    assert _state(layers, moe, rwkv, dryrun) == _state(
        ref_layers, ref_moe, ref_rwkv, ref_dryrun)


def test_module_defaults_reach_the_models():
    """`DISPATCH_MODE` and `WKV_MODE` are what a call with no mode runs,
    and the models pass none: a reduced rwkv6-7b forward follows
    `WKV_MODE` (the chunked form, 64-token chunks, differs from the scan
    by design)."""
    gen = torch.Generator().manual_seed(1)
    cfg = reduced(get_config("olmoe-1b-7b"))
    blk = PM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p = next(m for m in blk.modules() if isinstance(m, moe.MoE))
    x = torch.randn((2, 8, cfg.d_model), generator=gen).bfloat16()
    rcfg = reduced(get_config("rwkv6-7b"))
    net = PM.init_params(rcfg, torch.Generator().manual_seed(0), "cpu")
    t = next(m for m in net.modules() if isinstance(m, rwkv.RWKVTime))
    xr = torch.randn((2, 64, rcfg.d_model), generator=gen).bfloat16()
    tokens = torch.randint(0, rcfg.vocab, (2, 64), generator=gen)
    logits = {}
    with torch.no_grad():
        for mode in ("sort", "cumsum"):
            moe.DISPATCH_MODE = mode
            got, _ = moe.apply_moe_dispatch(p, cfg, x, groups=2)
            want, _ = moe.apply_moe_dispatch(p, cfg, x, groups=2, mode=mode)
            assert torch.equal(got, want), mode
        for mode in ("scan", "chunked"):
            rwkv.WKV_MODE = mode
            got, _ = rwkv.apply_rwkv_time(t, rcfg, xr)
            want, _ = rwkv.apply_rwkv_time(t, rcfg, xr, wkv_mode=mode)
            assert torch.equal(got, want), mode
            logits[mode] = PM.forward(net, rcfg, {"tokens": tokens})["logits"]
    assert not torch.equal(logits["scan"], logits["chunked"])


def test_dryrun_cli_applies_its_flags(monkeypatch):
    seen = []

    def cell(arch, shape, multi_pod, **kw):
        seen.append((layers.GQA_MODE, layers.XENT_MODE))
        return {"arch": arch, "shape": shape, "status": "ok"}
    monkeypatch.setattr(dryrun, "run_cell", cell)
    assert dryrun.main(["--arch", "granite-3-2b", "--shape", "decode_32k",
                        "--device-type", "cpu", "--gqa-mode", "repeat_kv",
                        "--xent-mode", "onehot"]) == 0
    assert seen == [("repeat_kv", "onehot")]


def test_dryrun_cheapest_cell_in_repeat_kv_and_onehot(tmp_path):
    out = tmp_path / "cell.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "granite-3-2b", "--shape", "decode_32k", "--mesh", "single",
         "--device-type", "cpu", "--gqa-mode", "repeat_kv", "--xent-mode",
         "onehot", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    (cell,) = json.loads(out.read_text())
    assert cell["status"] == "ok" and cell["chips"] == 256
    assert cell["roofline"]["flops"] > 0 and cell["gemm_flops"] > 0
