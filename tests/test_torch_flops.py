"""The port's FLOP counter (the analogues of tests/test_jaxpr_cost.py) and
its parity with the reference's jaxpr accounting.

* Known programs: a plain matmul, a batched einsum, a convolution, a
  `scan` loop counted times its length, remat's recompute, a model forward inside the 1-10 x
  N·D envelope.
* GEMM FLOPs equal the reference's `dot_general` FLOPs exactly — summed
  here over `jax.make_jaxpr` with scans times their length, as Python
  ints — for the forward of each of the six families at reduced configs
  and for the full train step (lm_loss, its remat backward, AdamW) of two.
  JAX lowers the outer products inside three-operand einsums (the SSD's
  chunk sums, its decode update) as contraction-free dot_generals
  (2·B·M·N·1); torch's einsum multiplies them elementwise, which the port
  charges one FLOP an element. Those dot_generals are left out of the
  parity (zamba2-7b's 163,840 of 71,180,288 at the reduced config).
* Totals (one FLOP an element for every other op on both sides) agree
  within a factor TOTAL_RATIO: the reference charges each jaxpr equation
  (converts, broadcasts, reshapes) where the port charges aten ops (views
  free), so they are not the same count.
* The scaled counts — a `scan` traced once and charged its trip count, a
  layer stack traced at depth cuts and extrapolated (`launch.dryrun`) —
  equal the unscaled ones: GEMM FLOPs, collectives and output bytes
  exactly; the extrapolated total within EXTRAPOLATION_REL (the first
  layer of a stack differs from the next by a few elementwise FLOPs).
* `hbm_bytes` equals the reference's `_state_traffic_bytes` on unsharded
  structs.
"""
import os

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import repro.models as RM
from repro.analysis.jaxpr_cost import _dot_flops, _sub_jaxprs
from repro.analysis.jaxpr_cost import flops as ref_flops
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.optim import adamw as ref_adamw
from repro.train.trainer import make_train_step as ref_make_train_step
import repro_torch.models as M
from repro_torch.analysis.op_cost import FlopCounter, flops, trace_flops
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.models.layers import scan
from repro_torch.optim import adamw
from repro_torch.train.trainer import make_train_step

_saved = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as ref_dryrun  # noqa: E402  (sets XLA_FLAGS)
if _saved is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _saved

TOTAL_RATIO = 1.5
EXTRAPOLATION_REL = 1e-6
FAMILIES = ("qwen2.5-3b", "olmoe-1b-7b", "deepseek-v3-671b", "zamba2-7b",
            "rwkv6-7b", "seamless-m4t-medium")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_plain_matmul():
    assert trace_flops(lambda a, b: a @ b, _meta(64, 128), _meta(128, 32)) \
        == 2 * 64 * 128 * 32


def test_batched_einsum():
    f = lambda a, b: torch.einsum("bmk,bkn->bmn", a, b)  # noqa: E731
    got = flops(f, _meta(8, 64, 128), _meta(8, 128, 32))
    assert got.gemm == 2 * 8 * 64 * 128 * 32
    assert got.total == got.gemm


def test_convolution():
    x, w = _meta(2, 8, 16, 16), _meta(4, 8, 3, 3)
    got = flops(lambda x, w: torch.nn.functional.conv2d(x, w, padding=1),
                x, w)
    assert got.gemm == 2 * (2 * 4 * 16 * 16) * 8 * 3 * 3


def test_scan_multiplies_body():
    w, x = _meta(10, 64, 64), _meta(4, 64)

    def f(w, x):
        return scan(lambda c, t: (c @ w[t], c), x, 10)[0]

    got = flops(f, w, x)
    assert got.gemm == 10 * 2 * 4 * 64 * 64
    with FlopCounter() as unscaled:     # no scan hook: the loop runs
        f(w, x)
    assert (unscaled.total, unscaled.gemm) == tuple(got)


def test_remat_recompute_counted():
    w = torch.empty(32, 32, device="meta", requires_grad=True)
    x = _meta(4, 32)

    def loss(w, x):
        return torch.sum(torch.tanh(x @ w) @ w)

    def grad(remat):
        def f(w, x):
            out = checkpoint(loss, w, x, use_reentrant=False) if remat \
                else loss(w, x)
            out.backward()
        return flops(f, w, x)

    assert grad(True).gemm > grad(False).gemm
    assert grad(True).total >= grad(False).total


def test_model_forward_close_to_analytic():
    cfg = reduced(get_config("granite-3-2b"))
    model = D._meta_model(cfg)
    batch = {"tokens": _meta(2, 32, dtype=torch.int32)}
    fl = trace_flops(lambda p, b: M.forward(p, cfg, b, remat=False), model,
                     batch)
    n = cfg.param_count()
    assert 1.0 * n * 64 < fl < 10.0 * n * 64


def _ref_dot_flops(jaxpr) -> int:
    """dot_general FLOPs of a jaxpr as ints, scans times their length;
    contraction-free dot_generals (outer products) left out."""
    j = jaxpr.jaxpr if hasattr(jaxpr, "jaxpr") else jaxpr
    total = 0
    for eqn in j.eqns:
        if eqn.primitive.name == "dot_general":
            (contract, _), _ = eqn.params["dimension_numbers"]
            if contract:
                total += int(_dot_flops(eqn))
        else:
            for sub, mult in _sub_jaxprs(eqn):
                total += int(mult) * _ref_dot_flops(sub)
    return total


def _batches(cfg, b=2, s=16):
    port = {"tokens": _meta(b, s, dtype=torch.int32)}
    ref = {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32)}
    if cfg.family == "encdec":
        port["src_embeds"] = _meta(b, 8, cfg.d_model)
        ref["src_embeds"] = jax.ShapeDtypeStruct((b, 8, cfg.d_model),
                                                 jnp.float32)
    return port, ref


def _ref_params(arch):
    rcfg = ref_reduced(ref_get_config(arch))
    return rcfg, jax.eval_shape(lambda: RM.init_params(jax.random.key(0),
                                                       rcfg))


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_gemm_flops_equal_the_references_dot_generals(arch):
    cfg = reduced(get_config(arch))
    rcfg, rparams = _ref_params(arch)
    pb, rb = _batches(cfg)
    jaxpr = jax.make_jaxpr(lambda p, b: RM.forward(p, rcfg, b, remat=False))(
        rparams, rb)
    got = flops(lambda p, b: M.forward(p, cfg, b, remat=False),
                D._meta_model(cfg), pb)
    assert got.gemm == _ref_dot_flops(jaxpr)
    total = ref_flops(jaxpr)
    assert total / TOTAL_RATIO < got.total < total * TOTAL_RATIO


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "olmoe-1b-7b"])
def test_train_step_gemm_flops_equal_the_references(arch):
    cfg = reduced(get_config(arch))
    rcfg, rparams = _ref_params(arch)
    pb, rb = _batches(cfg)
    ropt = ref_adamw.AdamWConfig()
    rstate = jax.eval_shape(lambda: ref_adamw.init(ropt, rparams))
    jaxpr = jax.make_jaxpr(ref_make_train_step(rcfg, ropt))(rparams, rstate,
                                                            rb)
    model = D._meta_model(cfg)
    opt_cfg = adamw.AdamWConfig()
    state = adamw.init(opt_cfg, dict(model.named_parameters()))
    got = flops(make_train_step(cfg, opt_cfg), model, state, pb)
    assert got.gemm == _ref_dot_flops(jaxpr)
    total = ref_flops(jaxpr)
    assert total / TOTAL_RATIO < got.total < total * TOTAL_RATIO


def test_a_scan_traced_once_counts_what_the_loop_counts():
    cfg = reduced(get_config("rwkv6-7b"))
    model = D._meta_model(cfg)
    pb, _ = _batches(cfg, s=24)
    fn = lambda p, b: M.forward(p, cfg, b, remat=False)  # noqa: E731
    once = flops(fn, model, pb)
    with FlopCounter() as looped:
        fn(model, pb)
    assert (looped.total, looped.gemm) == tuple(once)


@pytest.fixture(scope="module")
def small_mesh():
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import destroy_fake_world, init_fake_world
    init_fake_world()
    yield DeviceMesh("cpu", torch.arange(8).reshape(2, 4),
                     mesh_dim_names=("data", "model"))
    destroy_fake_world()


@pytest.mark.parametrize("arch,kind", [
    ("gemma3-4b", "train"), ("deepseek-v3-671b", "decode"),
    ("zamba2-7b", "prefill"), ("seamless-m4t-medium", "decode")])
def test_depth_extrapolation_equals_the_full_trace(small_mesh, arch, kind):
    cfg = reduced(get_config(arch))
    shape = ShapeConfig("tiny", 32, 8, kind)
    cut = D.measure_cell(cfg, shape, small_mesh)
    full = D.measure_cell(cfg, shape, small_mesh, full_depth=True)
    assert len(cut["traced_cuts"]) >= 2
    for key in ("collectives", "collective_counts", "gemm_flops"):
        assert cut[key] == full[key], key
    for key in ("argument_size_in_bytes", "output_size_in_bytes",
                "alias_size_in_bytes"):
        assert cut["memory"][key] == full["memory"][key], key
    assert cut["roofline"]["flops"] == pytest.approx(
        full["roofline"]["flops"], rel=EXTRAPOLATION_REL)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_hbm_bytes_equal_the_references(kind):
    arch = "qwen2.5-3b"
    cfg = reduced(get_config(arch))
    rcfg, rparams = _ref_params(arch)
    shape = ShapeConfig("tiny", 16, 2, kind)
    pb, rb = _batches(cfg)
    model = D._meta_model(cfg)
    if kind == "train":
        ropt = ref_adamw.AdamWConfig()
        rargs = (rparams, jax.eval_shape(lambda: ref_adamw.init(ropt,
                                                                rparams)), rb)
        rfn = ref_make_train_step(rcfg, ropt)
        opt_cfg = adamw.AdamWConfig()
        args = (model, adamw.init(opt_cfg, dict(model.named_parameters())),
                pb)
        fn = make_train_step(cfg, opt_cfg)
    elif kind == "prefill":
        rargs, args = (rparams, rb), (model, pb)
        rfn = lambda p, b: RM.prefill(p, rcfg, b)  # noqa: E731
        fn = lambda p, b: M.prefill(p, cfg, b)  # noqa: E731
    else:
        rcache = jax.eval_shape(lambda: RM.init_cache(rcfg, 2, 16))
        rtok = jax.ShapeDtypeStruct((2, 1), jnp.int32)
        rargs = (rparams, rtok, jax.ShapeDtypeStruct((), jnp.int32), rcache)
        rfn = lambda p, t, pos, c: RM.decode_step(p, rcfg, t, pos, c)  # noqa
        args = (model, _meta(2, 1, dtype=torch.int32), 15,
                M.init_cache(cfg, 2, 16, device="meta"))
        fn = lambda p, t, pos, c: M.decode_step(p, cfg, t, pos, c)  # noqa
    want = ref_dryrun._state_traffic_bytes(rcfg, shape, rargs, rfn)
    in_bytes = D.argument_bytes(args, shape)
    got = D._state_traffic_bytes(cfg, shape, in_bytes,
                                 D._bytes_of(fn(*args)))
    assert got == want
