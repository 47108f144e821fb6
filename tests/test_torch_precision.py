"""The products' bf16 mode (`models.layers.set_exec_safe(False)`, the
default in both packages) against `repro` in the same mode.

In bf16 mode the reference multiplies bf16 operands into an f32 result
(`preferred_element_type=float32`); on a card the port does the same with
`torch.mm`/`torch.bmm(..., out_dtype=torch.float32)` after lowering each
einsum to one batched product (`layers.lowered_einsum`), and the
gradient is an `autograd.Function` (`layers._Product`, its operands
saved by `layers._Operands`) whose backward is the reference's
transpose: the f32 cotangent times the other operand taken as f32. On
the CPU PyTorch has no such product, so the port's bf16 mode computes the
exec-safe form there (operands cast to f32): the plain version; meta
tensors take the bf16 route. These tests hold:

  (i) each of the models' sixteen einsum equations and `matmul32`, the
      port's bf16 mode against the reference's jitted on XLA:CPU, within
      the summation-order bound |diff| <= K * 2^-24 * sum_k |a_k b_k| per
      output element (K the contraction length: two f32 sums of the same
      exact bf16 products in different orders each lie within that of
      the exact sum); both results f32. XLA:CPU has no bf16 x bf16 -> f32
      kernel for some batched dots it forms ("Unsupported element type
      for DotThunk::Execute": `bhqk,bkr->bqhr` at batch > 1, the MoE
      equations on a grouped (G, E, C, D) buffer), so there the reference
      runs one slice of the leading dimension at a time (`_ref_einsum`:
      the same function, as the model runs it at batch 1 or a
      three-dimensional buffer);
 (ii) the lowering, with the product passed in as a function (the f32
      `torch.bmm`/`torch.mm` of the upcast operands), equal to
      `torch.einsum` of the f32 operands bit for bit: it forms
      `torch.einsum`'s batched product exactly; and the card's own
      product through the lowering on meta tensors (shapes, the f32
      result, the operands' gradient dtypes);
(iii) the `autograd.Function` with that injected product: output and
      gradients bit-equal to the exec-safe path's autograd, with and
      without `torch.utils.checkpoint`, for the sixteen equations and
      `matmul32`'s lowering `...k,kn->...n` (one `mm`); and the plain
      bf16-result products' `layers._Matmul16`, whose every GEMM runs
      with cuBLAS's bf16 reduced-precision reduction off;
 (iv) reduced qwen2.5-3b, gemma3-4b, olmoe-1b-7b and rwkv6-7b, the port in
      bf16 mode against the reference in bf16 mode (STRICT-jitted, as in
      `tests/test_torch_train_grads.py`): logits within LOGIT_ATOL = 0.03,
      loss within LOSS_ATOL = 0.06, every gradient leaf within GRAD_TOL =
      2^-5 of its largest magnitude. The reference is not closer to
      itself: with XLA's default fusion its jitted gradients differ from
      its op-by-op (`jax.disable_jit()`) ones by up to 0.019 of a leaf's
      largest magnitude on qwen2.5-3b, 0.019 on gemma3-4b, 0.022 on
      olmoe-1b-7b (all inside 2^-5) and 0.055 on rwkv6-7b; the port
      measured 0.025, 0.013, 0.016 and 0.057 against the STRICT-jitted
      reference. So rwkv6-7b is held to 2^-4 = 0.0625, 1.1x the
      reference's own spread (at most twice it), as
      `tests/test_torch_train_grads.py` holds it in exec-safe mode (the
      WKV recurrence's backward carries the forward's 0.019 logit
      difference through every step);
  (v) the launchers' mode follows `--reduced`, as the reference's:
      `launch.train` and `launch.serve tokens` turn exec-safe on with
      `--reduced` and leave bf16 mode at full width.
A fixture restores both packages' modes after each test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

import repro.models as RM
import repro_torch.models as PM
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.configs.base import ShapeConfig
from repro.data.pipeline import SyntheticTokenSource
from repro.models import layers as ref_layers
from repro_torch.configs import get_config, reduced
from repro_torch.interop import params_from_reference, reference_leaf
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import layers

LOGIT_ATOL = 0.03
LOSS_ATOL = 0.06
GRAD_TOL = 2.0 ** -5
GRAD_TOL_BY_ARCH = {"rwkv6-7b": 2.0 ** -4}
STRICT = {"xla_allow_excess_precision": False}
SHAPE = ShapeConfig("tiny", seq_len=16, global_batch=2, kind="train")
ARCHS = ("qwen2.5-3b", "gemma3-4b", "olmoe-1b-7b", "rwkv6-7b")

# The models' equations (layers, mla, moe) at small widths: b 2, s/q 24,
# k 25 keys, d 48, h 4 heads (2 KV heads x 2 groups), head dim 32, vocab
# 97, rank r 40, experts e 3 of capacity c 8, expert width f 56.
B, S, T, D, H, HKV, G, K, V, R, E, C, F = 2, 24, 25, 48, 4, 2, 2, 32, 97, \
    40, 3, 8, 56
EQS = {
    "bsd,dhk->bshk": ((B, S, D), (D, H, K)),
    "bshk,hkd->bsd": ((B, S, H, K), (H, K, D)),
    "bsr,rhk->bshk": ((B, S, R), (R, H, K)),
    "bsd,vd->bsv": ((B, S, D), (V, D)),
    "bqhd,bkhd->bhqk": ((B, S, H, K), (B, T, H, K)),
    "bhqk,bkhd->bqhd": ((B, H, S, T), (B, T, H, K)),
    "bqhgd,bkhd->bhgqk": ((B, S, HKV, G, K), (B, T, HKV, K)),
    "bhgqk,bkhd->bqhgd": ((B, HKV, G, S, T), (B, T, HKV, K)),
    "bqhd,hdm->bqm": ((B, S, H, K), (H, K, D)),
    "bqhn,bkhn->bhqk": ((B, S, H, K), (B, T, H, K)),
    "bqhn,rhn->bqhr": ((B, S, H, K), (R, H, K)),
    "bqhr,bkr->bhqk": ((B, S, H, R), (B, T, R)),
    "bhqk,bkr->bqhr": ((B, H, S, T), (B, T, R)),
    "bqhr,rhd->bqhd": ((B, S, H, R), (R, H, K)),
    "...ecd,edf->...ecf": ((B, E, C, D), (E, D, F)),
    "...ecf,efd->...ecd": ((B, E, C, F), (E, F, D)),
}
MATMUL = ((B, S, D), (D, F))
# matmul32's lowering, and the equations whose gradients are held
MATMUL_EQ = "...k,kn->...n"
GRAD_EQS = dict(EQS, **{MATMUL_EQ: MATMUL})


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the file: under six xdist workers the
    default pools spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def modes():
    """Both packages' product modes restored after each test."""
    prev = ref_layers._EXEC_SAFE, layers._EXEC_SAFE
    yield
    ref_layers.set_exec_safe(prev[0])
    layers.set_exec_safe(prev[1])


def _operands(shapes, seed):
    """bf16 operands from a numpy seed, as numpy f32 (exact in bf16)."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .bfloat16() for s in shapes]


def _ref(x: torch.Tensor):
    return jnp.asarray(x.float().numpy(), jnp.bfloat16)


def _contraction(eq, shapes) -> int:
    """K: the product of the summed labels' sizes (a label's size read from
    the first operand, whose "..." leads)."""
    lhs, out = eq.split("->")
    first, second = (x.replace("...", "") for x in lhs.split(","))
    sizes = dict(zip(first, shapes[0][len(shapes[0]) - len(first):]))
    k = 1
    for c in set(first) & set(second) - set(out):
        k *= sizes[c]
    return k


def _within_bound(got, want, abs_sum, k):
    """The largest |got - want| / (K 2^-24 sum|a b|): at most 1."""
    bound = k * 2.0 ** -24 * abs_sum
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert np.all((bound > 0) | (diff == 0))
    return float(np.max(np.where(bound > 0, diff / np.where(bound > 0, bound,
                                                             1), 0)))


def _ref_einsum(eq, a, b):
    """The reference's jitted `einsum32(eq, a, b)` (as numpy); where
    XLA:CPU has no kernel for the dot it forms (module docstring), one
    slice of a's leading dimension at a time (of b's too when they share
    the label), the slices' results joined on the output's matching
    dimension."""
    f = jax.jit(lambda x, y: ref_layers.einsum32(eq, x, y))
    try:
        return np.asarray(f(a, b))
    except jax.errors.JaxRuntimeError as e:
        assert "DotThunk" in str(e), e
    lhs, out = eq.split("->")
    first, second = lhs.split(",")
    if first.startswith("..."):     # a leading ellipsis dimension
        return np.stack([np.asarray(f(a[i], b)) for i in range(a.shape[0])])
    lead = first[0]
    assert second.startswith(lead)
    return np.concatenate([np.asarray(f(a[i:i + 1], b[i:i + 1]))
                           for i in range(a.shape[0])], out.index(lead))


@pytest.mark.parametrize("eq", list(EQS))
def test_einsum32_bf16_mode_matches_reference(eq):
    a, b = _operands(EQS[eq], seed=len(eq))
    ref_layers.set_exec_safe(False)
    want = _ref_einsum(eq, _ref(a), _ref(b))
    layers.set_exec_safe(False)
    before = dict(layers.PRODUCTS)
    got = layers.einsum32(eq, a, b)
    # on the CPU both modes take the plain version: f32 operands
    assert layers.PRODUCTS["f32"] == before["f32"] + 1
    assert layers.PRODUCTS["bf16"] == before["bf16"]
    assert got.dtype == torch.float32 and want.dtype == np.float32
    abs_sum = torch.einsum(eq, a.float().abs().double(),
                           b.float().abs().double()).numpy()
    k = _contraction(eq, EQS[eq])
    assert _within_bound(got.numpy(), want, abs_sum, k) <= 1.0


def test_matmul32_bf16_mode_matches_reference():
    a, b = _operands(MATMUL, seed=1)
    ref_layers.set_exec_safe(False)
    want = jax.jit(ref_layers.matmul32)(_ref(a), _ref(b))
    layers.set_exec_safe(False)
    got = layers.matmul32(a, b)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    abs_sum = (a.float().abs().double() @ b.float().abs().double()).numpy()
    assert _within_bound(got.numpy(), np.asarray(want), abs_sum,
                         MATMUL[1][0]) <= 1.0


def _upcast(x, y):
    """The f32 product of the upcast operands (the lowering's product on
    the CPU)."""
    return torch.matmul(x.float(), y.float())


@pytest.mark.parametrize("eq", list(EQS))
def test_lowering_equals_einsum_of_f32_operands(eq):
    a, b = _operands(EQS[eq], seed=len(eq) + 1)
    got = layers.lowered_einsum(eq, a, b, product=_upcast)
    want = torch.einsum(eq, a.float(), b.float())
    assert got.dtype == torch.float32 and torch.equal(got, want)
    # f32 operands through the same lowering
    assert torch.equal(layers.lowered_einsum(eq, a.float(), b.float(),
                                             product=torch.matmul), want)


@pytest.mark.parametrize("eq", list(EQS))
def test_card_product_through_the_lowering_on_meta(eq):
    """The bf16 route as the card runs it (`bf16_product`: the library's
    f32-result product), on meta tensors: the output's shape and f32
    dtype, and bf16 gradients of the operands' shapes."""
    a, b = (torch.empty(s, dtype=torch.bfloat16, device="meta",
                        requires_grad=True) for s in EQS[eq])
    out = layers.lowered_einsum(eq, a, b)
    want = torch.einsum(eq, torch.empty(EQS[eq][0], device="meta"),
                        torch.empty(EQS[eq][1], device="meta"))
    assert out.dtype == torch.float32 and out.shape == want.shape
    ga, gb = torch.autograd.grad(out, (a, b), torch.ones_like(out))
    assert (ga.dtype, gb.dtype) == (torch.bfloat16, torch.bfloat16)
    assert ga.shape == a.shape and gb.shape == b.shape


def test_meta_and_cpu_take_the_plain_version():
    """On the CPU both modes multiply f32 operands: counted under "f32"
    and equal to the exec-safe product bit for bit. Meta tensors (the
    dry-run's) take the mode's route: f32 operands in exec-safe mode, the
    bf16 route (counted under "bf16") in bf16 mode, an f32 result of the
    einsum's shape either way."""
    eq = "bsd,dhk->bshk"
    a, b = _operands(EQS[eq], seed=3)
    want = torch.einsum(eq, a.float(), b.float())
    for safe in (True, False):
        layers.set_exec_safe(safe)
        before = dict(layers.PRODUCTS)
        got = layers.einsum32(eq, a, b)
        mm = layers.matmul32(a.reshape(-1, D), b.reshape(D, -1))
        assert layers.PRODUCTS == {"bf16": before["bf16"],
                                   "f32": before["f32"] + 2,
                                   "f32_lowered": before["f32_lowered"]}
        assert torch.equal(got, want)
        assert torch.equal(mm, a.reshape(-1, D).float()
                           @ b.reshape(D, -1).float())
        meta = layers.einsum32(eq, a.to("meta"), b.to("meta"))
        route = "f32" if safe else "bf16"
        assert layers.PRODUCTS[route] == before[route] + (1 + 2 * safe)
        assert meta.dtype == torch.float32 and meta.device.type == "meta"
        assert meta.shape == want.shape


@pytest.mark.parametrize("eq,shape_a,shape_b", [
    ("bsd,dhk,hkm->bsm", (2, 3, 4), (4, 2, 5)),     # three operands
    ("bsd,dhk", (2, 3, 4), (4, 2, 5)),              # no explicit output
    ("bii,bi->bi", (2, 3, 3), (2, 3)),              # a repeated label
    ("bsd,dc->bs", (2, 3, 4), (4, 5)),              # c summed alone
    ("bsd,dhk->bshkx", (2, 3, 4), (4, 2, 5)),       # x in no operand
    ("bsD,Dhk->bshk", (2, 3, 4), (4, 2, 5)),        # upper-case labels
    ("...ab,...bc->...ac", (2, 3, 4), (1, 4, 5)),   # broadcasting
])
def test_lowering_refuses_what_it_cannot_take(eq, shape_a, shape_b):
    with pytest.raises(ValueError):
        layers._Plan(eq, shape_a, shape_b)


def _grads(fn, a, b, remat, seed):
    a = a.detach().clone().requires_grad_()
    b = b.detach().clone().requires_grad_()
    out = checkpoint(fn, a, b, use_reentrant=False) if remat else fn(a, b)
    ct = _operands([tuple(out.shape)], seed)[0]
    (out.float() * ct.float()).sum().backward()
    return out, a.grad, b.grad


def _exec_safe(eq, x, y):
    """The exec-safe product: `torch.matmul` for matmul32, else
    `torch.einsum`, of the upcast operands."""
    if eq == MATMUL_EQ:
        return torch.matmul(x.float(), y.float())
    return torch.einsum(eq, x.float(), y.float())


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("eq", list(GRAD_EQS))
def test_product_gradients_equal_exec_safe_autograd(eq, remat):
    a, b = _operands(GRAD_EQS[eq], seed=len(eq) + 2)
    got = _grads(lambda x, y: layers.lowered_einsum(
        eq, x, y, product=_upcast).to(torch.bfloat16), a, b, remat, 5)
    want = _grads(lambda x, y: _exec_safe(eq, x, y).to(torch.bfloat16),
                  a, b, remat, 5)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.bfloat16 and torch.equal(g, w)


class _GemmFlags(TorchDispatchMode):
    """cuBLAS's bf16 reduced-precision flag as each GEMM saw it."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.bmm):
            self.seen.append(torch.backends.cuda.matmul
                             .allow_bf16_reduced_precision_reduction)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat", [False, True])
def test_matmul16_reduces_in_f32_forward_and_backward(remat):
    """`layers._Matmul16`, the card's form of the plain bf16-result
    products (rwkv's `x @ w`, DeepSeek's MTP projection): every GEMM of its
    forward, recompute and backward runs with cuBLAS's bf16
    reduced-precision reduction off, the flag is restored after, and
    output and gradients equal `a @ b`'s autograd bit for bit (run here on
    the CPU, where the flag changes nothing)."""
    a, b = _operands(MATMUL, seed=9)
    flags = torch.backends.cuda.matmul
    assert flags.allow_bf16_reduced_precision_reduction
    rec = _GemmFlags()
    with rec:
        got = _grads(layers._Matmul16.apply, a, b, remat, 8)
    want = _grads(lambda x, y: x @ y, a, b, remat, 8)
    # forward (and its recompute), then a's and b's gradients
    assert rec.seen == [False] * (4 if remat else 3)
    assert flags.allow_bf16_reduced_precision_reduction
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.bfloat16 and torch.equal(g, w)
    assert torch.equal(layers.matmul16(a, b), a @ b)   # the CPU: a @ b


_CASES = {}


def _case(arch):
    """The reference's reduced params and pipeline batch, its STRICT-jitted
    forward logits and value_and_grad in bf16 mode (compiled once a
    file), and the port's model carrying the params."""
    if arch not in _CASES:
        prev = ref_layers._EXEC_SAFE
        ref_layers.set_exec_safe(False)
        try:
            rcfg = ref_reduced(ref_get_config(arch))
            key = jax.random.key(0)
            params = jax.jit(RM.init_params, static_argnums=1).lower(
                key, rcfg).compile({"xla_backend_optimization_level": 0})(
                    key)
            batch = SyntheticTokenSource(rcfg, SHAPE, seed=0).batch_at(0)

            def vg(p, b):
                (loss, out), grads = jax.value_and_grad(
                    lambda p_: RM.lm_loss(p_, rcfg, b), has_aux=True)(p)
                return loss, out["logits"], grads
            loss, logits, grads = jax.jit(vg).lower(params, batch).compile(
                STRICT)(params, batch)
        finally:
            ref_layers.set_exec_safe(prev)
        pcfg = reduced(get_config(arch))
        model = params_from_reference(jax.tree.map(np.asarray, params), pcfg,
                                      "cpu")
        f32 = jax.tree.map(lambda g: np.asarray(jnp.asarray(g, jnp.float32)),
                           grads)
        _CASES[arch] = (pcfg, model, batch, float(loss), f32,
                        np.asarray(jnp.asarray(logits, jnp.float32)))
    return _CASES[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_models_in_bf16_mode_match_reference(arch):
    pcfg, model, batch, ref_loss, ref_grads, ref_logits = _case(arch)
    layers.set_exec_safe(False)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    model.requires_grad_(True)
    model.zero_grad(set_to_none=True)
    try:
        loss, out = PM.lm_loss(model, pcfg, tb, remat=True)
        logits = out["logits"].detach().float().numpy()
        assert float(np.abs(logits - ref_logits).max()) <= LOGIT_ATOL
        loss.backward()
        assert abs(float(loss.detach()) - ref_loss) <= LOSS_ATOL
        tol = GRAD_TOL_BY_ARCH.get(arch, GRAD_TOL)
        for name, p in model.named_parameters():
            path, index = reference_leaf(name, pcfg)
            want = ref_grads
            for k in path:
                want = want[k]
            want = want[index]
            got = (p.grad.float().numpy() if p.grad is not None
                   else np.zeros(want.shape, np.float32))
            scale = float(np.abs(want).max())
            err = float(np.abs(got - want).max())
            assert np.isfinite(got).all(), name
            assert err <= tol * scale or (scale == 0 and err == 0), \
                (name, err, scale)
    finally:
        model.zero_grad(set_to_none=True)
        model.requires_grad_(False)


class _Seen:
    """Stand-ins for the trainer and the server that record the product
    mode at the point the launcher hands them the model."""

    modes = []

    def __init__(self, *a, **kw):
        _Seen.modes.append(layers._EXEC_SAFE)
        self.start_step = 0

    def run(self):
        return {"final_step": 1, "losses": [1.0], "straggler_steps": []}

    def generate(self, requests):
        return {"tokens": 0, "ttft_s": 0.0, "decode_s_per_tok": 0.0}


@pytest.mark.parametrize("reduced_flag", [True, False])
def test_launchers_follow_reduced(monkeypatch, reduced_flag, tmp_path):
    """`--reduced` turns exec-safe on (the reference's `set_exec_safe(True)`
    in both launchers); the published config keeps bf16 mode. The trainer,
    the server and the model build are stand-ins, so the published config
    is never built here."""
    import repro_torch.models as models_pkg
    import repro_torch.train.serve as serve_mod
    import repro_torch.train.trainer as trainer_mod
    monkeypatch.setattr(trainer_mod, "Trainer", _Seen)
    monkeypatch.setattr(serve_mod, "Server", _Seen)
    monkeypatch.setattr(models_pkg, "init_params", lambda *a, **kw: None)
    flag = ["--reduced"] if reduced_flag else []
    _Seen.modes = []
    layers.set_exec_safe(False)
    launch_train.main(["--arch", "qwen2.5-3b", *flag, "--steps", "1",
                       "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    layers.set_exec_safe(False)
    launch_serve.main(["tokens", "--arch", "qwen2.5-3b", *flag,
                       "--device", "cpu"])
    # one entry a launcher: the trainer's and the server's construction
    assert _Seen.modes == [reduced_flag] * 2
