"""The port's LM kernels, held against the Pallas kernels they replace.

`ddot_gemm_quantized` (photonic 4-bit GEMM) and `flash_attention_bhsd`
(fused attention): the port's wrappers are given CPU tensors, so they run
the kernels' plain PyTorch versions, and the reference runs on the same
numpy inputs, made from seeds, in interpret mode (the Pallas kernels) or
through its public wrappers.

Tolerances:
  * ddot: exact (`np.array_equal`). The products of 4-bit integers sum to
    exact integers in float32 whatever the order, and the epilogue is the
    reference's float32 order. The noise path compares the raw kernel with
    an explicit `z` (the draws of a torch.Generator are not jax.random's);
    its reference is compiled with XLA's algebraic simplifier off and LLVM
    at -O0 (`STRICT`), since XLA's default CPU pipeline contracts the
    epilogue's multiply-add into an FMA.
  * flash attention: the reference's own, rtol = atol = 2e-5 in float32 and
    2e-2 in bfloat16 (`tests/test_flash_attention.py`): exponentials and
    summation order differ between XLA and PyTorch.
  * photonic_matmul's STE gradients: 1e-4, as the reference's test.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ddot_matmul as ref_ddot_matmul
from repro.kernels.ops import flash_attention as ref_flash_attention
from repro.kernels import quantize4 as ref_quantize4
from repro.kernels.ddot_gemm import ddot_gemm_quantized as ref_ddot_gemm
from repro.kernels.flash_attention import flash_attention_bhsd as ref_flash
from repro_torch.kernels import ddot_gemm as pddot
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention_bhsd

# the module (the package attribute of the same name is the function)
pfa = importlib.import_module("repro_torch.kernels.flash_attention")

STRICT = {"xla_disable_hlo_passes": "algsimp",
          "xla_backend_optimization_level": 0}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _both(x, dtype):
    """The same values as a jax array and a CPU tensor of `dtype`."""
    jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(x, jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------- ddot ---

SHAPES = [
    (8, 16, 8),        # tiny
    (128, 128, 128),   # exactly one block
    (100, 200, 60),    # nothing divides the blocks
    (256, 512, 384),   # multiple blocks each axis
    (33, 1000, 257),   # prime-ish
]


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ddot_matmul_equals_the_reference(m, k, n, dtype):
    ja, ta = _both(_normal((m, k), 1), dtype)
    jb, tb = _both(_normal((k, n), 2), dtype)
    want = np.asarray(ref_ddot_matmul(ja, jb, bm=64, bn=128, bk=128))
    got = ops.ddot_matmul(ta, tb)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(ref.ddot_matmul_ref(ta, tb).numpy(), want)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize4_equals_the_reference(axis, dtype):
    x = _normal((37, 53), 3)
    x[5] = 0.0                 # an all-zero row: scale 1
    x[:, 7] = 0.0              # an all-zero column
    jx, tx = _both(x, dtype)
    q_ref, s_ref = ref_quantize4(jx, axis=axis)
    q, s = ref.quantize4(tx, axis=axis)
    assert np.array_equal(q.numpy(), np.asarray(q_ref))
    assert np.array_equal(s.numpy(), np.asarray(s_ref))
    assert float(q.abs().max()) <= ref.QMAX


@pytest.mark.parametrize("m,k,n", [(64, 256, 128), (33, 1000, 257)])
def test_ddot_gemm_noise_equals_the_reference_with_the_same_draws(m, k, n):
    a, b = _normal((m, k), 3), _normal((k, n), 4)
    z = _normal((m, n), 5)
    qa, sa = ref_quantize4(jnp.asarray(a), axis=1)
    qb, sb = ref_quantize4(jnp.asarray(b), axis=0)
    pad_m, pad_n, pad_k = (-m) % 64, (-n) % 128, (-k) % 128

    def pad(x, p0, p1):
        return jnp.pad(x, ((0, p0), (0, p1)))

    args = [pad(qa.astype(jnp.bfloat16), pad_m, pad_k),
            pad(qb.astype(jnp.bfloat16), pad_k, pad_n),
            pad(sa, pad_m, 0), pad(sb, 0, pad_n), pad(jnp.asarray(z), pad_m,
                                                      pad_n)]
    fn = functools.partial(ref_ddot_gemm, bm=64, bn=128, bk=128,
                           noise_rms=0.1, interpret=True)
    want = np.asarray(jax.jit(fn).lower(*args).compile(STRICT)(*args))[:m, :n]

    def t(x):
        return torch.from_numpy(np.array(x))

    got = pddot.ddot_gemm_quantized(t(qa).to(torch.int8), t(qb).to(torch.int8),
                                    t(sa), t(sb), t(z), noise_rms=0.1)
    assert np.array_equal(got.numpy(), want)
    got_ref = ref.ddot_matmul_ref(t(a), t(b), noise_rms=0.1, z=t(z))
    assert np.array_equal(got_ref.numpy(), want)


def test_ddot_gemm_rejects_k_past_the_exact_limit():
    k = pddot.K_MAX + 1
    assert 49 * pddot.K_MAX < 2 ** 24 <= 49 * k
    qa = torch.zeros((1, k), dtype=torch.int8)
    qb = torch.zeros((k, 1), dtype=torch.int8)
    one = torch.ones((1, 1))
    with pytest.raises(ValueError, match="exceeds"):
        pddot.ddot_gemm_quantized(qa, qb, one, one)
    out = pddot.ddot_gemm_quantized(qa[:, :-1], qb[:-1], one, one)
    assert out.shape == (1, 1) and float(out[0, 0]) == 0.0


def test_ddot_gemm_needs_z_for_noise():
    q = torch.ones((2, 2), dtype=torch.int8)
    one = torch.ones((2, 1))
    with pytest.raises(ValueError, match="needs z"):
        pddot.ddot_gemm_quantized(q, q, one, one.T, noise_rms=0.1)
    with pytest.raises(ValueError, match="Generator"):
        ops.ddot_matmul(torch.ones((2, 2)), torch.ones((2, 2)), noise_rms=0.1)


def test_ddot_quantization_error_bounded():
    a = torch.from_numpy(_normal((128, 512), 6))
    b = torch.from_numpy(_normal((512, 128), 7))
    out = ops.ddot_matmul(a, b)
    rel = torch.linalg.norm(out - a @ b) / torch.linalg.norm(a @ b)
    assert float(rel) < 0.25


def test_photonic_matmul_ste_gradients():
    a = torch.from_numpy(_normal((32, 64), 8)).requires_grad_()
    b = torch.from_numpy(_normal((64, 16), 9)).requires_grad_()
    out = ops.photonic_matmul(a, b)
    (out ** 2).sum().backward()
    out = out.detach()
    np.testing.assert_allclose(a.grad.numpy(), (2 * out @ b.detach().T).numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(b.grad.numpy(), (2 * a.detach().T @ out).numpy(),
                               rtol=1e-4, atol=1e-4)
    # the forward is the reference's, exactly
    want = np.asarray(ref_ddot_matmul(jnp.asarray(a.detach().numpy()),
                                      jnp.asarray(b.detach().numpy())))
    assert np.array_equal(out.numpy(), want)


def test_photonic_matmul_noise_is_seeded_by_key_data():
    a = torch.from_numpy(_normal((16, 64), 10))
    b = torch.from_numpy(_normal((64, 24), 11))
    one = ops.photonic_matmul(a, b, 0.05, key_data=7)
    assert torch.equal(one, ops.photonic_matmul(a, b, 0.05, key_data=7))
    assert not torch.equal(one, ops.photonic_matmul(a, b, 0.05, key_data=8))
    clean = ops.photonic_matmul(a, b)
    assert 0.0 < float((one - clean).abs().max()) < float(clean.abs().max())


# ----------------------------------------------------- flash attention ---

@pytest.mark.parametrize("s,d,bq,bk", [
    (128, 64, 128, 128),     # single block
    (256, 64, 128, 128),     # multi-block, diagonal skipping
    (384, 128, 128, 128),    # 3 blocks, wider head
    (256, 64, 64, 32),       # uneven block shapes
    (128, 80, 64, 64),       # h2o-danube's head dim, not a power of two
    (64, 256, 32, 32),       # gemma3's head dim
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas(s, d, bq, bk, causal):
    q, k, v = (_normal((4, s, d), seed) for seed in (1, 2, 3))
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, bq=bq, bk=bk)
    got = flash_attention_bhsd(*(torch.from_numpy(x) for x in (q, k, v)),
                                   causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_dtypes(dtype):
    (jq, tq), (jk, tk), (jv, tv) = (_both(_normal((2, 128, 64), s), dtype)
                                    for s in (4, 5, 6))
    want = ref_flash(jq, jk, jv, causal=True)
    got = flash_attention_bhsd(tq, tk, tv, causal=True)
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("b,s,hq,hkv,d,bq,bk", [
    (2, 100, 8, 2, 64, 64, 64),      # the reference's GQA + padding case
    (1, 70, 16, 2, 128, 128, 128),   # qwen2.5-3b's heads, one ragged block
    (1, 40, 32, 8, 80, 16, 16),      # h2o-danube's heads
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_wrapper_gqa_and_padding(b, s, hq, hkv, d, bq, bk, dtype):
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_normal(shape, seed), dtype)
        for shape, seed in (((b, s, hq, d), 7), ((b, s, hkv, d), 8),
                            ((b, s, hkv, d), 9)))
    want = ref_flash_attention(jq, jk, jv, causal=True, bq=bq, bk=bk)
    got = ops.flash_attention(tq, tk, tv, causal=True, bq=bq, bk=bk)
    assert got.shape == (b, s, hq, d)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_flash_wrapper_bidirectional_full_blocks():
    q, k, v = (torch.from_numpy(_normal((1, 128, 4, 64), s)) for s in (1, 2, 3))
    want = ref_flash_attention(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                               causal=False, bq=64, bk=64)
    got = ops.flash_attention(q, k, v, causal=False, bq=64, bk=64)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_flash_bidirectional_padding_guard():
    q = torch.from_numpy(_normal((1, 100, 4, 64), 0))
    with pytest.raises(ValueError, match="bidirectional"):
        ops.flash_attention(q, q, q, causal=False, bq=64, bk=64)
    with pytest.raises(ValueError):
        ref_flash_attention(jnp.asarray(q.numpy()), jnp.asarray(q.numpy()),
                            jnp.asarray(q.numpy()), causal=False, bq=64, bk=64)


def test_flash_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((2, 8, 257))
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bhsd(x, x, x)
    q = torch.zeros((1, 8, 6, 64))
    with pytest.raises(ValueError, match="groups"):
        ops.flash_attention(q, q[:, :, :4], q[:, :, :4])


# ------------------------------------- the tensor-core kernels' design ---

def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def _wgmma_attention(q, k, v, *, causal, group):
    """Plain emulation of the tensor-core attention kernel's arithmetic
    (`csrc/flash_attention.cu`): key tiles of 128 keys (64 past D = 128,
    its `KeyTile`), f32 scores `(q . k) * scale`, f32 running max,
    correction and denominator (summed from the f32 weights), the weights
    rounded to bf16 before P . V, f32 accumulation, `acc / max(l, 1e-30)`
    rounded to bf16. q, k, v are float32 tensors holding bf16 values."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    k = k.repeat_interleave(group, dim=0)
    v = v.repeat_interleave(group, dim=0)
    scale = torch.tensor(np.float32(d ** -0.5))
    m = torch.full((bh, sq, 1), ref.NEG_INF)
    den = torch.zeros((bh, sq, 1))
    acc = torch.zeros((bh, sq, d))
    rows = torch.arange(sq)[:, None]
    bk = 64 if d > 128 else 128
    for k0 in range(0, skv, bk):
        kt, vt = k[:, k0:k0 + bk], v[:, k0:k0 + bk]
        s = torch.einsum("bqd,bkd->bqk", q, kt) * scale
        if causal:
            keys = k0 + torch.arange(kt.shape[1])[None, :]
            s = torch.where(keys <= rows, s, torch.full_like(s, ref.NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        den = den * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.einsum("bqk,bkd->bqd", _bf16(p), vt)
        m = m_new
    return _bf16(acc / torch.clamp(den, min=1e-30))


@pytest.mark.parametrize("d", [80, 128, 256])
@pytest.mark.parametrize("group", [1, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_p_stays_inside_the_reference_tolerance(d, group, causal):
    """The tensor-core kernel's one extra rounding (P to bf16 before P . V,
    ~2**-9 relative on each weight) keeps it within the reference's own
    bf16 tolerance of 2e-2: its emulation against the Pallas kernel."""
    bh, s = 8, 256
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_normal(shape, seed), "bfloat16")
        for shape, seed in (((bh, s, d), 21), ((bh // group, s, d), 22),
                            ((bh // group, s, d), 23)))
    want = ref_flash(jq, jnp.repeat(jk, group, axis=0),
                     jnp.repeat(jv, group, axis=0), causal=causal)
    got = _wgmma_attention(tq.float(), tk.float(), tv.float(), causal=causal,
                           group=group)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL["bfloat16"],
                               atol=TOL["bfloat16"])


@pytest.mark.parametrize("d", [8, 32, 36, 56, 64, 80, 100, 112, 128, 200,
                               256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_path_follows_dtype_and_head_dim(d, dtype):
    want = dtype == "bfloat16" and d % 8 == 0
    assert pfa.wgmma_path(DTYPES[dtype][1], d) is want
    assert set(pfa.LAUNCHES) == {"flash_attention_bhsd",
                                "flash_attention_bhsd_tf32"}


def test_every_configs_head_dim_takes_the_tensor_core_path():
    from repro_torch.configs import ARCHS
    dims = {c.resolved_head_dim for c in ARCHS.values()}
    assert dims >= {64, 80, 112, 128, 256}
    assert all(pfa.wgmma_path(torch.bfloat16, d) for d in dims)


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("layout", ["row_major", "k_major_view"])
def test_ddot_gemm_takes_b_in_both_layouts(m, k, n, layout):
    """The kernel reads B K-major: the wrapper passes the transpose of a
    transposed view without a copy and copies a row-major B. Either way
    the result is the reference's, exactly."""
    a, b = _normal((m, k), 12), _normal((k, n), 13)
    want = np.asarray(ref_ddot_matmul(jnp.asarray(a), jnp.asarray(b)))
    tb = (torch.from_numpy(np.ascontiguousarray(b.T)).T
          if layout == "k_major_view" else torch.from_numpy(b))
    qa, sa = ref.quantize4(torch.from_numpy(a), axis=1)
    qb, sb = ref.quantize4(tb, axis=0)
    qb = qb.to(torch.int8)
    assert qb.is_contiguous() is (layout == "row_major")
    qbt = pddot.k_major(qb)
    assert qbt.is_contiguous() and torch.equal(qbt, qb.T)
    assert (qbt.data_ptr() == qb.data_ptr()) is (layout == "k_major_view")
    got = pddot.ddot_gemm_quantized(qa.to(torch.int8).contiguous(), qb, sa,
                                    sb)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(ops.ddot_matmul(torch.from_numpy(a), tb).numpy(),
                          want)


# ------------------------------------------ the TF32 kernel's design ---

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the float bits: round to nearest, ties away from
    zero, keeping 10 mantissa bits (the low 13 bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_mm(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b on TF32 operands: one pass (hi . hi), or 3xTF32 with
    x = hi + lo, lo = tf32(x - hi), summing a_lo b_hi + a_hi b_lo + a_hi b_hi
    small terms first, as `csrc/flash_attention_tf32.cu`'s mma3."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _tf32_attention(q, k, v, *, causal, group, passes=3, splits=1):
    """Plain emulation of the TF32 attention kernel's arithmetic
    (`csrc/flash_attention_tf32.cu`): 64-row query blocks, key tiles of
    32 keys split into `splits` contiguous runs per block
    (the causal tile limit first), TF32 products in `passes` passes, f32
    online softmax per run from m = -1e30, the runs merged by
    l = sum l_s e^(m_s - m), acc likewise, out = acc / max(l, 1e-30).
    q, k, v are float32 tensors."""
    bh, sq, d = q.shape
    skv = k.shape[1]
    k = k.repeat_interleave(group, dim=0)
    v = v.repeat_interleave(group, dim=0)
    scale = torch.tensor(np.float32(d ** -0.5))
    bq, bk = pfa.TF32_BLOCK_Q, pfa.TF32_BLOCK_K
    out = torch.empty_like(q)
    for q0 in range(0, sq, bq):
        qt = q[:, q0:q0 + bq]
        rows = q0 + torch.arange(qt.shape[1])[:, None]
        n_tiles = -(-skv // bk)
        if causal:
            n_tiles = min(n_tiles, (q0 + bq - 1) // bk + 1)
        per = -(-n_tiles // splits)
        parts = []
        for s in range(splits):
            t0, t1 = s * per, min(n_tiles, (s + 1) * per)
            if t0 >= t1:
                continue
            m = torch.full((bh, qt.shape[1], 1), ref.NEG_INF)
            den = torch.zeros((bh, qt.shape[1], 1))
            acc = torch.zeros((bh, qt.shape[1], d))
            for t in range(t0, t1):
                kt, vt = k[:, t * bk:(t + 1) * bk], v[:, t * bk:(t + 1) * bk]
                sc = _tf32_mm(qt, kt.transpose(1, 2), passes) * scale
                if causal:
                    keys = t * bk + torch.arange(kt.shape[1])[None, :]
                    sc = torch.where(keys <= rows, sc,
                                     torch.full_like(sc, ref.NEG_INF))
                m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                p = torch.exp(sc - m_new)
                corr = torch.exp(m - m_new)
                den = den * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + _tf32_mm(p, vt, passes)
                m = m_new
            parts.append((m, den, acc))
        m = torch.stack([m_ for m_, _, _ in parts]).amax(0)
        den = sum(d_ * torch.exp(m_ - m) for m_, d_, _ in parts)
        acc = sum(a_ * torch.exp(m_ - m) for m_, _, a_ in parts)
        out[:, q0:q0 + bq] = acc / torch.clamp(den, min=1e-30)
    return out


def _f32_case(bh, s, d, group, seeds=(31, 32, 33)):
    return [_both(_normal(shape, seed), "float32")
            for shape, seed in (((bh, s, d), seeds[0]),
                                ((bh // group, s, d), seeds[1]),
                                ((bh // group, s, d), seeds[2]))]


def test_tf32_rounding_is_cvt_rna():
    one = 1.0 + 2.0 ** -11          # half a TF32 ulp above 1: ties away
    below = 1.0 + 2.0 ** -11 - 2.0 ** -23
    x = torch.tensor([one, -one, below, 3.0, 0.0], dtype=torch.float32)
    want = [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0, 0.0]
    assert _tf32(x).tolist() == want
    y = torch.from_numpy(_normal((1000,), 41))
    hi = _tf32(y)
    assert torch.all((hi.view(torch.int32) & 0x1fff) == 0)
    assert float(((y - hi).abs() / y.abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("d", [80, 128, 256])
@pytest.mark.parametrize("group", [1, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_tf32x3_stays_inside_the_f32_tolerance(d, group, causal):
    """The TF32 kernel's arithmetic (3xTF32 products, and the key splits
    and merge it takes on a 132-SM card at this shape, or one split)
    against the Pallas kernel in f32: within the reference's 2e-5."""
    bh, s = 8, 256
    (jq, tq), (jk, tk), (jv, tv) = _f32_case(bh, s, d, group)
    want = _np(ref_flash(jq, jnp.repeat(jk, group, axis=0),
                         jnp.repeat(jv, group, axis=0), causal=causal))
    splits = pfa.tf32_splits(bh, s, s, d, 132)
    assert splits > 1
    for n in (splits, 1):
        got = _tf32_attention(tq, tk, tv, causal=causal, group=group,
                              splits=n)
        np.testing.assert_allclose(_np(got), want, rtol=TOL["float32"],
                                   atol=TOL["float32"])


@pytest.mark.parametrize("d", [80, 128, 256])
def test_one_tf32_pass_misses_the_f32_tolerance(d):
    """Why the kernel splits its f32 operands: one TF32 pass (10 mantissa
    bits per operand) misses 2e-5 on the same inputs."""
    bh, s, group = 8, 256, 1
    (jq, tq), (jk, tk), (jv, tv) = _f32_case(bh, s, d, group)
    want = _np(ref_flash(jq, jk, jv, causal=True))
    one = _np(_tf32_attention(tq, tk, tv, causal=True, group=group,
                              passes=1))
    three = _np(_tf32_attention(tq, tk, tv, causal=True, group=group))
    err1 = np.abs(one - want).max()
    err3 = np.abs(three - want).max()
    assert err1 > 10 * TOL["float32"] and err3 < TOL["float32"] < err1


def test_bf16_odd_head_dim_takes_one_tf32_pass():
    """bf16 operands are exact in TF32: the kernel's one pass (P rounded to
    TF32) at a head dim the wgmma kernel does not take, within 2e-2."""
    bh, s, d, group = 8, 200, 36, 4
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(_normal(shape, seed), "bfloat16")
        for shape, seed in (((bh, s, d), 34), ((bh // group, s, d), 35),
                            ((bh // group, s, d), 36)))
    assert not pfa.wgmma_path(torch.bfloat16, d)
    assert torch.equal(_tf32(tq.float()), tq.float())
    want = ref_flash(jq, jnp.repeat(jk, group, axis=0),
                     jnp.repeat(jv, group, axis=0), causal=True, bq=40,
                     bk=40)
    splits = pfa.tf32_splits(bh, s, s, d, 132)
    got = _tf32_attention(tq.float(), tk.float(), tv.float(), causal=True,
                          group=group, passes=1, splits=splits)
    np.testing.assert_allclose(_np(got.bfloat16()), _np(want),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


@pytest.mark.parametrize("bh,sq,skv,d,n_sm,want", [
    (4, 256, 256, 128, 132, 8),       # 16 blocks, 8 key tiles: one a tile
    (8, 200, 200, 80, 132, 7),        # 32 blocks: 8 would fit, 7 tiles
    (8, 200, 200, 256, 132, 4),       # past D 128 one CTA an SM: 132 // 32
    (16, 512, 512, 128, 132, 2),      # 128 blocks, two CTAs an SM
    (16, 512, 512, 256, 132, 1),      # one CTA an SM: one wave already
    (1, 64, 4096, 64, 132, 64),       # one block: at most 64 splits
    (64, 4096, 4096, 128, 132, 1),    # many waves
    (2, 40, 40, 64, 132, 2),          # fewer key tiles than CTAs allow
])
def test_tf32_splits_fill_the_resident_ctas(bh, sq, skv, d, n_sm, want):
    splits = pfa.tf32_splits(bh, sq, skv, d, n_sm)
    blocks = bh * -(-sq // pfa.TF32_BLOCK_Q)
    assert splits == want
    assert 1 <= splits <= -(-skv // pfa.TF32_BLOCK_K)
    assert splits == 1 or blocks * splits <= (2 if d <= 128 else 1) * n_sm
