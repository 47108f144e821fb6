"""Common transformer layers (the port of `repro/models/layers.py`): RMSNorm,
RoPE, GQA attention (global or sliding window, optional softcap and bias,
bidirectional for the encoder), the gated MLP, embeddings, the
cross-entropy loss.

Parameters live in `nn.Module`s with the reference's names and layouts
(`wq` is (d, H, Dh), `wo` (H, Dh, d), ...), so that a reference pytree
carries across leaf for leaf (`interop.params_from_reference`); the
compute is plain functions on tensors, as in the reference. Mixed
precision follows the reference: parameters and activations bf16; norms,
softmax and RoPE in f32; every product casts its operands to f32 and
multiplies in f32 (`matmul32` / `einsum32`, the reference's exec-safe
path, which equals its bf16 x bf16 -> f32 TPU path up to summation order),
then casts back to the activation dtype. TF32 must stay off for that
(`torch.backends.cuda.matmul.allow_tf32` False, float32 matmul precision
"highest", PyTorch's defaults).

Sharding goes through `rules` (`parallel.sharding.Rules`; `NULL_RULES`, the
default, makes every `shard()` the identity) at the reference's places;
`attention_specs` and `mlp_specs` give the parameters' specs. The GSPMD
layout knobs `set_gqa_mode` and `set_xent_mode` have no counterpart:
attention is the default "grouped" GQA evaluation and `softmax_xent` the
default "gather" form.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..parallel.sharding import NULL_RULES, move_shards, shard, unshard

DTYPE = torch.bfloat16
NEG_INF = -1e30


def set_exec_safe(v: bool) -> None:
    """The reference's switch between its exec-safe products (operands cast
    to f32) and bf16 x bf16 -> f32 ones. The port's products are always
    the exec-safe f32 ones: True changes nothing, and the bf16 path is
    ROADMAP item 21."""
    if not v:
        raise NotImplementedError(
            "bf16 x bf16 -> f32 products are not in the port (ROADMAP item "
            "21); its products are always the exec-safe f32 ones")


def einsum32(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """einsum with f32 operands and f32 result."""
    return torch.einsum(eq, *(o.float() for o in ops))


def matmul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float())


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with f32 accumulation, output in x.dtype."""
    return matmul32(x, w).to(x.dtype)


# A trace that charges a loop's body once, times its trip count, sets this
# to a context-manager factory `hook(n)` (`analysis.op_cost.Tracer`).
_SCAN_HOOK: contextvars.ContextVar = contextvars.ContextVar("scan_hook",
                                                            default=None)


@contextlib.contextmanager
def scan_hook(hook):
    """Run `scan` loops under `hook` while the context is open."""
    token = _SCAN_HOOK.set(hook)
    try:
        yield
    finally:
        _SCAN_HOOK.reset(token)


def scan(step, carry, n: int, dim: int = 0):
    """`jax.lax.scan` as a Python loop: `step(carry, t) -> (carry, y)` for
    t in range(n); returns (the last carry, the ys stacked on `dim`). Under
    a `scan_hook` (the dry-run's trace) the body runs once, inside
    `hook(n)`, which charges its cost n times, and its y stands for every
    step's (same shape and layout, a copy of the one step's)."""
    hook = _SCAN_HOOK.get()
    if hook is None or n <= 1:
        ys = []
        for t in range(n):
            carry, y = step(carry, t)
            ys.append(y)
        return carry, torch.stack(ys, dim=dim)
    with hook(n):
        carry, y = step(carry, 0)
    y = y.unsqueeze(dim)
    return carry, y.expand(*y.shape[:dim], n, *y.shape[dim + 1:]).contiguous()


@functools.lru_cache(maxsize=None)
def _f32(x: float, device) -> torch.Tensor:
    """float32(x) as a 0-d tensor on `device`: a Python scalar as JAX's weak
    type rounds it, and a tensor divisor (PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal instead). Cached: building a
    CUDA tensor from host data synchronizes with the card, once per layer
    and call otherwise. Built outside inference mode, so that a constant
    first made while serving can still be saved for a backward pass."""
    with torch.inference_mode(False):
        return torch.tensor(np.float32(x), device=device)


def _param(shape, device, dtype=DTYPE) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _normal_(p: torch.Tensor, generator: torch.Generator, scale: float):
    """The reference's `_normal`: N(0, 1) in f32, times scale, cast to bf16
    (and on to p's dtype: the MoE router keeps the bf16 draw in f32). From
    a torch.Generator: not `jax.random`'s stream. The f32 draw is scaled in
    place and a bf16 parameter takes it by `copy_` (which rounds as `.to`
    does), so a large tensor's build holds one f32 copy of it and no other
    temporary."""
    draw = torch.randn(p.shape, generator=generator, device=p.device,
                       dtype=torch.float32).mul_(scale)
    p.copy_(draw if p.dtype == DTYPE else draw.to(DTYPE))


# --------------------------------------------------------------------------
# RMSNorm
# --------------------------------------------------------------------------

class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = _param((d,), device)

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(self.scale, x, self.eps)


def rms_norm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + _f32(eps, x.device))
    return (y * scale.float()).to(x.dtype)


# --------------------------------------------------------------------------
# Rotary position embedding
# --------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, D), positions: (B, S) int."""
    d = x.shape[-1]
    half = d // 2
    dev = x.device
    expo = -torch.arange(0, half, dtype=torch.float32, device=dev) \
        / _f32(half, dev)
    freqs = torch.pow(_f32(theta, dev), expo)
    ang = positions[..., None].float() * freqs                  # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention (GQA; global or sliding-window; optional logit softcap / bias)
# --------------------------------------------------------------------------

def attn_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, window: int = 0,
              is_local: Optional[bool] = None) -> torch.Tensor:
    """(B, Sq, Skv) bool. Causal, optionally sliding-window: the window
    applies when `window > 0` and the layer is local (`is_local` True, or
    None for "every layer")."""
    causal = kv_pos[:, None, :] <= q_pos[:, :, None]
    if window <= 0 or is_local is False:
        return causal
    in_win = kv_pos[:, None, :] > (q_pos[:, :, None] - window)
    return causal & in_win


def positions_like(x: torch.Tensor) -> torch.Tensor:
    """(B, S) positions 0..S-1 of x (B, S, ...). For a DTensor x, a DTensor
    sharded like x's batch (replicated elsewhere), so that the masks and
    rope tables built from it are split over the batch, not whole on every
    device."""
    from torch.distributed.tensor import DTensor, Replicate
    b, s = x.shape[:2]
    if not isinstance(x, DTensor):
        return torch.arange(s, device=x.device).expand(b, s)
    pl = [p if p.is_shard(0) else Replicate() for p in x.placements]
    n = 1
    for size, p in zip(x.device_mesh.mesh.shape, pl):
        n *= size if p.is_shard(0) else 1
    local = torch.arange(s, device=x.to_local().device).expand(b // n, s)
    return DTensor.from_local(local, x.device_mesh, pl, run_check=False,
                              shape=torch.Size((b, s)), stride=(0, 1))


def gqa_attend(q, k, v, mask, softcap: float = 0.0):
    """q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D); mask: (B, Sq, Skv) bool.
    Grouped evaluation on the (B, S, Hkv, G, D) view (no KV copy). On
    DTensors the keys' sequence is gathered first (a sequence-sharded K/V
    would otherwise make the softmax gather the scores, S_q times
    larger)."""
    k, v = unshard(k, (1,)), unshard(v, (1,))
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = _f32(d ** -0.5, q.device)

    def probs_of(scores, m):
        if softcap > 0.0:
            cap = _f32(softcap, q.device)
            scores = cap * torch.tanh(scores / cap)
        scores = torch.where(m, scores, torch.full_like(scores, NEG_INF))
        return torch.softmax(scores, dim=-1).to(v.dtype)

    if g == 1:
        probs = probs_of(einsum32("bqhd,bkhd->bhqk", q, k) * scale,
                         mask[:, None, :, :])
        return einsum32("bhqk,bkhd->bqhd", probs, v).to(v.dtype)
    qg = _split_heads(q, hkv, g)
    probs = probs_of(einsum32("bqhgd,bkhd->bhgqk", qg, k) * scale,
                     mask[:, None, None, :, :])
    out = einsum32("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, hq, d).to(v.dtype)


def attention_specs(rules):
    return {"wq": rules.w_qkv, "wk": rules.w_qkv, "wv": rules.w_qkv,
            "wo": rules.w_out, "bq": rules.b_model, "bk": rules.replicated,
            "bv": rules.replicated}


def _split_heads(q, hkv: int, g: int):
    """(B, S, Hkv G, D) -> (B, S, Hkv, G, D). DTensor can split a sharded
    dimension only along its leading factor: a head axis sharded over more
    devices than Hkv divides into moves its sharding to the query sequence
    (then the scores stay split), or, when that does not divide either (a
    decode step), is gathered."""
    from torch.distributed.tensor import DTensor
    if isinstance(q, DTensor):
        k = 1
        for n, p in zip(q.device_mesh.mesh.shape, q.placements):
            if p.is_shard(2):
                k *= n
        if hkv % k:
            q = move_shards(q, 2, 1) if q.shape[1] % k == 0 \
                else unshard(q, (2,))
    b, sq, _, d = q.shape
    return q.reshape(b, sq, hkv, g, d)


class Attention(nn.Module):
    """GQA attention parameters: wq (d, H, Dh), wk/wv (d, Hkv, Dh),
    wo (H, Dh, d), and with `qkv_bias` bq (H, Dh), bk/bv (Hkv, Dh)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, dh = cfg.d_model, cfg.resolved_head_dim
        self.wq = _param((d, cfg.n_heads, dh), device)
        self.wk = _param((d, cfg.n_kv_heads, dh), device)
        self.wv = _param((d, cfg.n_kv_heads, dh), device)
        self.wo = _param((cfg.n_heads, dh, d), device)
        self.has_bias = bool(cfg.qkv_bias)
        if self.has_bias:
            self.bq = _param((cfg.n_heads, dh), device)
            self.bk = _param((cfg.n_kv_heads, dh), device)
            self.bv = _param((cfg.n_kv_heads, dh), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        d, h, dh = self.wq.shape
        with torch.no_grad():
            _normal_(self.wq, generator, d ** -0.5)
            _normal_(self.wk, generator, d ** -0.5)
            _normal_(self.wv, generator, d ** -0.5)
            _normal_(self.wo, generator, (h * dh) ** -0.5)
            if self.has_bias:
                for b in (self.bq, self.bk, self.bv):
                    b.zero_()

    def project_kv(self, cfg, x, positions):
        """K/V for cache population (prefill) or appending (decode)."""
        k = einsum32("bsd,dhk->bshk", x, self.wk).to(x.dtype)
        v = einsum32("bsd,dhk->bshk", x, self.wv).to(x.dtype)
        if self.has_bias:
            k = k + self.bk
            v = v + self.bv
        return rope(k, positions, cfg.rope_theta), v

    def forward(self, cfg, x, positions, *, kv=None, kv_positions=None,
                is_local: Optional[bool] = None, causal: bool = True,
                rules=NULL_RULES):
        """Self-attention over x, or attention against the given (k, v)
        (decode: the whole cache, `kv_positions` masking unwritten slots);
        `causal=False` is the encoder's bidirectional attention over the
        valid (non-negative) positions."""
        q = einsum32("bsd,dhk->bshk", x, self.wq).to(x.dtype)
        if self.has_bias:
            q = q + self.bq
        q = shard(rope(q, positions, cfg.rope_theta), rules.heads)
        if kv is None:
            k, v = self.project_kv(cfg, x, positions)
            kv_spec = getattr(rules, "kv_heads", None) or rules.heads
            k, v = shard(k, kv_spec), shard(v, kv_spec)
            kv_positions = positions
        else:
            k, v = kv
        if causal:
            mask = attn_mask(positions, kv_positions, cfg.sliding_window,
                             is_local)
        else:
            mask = (kv_positions >= 0)[:, None, :].expand(
                x.shape[0], x.shape[1], kv_positions.shape[1])
        out = gqa_attend(q, k, v, mask, cfg.attn_logit_softcap)
        return einsum32("bshk,hkd->bsd", out, self.wo).to(x.dtype)


# --------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# --------------------------------------------------------------------------

def mlp_specs(rules):
    return {"wi": rules.w_col, "wg": rules.w_col, "wo": rules.w_row}


class MLP(nn.Module):
    def __init__(self, d: int, d_ff: int, act: str = "silu", device=None):
        super().__init__()
        self.act = act
        self.wi = _param((d, d_ff), device)
        self.wg = _param((d, d_ff), device)
        self.wo = _param((d_ff, d), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        d, d_ff = self.wi.shape
        with torch.no_grad():
            _normal_(self.wi, generator, d ** -0.5)
            _normal_(self.wg, generator, d ** -0.5)
            _normal_(self.wo, generator, d_ff ** -0.5)

    def forward(self, x: torch.Tensor, rules=NULL_RULES) -> torch.Tensor:
        h = shard(dense(x, self.wi), rules.ffn_hidden)
        g = dense(x, self.wg)
        # gelu is PyTorch's tanh form, not jax.nn.gelu op for op: no
        # ported config uses it
        a = (silu(g) if self.act == "silu"
             else torch.nn.functional.gelu(g, approximate="tanh"))
        return dense(h * a, self.wo)


def silu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu` op for op in x's dtype: x * (1 / (1 + exp(-x))), each
    step rounded to bf16 as XLA does (a fused f32 silu rounds once and
    differs in about a third of the bf16 outputs)."""
    return x * sigmoid(x)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.sigmoid` as XLA expands it: 1 / (1 + exp(-x)) in x's
    dtype."""
    return 1.0 / (torch.exp(-x) + 1.0)


# --------------------------------------------------------------------------
# Embedding + LM head
# --------------------------------------------------------------------------

class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, device=None):
        super().__init__()
        self.table = _param((vocab, d), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            _normal_(self.table, generator, 0.02)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> f32 logits (B, S, V) against the (possibly tied)
    table."""
    return einsum32("bsd,vd->bsv", x, table)


def _gold(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logits[..., target]. On a DTensor: the vocabulary gathered, then a
    masked sum over it, which picks the same value exactly (one nonzero
    term) — DTensor zero-fills a gather's gradient as a full-size
    replicated tensor (`new_zeros` has no sharded strategy), where the
    mask keeps the batch's sharding."""
    from torch.distributed.tensor import DTensor
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, targets[..., None])[..., 0]
    logits = unshard(logits, (-1,))
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    hit = vocab == targets[..., None]
    return torch.where(hit, logits, torch.zeros((), device=logits.device)
                       ).sum(-1)


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy of f32 logits (B, S, V) against int
    targets (B, S); with `mask`, the mean over its nonzero positions. The
    gold logit is gathered (the reference's default "gather" form)."""
    logz = torch.logsumexp(logits, dim=-1)
    nll = logz - _gold(logits, targets.long())
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
