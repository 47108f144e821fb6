"""RWKV-6 "Finch" block, arXiv:2404.05892 (the port of
`repro/models/rwkv.py`): attention-free token mixing with data-dependent
per-channel decay.

Recurrence (per head, K = key dim, V = value dim):
    out_t = r_t @ (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T
with w_t in (0, 1) produced by a LoRA on the token-shifted input.

Two WKV evaluations, picked per call (`apply_rwkv_time(..., wkv_mode=)`),
the module default `WKV_MODE` (the reference's) where it is None:
  * "scan" (the default): the exact recurrence, a loop over time;
  * "chunked": the GLA-style chunked form, with log w clamped to
    [_LOG_W_MIN, 0] (so it differs from the scan by design) and
    T % chunk == 0.
A one-token call (decode) always takes the scan.

The projections r, k, v, g, the decay LoRA and the channel mix's k and r
are plain bf16 products in the reference (`x @ w`, not its f32 `matmul32`)
and stay bf16 products here (`layers.matmul16`: on a card with cuBLAS's
bf16 reduced-precision reduction off, since the reference accumulates them
in f32).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..parallel.sharding import NULL_RULES, shard
from .layers import (RMSNorm, _normal_, _param, matmul16, matmul32, rms_norm,
                     scan, sigmoid, silu, sum_shards)

WKV_MODE = "scan"  # module default; overridden per call
_LOG_W_MIN = -8.0  # chunked-mode decay clamp (exp(-8) a token at least)


class RWKVTime(nn.Module):
    """The time mix: mu (5, d) shifts for r, k, v, g, w; wr, wk, wv, wg,
    wo (d, d); w_base (H, K) f32, w_lora_a (d, 64), w_lora_b (64, d); the
    bonus u (H, K) f32; ln_out (d)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        self.mu = _param((5, d), device)
        self.wr = _param((d, d), device)
        self.wk = _param((d, d), device)
        self.wv = _param((d, d), device)
        self.wg = _param((d, d), device)
        self.w_base = _param((h, d // h), device, torch.float32)
        self.w_lora_a = _param((d, 64), device)
        self.w_lora_b = _param((64, d), device)
        self.u = _param((h, d // h), device, torch.float32)
        self.ln_out = RMSNorm(d, cfg.norm_eps, device)
        self.wo = _param((d, d), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        d = self.wr.shape[0]
        with torch.no_grad():
            _normal_(self.mu, generator, 0.02)
            for w in (self.wr, self.wk, self.wv, self.wg):
                _normal_(w, generator, d ** -0.5)
            self.w_base.fill_(-1.0)
            _normal_(self.w_lora_a, generator, d ** -0.5)
            _normal_(self.w_lora_b, generator, 64 ** -0.5)
            self.u.zero_()
            _normal_(self.wo, generator, d ** -0.5)


class RWKVChannel(nn.Module):
    """The channel mix (RWKV's FFN): mu (2, d) shifts for k, r;
    wk (d, d_ff), wv (d_ff, d), wr (d, d)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d = cfg.d_model
        self.mu = _param((2, d), device)
        self.wk = _param((d, cfg.d_ff), device)
        self.wv = _param((cfg.d_ff, d), device)
        self.wr = _param((d, d), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        d, d_ff = self.wk.shape
        with torch.no_grad():
            _normal_(self.mu, generator, 0.02)
            _normal_(self.wk, generator, d ** -0.5)
            _normal_(self.wv, generator, d_ff ** -0.5)
            _normal_(self.wr, generator, d ** -0.5)


def rwkv_time_specs(rules):
    return {"mu": rules.replicated, "wr": rules.w_col, "wk": rules.w_col,
            "wv": rules.w_col, "wg": rules.w_col, "w_base": rules.replicated,
            "w_lora_a": rules.replicated, "w_lora_b": rules.replicated,
            "u": rules.replicated, "ln_out": {"scale": rules.replicated},
            "wo": rules.w_row}


def rwkv_channel_specs(rules):
    return {"mu": rules.replicated, "wk": rules.w_col, "wv": rules.w_row,
            "wr": rules.w_col}


def _shift(x, last: Optional[torch.Tensor]):
    """Token shift: x_{t-1}, with `last` (B, 1, D) (zeros if None) at
    t = 0."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


def _lerp(x, xs, mu):
    return x + (xs - x) * mu.to(x.dtype)


def _wkv_scan(r, k, v, w, u, s0):
    """The exact recurrence. r/k/w: (B, T, H, K); v: (B, T, H, V).
    Returns (out (B, T, H, V) f32, s_final (B, H, K, V) f32)."""
    r, k, v, w = (t.float() for t in (r, k, v, w))

    def step(s, t):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]      # (B, H, K, V)
        out = torch.einsum("bhk,bhkv->bhv", r[:, t], s + u[..., None] * kv)
        return w[:, t, :, :, None] * s + kv, out

    s, outs = scan(step, s0, k.shape[1], dim=1)
    return outs, s


def _wkv_chunked(r, k, v, w, u, s0, chunk: int = 64):
    """The GLA-style chunked evaluation: `_wkv_scan`'s contract, with the
    decay clamped; requires T % chunk == 0."""
    b, t, h, kd = k.shape
    vd = v.shape[-1]
    q = chunk
    if t % q:
        raise ValueError(f"chunked WKV needs T % chunk == 0, got T = {t}, "
                         f"chunk = {q}")
    n = t // q
    r, k, v = (x.float() for x in (r, k, v))
    lw = torch.clamp(torch.log(w.float()), _LOG_W_MIN, 0.0)
    rc = r.reshape(b, n, q, h, kd)
    kc = k.reshape(b, n, q, h, kd)
    vc = v.reshape(b, n, q, h, vd)
    lw = lw.reshape(b, n, q, h, kd)
    lcum = torch.cumsum(lw, dim=2)                          # incl. own w
    p_t = lcum - lw                                         # sum_{s<t} lw_s

    # factored intra-chunk attention: coeff(t, tau) = exp(p_t - lcum_tau)
    # for tau < t, |p_t| bounded by chunk * |_LOG_W_MIN|
    r_dec = rc * torch.exp(p_t)
    k_dec = kc * torch.exp(-lcum)
    scores = torch.einsum("bnqhk,bnthk->bnhqt", r_dec, k_dec)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=k.device),
                      diagonal=-1)                          # strictly past
    scores = torch.where(mask[None, None, None], scores,
                         torch.zeros((), device=k.device))
    bonus = torch.einsum("bnqhk,hk,bnqhk->bnqh", rc, u, kc)  # current token
    y = torch.einsum("bnhqt,bnthv->bnqhv", scores, vc) \
        + bonus[..., None] * vc

    # chunk summary: S_chunk = sum_t exp(lcum_end - lcum_t) k_t v_t^T
    kw = kc * torch.exp(lcum[:, :, -1:, :, :] - lcum)
    s_chunk = torch.einsum("bnthk,bnthv->bnhkv", kw, vc)
    a_chunk = torch.exp(lcum[:, :, -1])                     # (B, N, H, K)

    s, y_inter = s0, []
    for i in range(n):
        y_inter.append(torch.einsum("bqhk,bhkv->bqhv", r_dec[:, i], s))
        s = a_chunk[:, i, ..., None] * s + s_chunk[:, i]
    y = y + torch.stack(y_inter, dim=1)
    return y.reshape(b, t, h, vd), s


def _decay(p: RWKVTime, xw):
    lora = matmul16(torch.tanh(matmul16(xw, p.w_lora_a)), p.w_lora_b)
    h, kd = p.w_base.shape
    wl = p.w_base + lora.reshape(*lora.shape[:-1], h, kd)  # f32
    return torch.exp(-torch.exp(wl))                      # (B,T,H,K) in (0,1)


def apply_rwkv_time(p: RWKVTime, cfg, x, *, last=None, state=None,
                    wkv_mode=None, rules=NULL_RULES):
    """The time mix over a sequence (or one step, x (B, 1, D), with the
    carried `last` and `state`), the WKV by `wkv_mode` (None: `WKV_MODE`).
    Returns (out, (last x, state))."""
    wkv_mode = wkv_mode or WKV_MODE
    b, t, d = x.shape
    h = cfg.n_heads
    kd = d // h
    xs = _shift(x, last)
    xr, xk, xv, xg, xw = (_lerp(x, xs, p.mu[i]) for i in range(5))
    r = shard(matmul16(xr, p.wr).reshape(b, t, h, kd), rules.heads)
    k = shard(matmul16(xk, p.wk).reshape(b, t, h, kd), rules.heads)
    v = shard(matmul16(xv, p.wv).reshape(b, t, h, kd), rules.heads)
    g = matmul16(xg, p.wg)
    w = _decay(p, xw)
    if state is None:
        state = torch.zeros((b, h, kd, kd), dtype=torch.float32,
                            device=x.device)
    if t > 1 and wkv_mode == "chunked":
        out, s_new = _wkv_chunked(r, k, v, w, p.u, state)
    elif wkv_mode in ("scan", "chunked"):
        out, s_new = _wkv_scan(r, k, v, w, p.u, state)
    else:
        raise ValueError(f"unknown WKV mode {wkv_mode!r}")
    out = rms_norm(p.ln_out.scale, out.reshape(b, t, d).to(x.dtype),
                   cfg.norm_eps)
    out = out * silu(g.float()).to(x.dtype)
    out = sum_shards(matmul32(out, p.wo), rules).to(x.dtype)
    return out, (x[:, -1:], s_new)


def apply_rwkv_channel(p: RWKVChannel, cfg, x, *, last=None,
                       rules=NULL_RULES):
    """The channel mix. Returns (out, last x)."""
    xs = _shift(x, last)
    xk = _lerp(x, xs, p.mu[0])
    xr = _lerp(x, xs, p.mu[1])
    k = shard(torch.square(torch.relu(matmul16(xk, p.wk))),
              rules.ffn_hidden)
    kv = sum_shards(matmul32(k, p.wv), rules).to(x.dtype)
    return sigmoid(matmul16(xr, p.wr).float()).to(x.dtype) * kv, x[:, -1:]
