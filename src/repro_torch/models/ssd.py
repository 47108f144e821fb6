"""Mamba-2 block, SSD (state-space duality, arXiv:2405.21060), chunked (the
port of `repro/models/ssd.py`).

Recurrence (per head h, scalar decay):  H_t = a_t * H_{t-1} + dt_t * B_t x_t^T
Output:                                  y_t = C_t @ H_t + D * x_t

Prefill and scoring run the chunked algorithm: quadratic attention-like
math inside fixed-size chunks plus a loop over the chunk states for the
inter-chunk recurrence. A sequence is padded to a chunk multiple with
decay-neutral steps (dt = -30, so softplus(dt) ~ 0 and a = 1), so the final
state equals the state at the true end. Decode carries (H, conv window)
state, O(1) a token. The SSM's einsums are f32 in the reference and here;
the depthwise causal conv is a sum of K bf16 products rounded at each add,
and decode's window product a bf16 product, as in the reference.
"""
from __future__ import annotations

import torch
from torch import nn

from ..parallel.sharding import NULL_RULES, shard
from .layers import (DTYPE, RMSNorm, _normal_, _param, f32_reduction,
                     matmul32, rms_norm, silu, sum_shards)


def _dims(cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.d_state
    return s, d_in, n_heads, conv_dim


class Mamba(nn.Module):
    """in_proj (d, 2 d_in + 2 d_state + H) -> [z (gate), x, B, C, dt];
    conv_w (d_conv, conv_dim), conv_b; a_log, d_skip, dt_bias (H,) f32;
    the gated norm `norm` (d_in); out_proj (d_in, d)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        s, d_in, n_heads, conv_dim = _dims(cfg)
        d = cfg.d_model
        self.in_proj = _param((d, 2 * d_in + 2 * s.d_state + n_heads),
                              device)
        self.conv_w = _param((s.d_conv, conv_dim), device)
        self.conv_b = _param((conv_dim,), device)
        self.a_log = _param((n_heads,), device, torch.float32)
        self.d_skip = _param((n_heads,), device, torch.float32)
        self.dt_bias = _param((n_heads,), device, torch.float32)
        self.norm = RMSNorm(d_in, cfg.norm_eps, device)
        self.out_proj = _param((d_in, d), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        d, d_in = self.in_proj.shape[0], self.out_proj.shape[0]
        with torch.no_grad():
            _normal_(self.in_proj, generator, d ** -0.5)
            _normal_(self.conv_w, generator, 0.2)
            self.conv_b.zero_()
            self.a_log.zero_()
            self.d_skip.fill_(1.0)
            self.dt_bias.zero_()
            _normal_(self.out_proj, generator, d_in ** -0.5)


def mamba_specs(rules):
    return {"in_proj": rules.w_col, "conv_w": P_or_none(rules),
            "conv_b": rules.b_model, "a_log": rules.replicated,
            "d_skip": rules.replicated, "dt_bias": rules.replicated,
            "norm": {"scale": rules.b_model},
            "out_proj": rules.w_row}


def P_or_none(rules):
    """(K, C) conv taps: channels over the model axis; None under
    NULL_RULES."""
    if rules is NULL_RULES:
        return None
    return (None, rules.model_axis)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _split_proj(cfg, proj):
    s, d_in, _, _ = _dims(cfg)
    return torch.split(proj, [d_in, d_in + 2 * s.d_state,
                              proj.shape[-1] - 2 * d_in - 2 * s.d_state],
                       dim=-1)


def _causal_conv(xbc, w, b):
    """Depthwise causal conv over (B, S, C) with kernel (K, C): a Python sum
    of K bf16 products, rounded at each add."""
    k, seq = w.shape[0], xbc.shape[1]
    pad = torch.nn.functional.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + seq, :] * w[i] for i in range(k))
    return silu((out + b).float()).to(xbc.dtype)


def _ssm_inputs(cfg, p: Mamba, xbc, dt):
    s, d_in, n_heads, _ = _dims(cfg)
    x, bmat, cmat = torch.split(xbc, [d_in, s.d_state, s.d_state], dim=-1)
    x = x.reshape(*x.shape[:2], n_heads, s.head_dim)
    dt = softplus(dt.float() + p.dt_bias)                   # (B, S, H)
    a = torch.exp(-torch.exp(p.a_log) * dt)                 # decay in (0, 1)
    return x, bmat, cmat, dt, a


def _gated_out(p: Mamba, cfg, y, z, dtype, rules=NULL_RULES):
    y = rms_norm(p.norm.scale, (y * silu(z.float())).to(dtype), cfg.norm_eps)
    return sum_shards(matmul32(y, p.out_proj), rules).to(dtype)


def apply_mamba(p: Mamba, cfg, x, return_state: bool = False,
                rules=NULL_RULES):
    """Full-sequence chunked SSD. x: (B, S, D) -> (B, S, D), or (out,
    {"h", "conv"}) with `return_state` (prefill)."""
    s, d_in, n_heads, _ = _dims(cfg)
    b, true_seq, _ = x.shape
    q = s.chunk
    pad = (-true_seq) % q
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
    seq = true_seq + pad
    proj = matmul32(x, p.in_proj).to(x.dtype)
    z, xbc_raw, dt = _split_proj(cfg, proj)
    if pad:
        valid = (torch.arange(seq, device=x.device) < true_seq)[None, :, None]
        dt = torch.where(valid, dt, torch.full_like(dt, -30.0))
    xbc = _causal_conv(xbc_raw, p.conv_w, p.conv_b)
    xs, bmat, cmat, dt, a = _ssm_inputs(cfg, p, xbc, dt)
    xs = shard(xs, rules.heads)

    nch = seq // q
    xs_c = xs.reshape(b, nch, q, n_heads, s.head_dim).float()
    b_c = bmat.reshape(b, nch, q, s.d_state).float()
    c_c = cmat.reshape(b, nch, q, s.d_state).float()
    dt_c = dt.reshape(b, nch, q, n_heads)
    lcum = torch.cumsum(torch.log(a.reshape(b, nch, q, n_heads)), dim=2)

    # intra-chunk: score[q_, t] = exp(lcum[q_] - lcum[t]) (C_q . B_t) dt_t
    cb = torch.einsum("bnqs,bnts->bnqt", c_c, b_c)          # (B, N, Q, Q)
    decay = torch.exp(lcum[:, :, :, None, :] - lcum[:, :, None, :, :])
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    score = torch.where(tri[None, None, :, :, None], cb[..., None] * decay,
                        torch.zeros((), device=x.device))   # (B,N,Q,T,H)
    y_intra = torch.einsum("bnqth,bnth,bnthd->bnqhd", score, dt_c, xs_c)

    # chunk summaries: S_n = sum_t exp(lcum_end - lcum_t) dt_t B_t x_t^T
    wdec = torch.exp(lcum[:, :, -1:, :] - lcum) * dt_c      # (B, N, Q, H)
    state_c = torch.einsum("bnth,bnts,bnthd->bnhsd", wdec, b_c, xs_c)
    a_chunk = torch.exp(lcum[:, :, -1, :])                  # (B, N, H)

    # inter-chunk recurrence over the N chunks
    h = torch.zeros((b, n_heads, s.d_state, s.head_dim), dtype=torch.float32,
                    device=x.device)
    h_before = []
    for n in range(nch):
        h_before.append(h)
        h = h * a_chunk[:, n, :, None, None] + state_c[:, n]
    h_before = torch.stack(h_before, dim=1)                 # (B,N,H,S,Dh)

    y_inter = torch.einsum("bnqs,bnhsd,bnqh->bnqhd", c_c, h_before,
                           torch.exp(lcum))
    y = (y_intra + y_inter).reshape(b, seq, n_heads, s.head_dim)
    y = y + p.d_skip[:, None] * xs.float()
    out = _gated_out(p, cfg, y.reshape(b, seq, d_in), z, x.dtype, rules)
    out = out[:, :true_seq]
    if return_state:
        return out, {"h": h, "conv": xbc_raw[:, true_seq - (s.d_conv - 1):
                                             true_seq, :]}
    return out


def init_mamba_state(cfg, batch: int, device=None):
    s, d_in, n_heads, conv_dim = _dims(cfg)
    return {"h": torch.zeros((batch, n_heads, s.d_state, s.head_dim),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=DTYPE,
                                device=device)}


def decode_mamba(p: Mamba, cfg, x, state):
    """One token. x: (B, 1, D); state as `init_mamba_state` gives it.
    Returns (out (B, 1, D), the new state)."""
    s, d_in, n_heads, _ = _dims(cfg)
    proj = matmul32(x, p.in_proj).to(x.dtype)
    z, xbc, dt = _split_proj(cfg, proj)
    window = torch.cat([state["conv"], xbc], dim=1)         # (B, K, C)
    with f32_reduction():   # a bf16 result: accumulated in f32
        conv_out = torch.einsum("bkc,kc->bc", window, p.conv_w) + p.conv_b
    xbc1 = silu(conv_out.float()).to(x.dtype)[:, None, :]
    xs, bmat, cmat, dtv, a = _ssm_inputs(cfg, p, xbc1, dt)
    xf = xs[:, 0].float()                                   # (B, H, Dh)
    h = state["h"] * a[:, 0, :, None, None] + torch.einsum(
        "bh,bs,bhd->bhsd", dtv[:, 0], bmat[:, 0].float(), xf)
    y = torch.einsum("bs,bhsd->bhd", cmat[:, 0].float(), h) \
        + p.d_skip[:, None] * xf
    out = _gated_out(p, cfg, y.reshape(x.shape[0], 1, d_in), z, x.dtype)
    return out, {"h": h, "conv": window[:, 1:, :]}
