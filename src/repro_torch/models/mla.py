"""Multi-head Latent Attention, DeepSeek-V2/V3 (the port of
`repro/models/mla.py`).

Prefill and scoring expand the compressed KV latent to per-head K/V and
run standard attention (`apply_mla`). Decode runs the absorbed form
(`decode_mla`): W_UK folds into the query and W_UV into the output, so
attention runs against the cached (B, S, kv_lora_rank) latent and the
(B, S, rope_dim) shared rope key, the rank-compressed cache. Masked scores
are -1e30 in f32 before the softmax, as in the reference.
"""
from __future__ import annotations

import torch
from torch import nn

from ..parallel.sharding import NULL_RULES, partial_to_replicate, shard
from .layers import (NEG_INF, RMSNorm, _f32, _normal_, _param, attn_mask,
                     einsum32, key_split, matmul32, rms_norm, rope,
                     softmax_keys, split_operands, sum_shards)


class MLA(nn.Module):
    """wkv_a (d, R + rope), kv_norm (R), wk_b (R, H, nope), wv_b (R, H, v),
    wo (H, v, d); with a query LoRA wq_a (d, q_rank), q_norm (q_rank),
    wq_b (q_rank, H, nope + rope), else wq (d, H, nope + rope)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
        qd = m.nope_head_dim + m.rope_head_dim
        self.wkv_a = _param((d, m.kv_lora_rank + m.rope_head_dim), device)
        self.kv_norm = RMSNorm(m.kv_lora_rank, cfg.norm_eps, device)
        self.wk_b = _param((m.kv_lora_rank, h, m.nope_head_dim), device)
        self.wv_b = _param((m.kv_lora_rank, h, m.v_head_dim), device)
        self.wo = _param((h, m.v_head_dim, d), device)
        if m.q_lora_rank:
            self.wq_a = _param((d, m.q_lora_rank), device)
            self.q_norm = RMSNorm(m.q_lora_rank, cfg.norm_eps, device)
            self.wq_b = _param((m.q_lora_rank, h, qd), device)
        else:
            self.wq = _param((d, h, qd), device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        d = self.wkv_a.shape[0]
        r, h, v = self.wv_b.shape
        with torch.no_grad():
            _normal_(self.wkv_a, generator, d ** -0.5)
            _normal_(self.wk_b, generator, r ** -0.5)
            _normal_(self.wv_b, generator, r ** -0.5)
            _normal_(self.wo, generator, (h * v) ** -0.5)
            if hasattr(self, "wq_a"):
                _normal_(self.wq_a, generator, d ** -0.5)
                _normal_(self.wq_b, generator, self.wq_a.shape[1] ** -0.5)
            else:
                _normal_(self.wq, generator, d ** -0.5)


def mla_specs(cfg, rules):
    return {"wkv_a": rules.w_col, "kv_norm": {"scale": rules.replicated},
            "wk_b": rules.w_qkv, "wv_b": rules.w_qkv, "wo": rules.w_out,
            "wq_a": rules.w_col, "q_norm": {"scale": rules.replicated},
            "wq_b": rules.w_qkv, "wq": rules.w_qkv}


def _queries(p: MLA, cfg, x, positions, rules=NULL_RULES):
    m = cfg.mla
    if m.q_lora_rank:
        ql = rms_norm(p.q_norm.scale, matmul32(x, p.wq_a).to(x.dtype),
                      cfg.norm_eps)
        q = einsum32("bsr,rhk->bshk", ql, p.wq_b).to(x.dtype)
    else:
        q = einsum32("bsd,dhk->bshk", x, p.wq).to(x.dtype)
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    return shard(q_nope, rules.heads), shard(q_rope, rules.heads)


def latent_kv(p: MLA, cfg, x, positions):
    """(c_kv (B, S, R) normalized latent, k_rope (B, S, rope_dim))."""
    m = cfg.mla
    kv_a = matmul32(x, p.wkv_a).to(x.dtype)
    c_kv = rms_norm(p.kv_norm.scale, kv_a[..., :m.kv_lora_rank],
                    cfg.norm_eps)
    k_rope = rope(kv_a[..., None, m.kv_lora_rank:], positions,
                  cfg.rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _softmax_masked(scores, mask, dtype, split=()):
    """The masked softmax over the keys (`layers.softmax_keys`: split over
    mesh dimensions `split`, else plain)."""
    scores = torch.where(mask[:, None], scores,
                         torch.full_like(scores, NEG_INF))
    return softmax_keys(scores, split).to(dtype)


def _scale(cfg, device):
    m = cfg.mla
    return _f32((m.nope_head_dim + m.rope_head_dim) ** -0.5, device)


def apply_mla(p: MLA, cfg, x, positions, rules=NULL_RULES):
    """Full-sequence causal MLA, the expanded form (prefill, scoring)."""
    q_nope, q_rope = _queries(p, cfg, x, positions, rules)
    c_kv, k_rope = latent_kv(p, cfg, x, positions)
    k_nope = shard(einsum32("bsr,rhk->bshk", c_kv, p.wk_b).to(x.dtype),
                   rules.heads)
    v = shard(einsum32("bsr,rhk->bshk", c_kv, p.wv_b).to(x.dtype),
              rules.heads)
    scores = (einsum32("bqhn,bkhn->bhqk", q_nope, k_nope)
              + einsum32("bqhr,bkr->bhqk", q_rope, k_rope)) \
        * _scale(cfg, x.device)
    probs = _softmax_masked(scores, attn_mask(positions, positions), v.dtype)
    ctx = einsum32("bhqk,bkhd->bqhd", probs, v).to(v.dtype)
    return sum_shards(einsum32("bqhd,hdm->bqm", ctx, p.wo),
                      rules).to(x.dtype)


def decode_mla(p: MLA, cfg, x, positions, cache_c, cache_rope,
               kv_positions, rules=NULL_RULES):
    """The absorbed form against the rank-compressed cache.
    cache_c: (B, Smax, R); cache_rope: (B, Smax, rope_dim); x: (B, 1, D).
    A cache whose sequence is sharded keeps its keys split, as
    `layers.gqa_attend` does (`layers.key_split`)."""
    q_nope, q_rope = _queries(p, cfg, x, positions, rules)
    # W_UK absorbed: the query in latent space
    q_c = einsum32("bqhn,rhn->bqhr", q_nope, p.wk_b).to(x.dtype)
    mask = attn_mask(positions, kv_positions)
    b, sq, h, r = q_c.shape
    split = key_split(q_c, cache_c, 4 * b * sq * h * r,
                      (cache_c.numel() + cache_rope.numel())
                      * cache_c.element_size())
    if split:
        if tuple(cache_rope.placements) != tuple(cache_c.placements):
            raise RuntimeError(f"the latent and rope caches are laid out "
                               f"differently: {cache_c.placements} and "
                               f"{cache_rope.placements}")
        q_c, mask = split_operands(q_c, cache_c, mask, split)
        q_rope = split_operands(q_rope, cache_c, None, split)[0]
    scores = (einsum32("bqhr,bkr->bhqk", q_c, cache_c)
              + einsum32("bqhr,bkr->bhqk", q_rope, cache_rope)) \
        * _scale(cfg, x.device)
    probs = _softmax_masked(scores, mask, x.dtype, split)
    # a Partial sum over the split keys, reduced once in f32
    ctx_c = partial_to_replicate(einsum32("bhqk,bkr->bqhr", probs, cache_c),
                                 split).to(x.dtype)
    # W_UV absorbed on the way out
    ctx = einsum32("bqhr,rhd->bqhd", ctx_c, p.wv_b).to(x.dtype)
    return sum_shards(einsum32("bqhd,hdm->bqm", ctx, p.wo),
                      rules).to(x.dtype)
