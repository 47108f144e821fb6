"""Encoder-decoder, the SeamlessM4T-medium backbone (the port of
`repro/models/encdec.py`): a bidirectional encoder over stub audio-frame
embeddings and a causal decoder with cross-attention.

The audio frontend is a stub, as in the reference: the caller supplies
precomputed (B, S_src, d_model) frame embeddings (`batch["src_embeds"]`),
and a learned adapter projection stands in for the modality bridge. The
cache is {"k", "v"}: (L_dec, B, T, Hkv, Dh) self-attention rows, written in
place by `decode_step`, and {"cross_k", "cross_v"}: (L_dec, B, S_src, Hkv,
Dh), the encoder memory's K/V projected once at prefill.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..configs.base import ModelConfig
from .layers import (DTYPE, MLP, Attention, Embedding, RMSNorm, _normal_,
                     _param, einsum32, embed, gqa_attend, matmul32,
                     softmax_xent, unembed)
from .lm import Block, _decode_positions


class DecBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.self_attn = Attention(cfg, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.cross_attn = Attention(cfg, device)
        self.ln3 = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, device)


class EncDec(nn.Module):
    """adapter (d, d), enc_layers, enc_norm, embed, dec_layers, final_norm,
    head: the reference's parameter pytree as modules."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"EncDec builds the encdec family, not "
                             f"{cfg.family!r} ({cfg.name})")
        self.cfg = cfg
        self.adapter = _param((cfg.d_model, cfg.d_model), device)
        # an encoder block holds what a decoder-LM block does: ln1, attn,
        # ln2, mlp (its attention runs bidirectional)
        self.enc_layers = nn.ModuleList(Block(cfg, device)
                                        for _ in range(cfg.enc_layers))
        self.enc_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.embed = Embedding(cfg.vocab, cfg.d_model, device)
        self.dec_layers = nn.ModuleList(DecBlock(cfg, device)
                                        for _ in range(cfg.dec_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.head = Embedding(cfg.vocab, cfg.d_model, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            _normal_(self.adapter, generator, self.adapter.shape[0] ** -0.5)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> EncDec:
    model = EncDec(cfg, device)
    for mod in model.modules():
        if hasattr(mod, "reset_parameters"):
            mod.reset_parameters(generator)
    return model


def init_cache(cfg: ModelConfig, batch: int, max_len: int, src_len: int,
               device) -> Dict[str, torch.Tensor]:
    """Zeroed cache: self-attention rows of `max_len`, cross K/V of
    `src_len` frames."""
    kv = (cfg.n_kv_heads, cfg.resolved_head_dim)
    return {name: torch.zeros((cfg.dec_layers, batch, n) + kv, dtype=DTYPE,
                              device=device)
            for name, n in (("k", max_len), ("v", max_len),
                            ("cross_k", src_len), ("cross_v", src_len))}


def _positions(x):
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device).expand(b, s)


def _cross_attend(p: Attention, cfg, x, mem_k, mem_v):
    """Queries from the decoder state against the encoder memory's K/V (no
    rope: absolute alignment lives in the encoder)."""
    q = einsum32("bsd,dhk->bshk", x, p.wq).to(x.dtype)
    b, sq = x.shape[:2]
    mask = torch.ones((b, sq, mem_k.shape[1]), dtype=torch.bool,
                      device=x.device)
    out = gqa_attend(q, mem_k, mem_v, mask, cfg.attn_logit_softcap)
    return einsum32("bshk,hkd->bsd", out, p.wo).to(x.dtype)


def _cross_kv(p: Attention, x):
    k = einsum32("bsd,dhk->bshk", x, p.wk).to(x.dtype)
    v = einsum32("bsd,dhk->bshk", x, p.wv).to(x.dtype)
    return k, v


def encode(params: EncDec, cfg, src_embeds):
    x = matmul32(src_embeds.to(DTYPE), params.adapter).to(DTYPE)
    positions = _positions(x)
    for blk in params.enc_layers:
        x = x + blk.attn(cfg, blk.ln1(x), positions, causal=False)
        x = x + blk.mlp(blk.ln2(x))
    return params.enc_norm(x)


def _dec_block(blk: DecBlock, cfg, x, positions, mem_k, mem_v, *,
               self_kv=None, kv_positions=None):
    x = x + blk.self_attn(cfg, blk.ln1(x), positions, kv=self_kv,
                          kv_positions=kv_positions)
    x = x + _cross_attend(blk.cross_attn, cfg, blk.ln2(x), mem_k, mem_v)
    return x + blk.mlp(blk.ln3(x))


def forward(params: EncDec, cfg: ModelConfig, batch):
    """batch: {"src_embeds": (B, Ss, D), "tokens": (B, St)}. Returns
    dict(logits (B, St, V) f32, aux_moe 0.0, n_prefix 0)."""
    memory = encode(params, cfg, batch["src_embeds"])
    y = embed(params.embed.table, batch["tokens"])
    positions = _positions(y)
    for blk in params.dec_layers:
        mem_k, mem_v = _cross_kv(blk.cross_attn, memory)
        y = _dec_block(blk, cfg, y, positions, mem_k, mem_v)
    logits = unembed(params.head.table, params.final_norm(y))
    return {"logits": logits, "aux_moe": 0.0, "n_prefix": 0}


def lm_loss(params: EncDec, cfg, batch, **_):
    out = forward(params, cfg, batch)
    return softmax_xent(out["logits"][:, :-1], batch["tokens"][:, 1:]), out


def prefill(params: EncDec, cfg: ModelConfig, batch):
    """Encode and score the target prefix. Returns (last-position f32
    logits (B, V), the self- and cross-KV cache)."""
    memory = encode(params, cfg, batch["src_embeds"])
    y = embed(params.embed.table, batch["tokens"])
    positions = _positions(y)
    ks, vs, mks, mvs = [], [], [], []
    for blk in params.dec_layers:
        mem_k, mem_v = _cross_kv(blk.cross_attn, memory)
        k, v = blk.self_attn.project_kv(cfg, blk.ln1(y), positions)
        y = _dec_block(blk, cfg, y, positions, mem_k, mem_v, self_kv=(k, v),
                       kv_positions=positions)
        ks.append(k)
        vs.append(v)
        mks.append(mem_k)
        mvs.append(mem_v)
    logits = unembed(params.head.table, params.final_norm(y[:, -1:]))[:, 0]
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs),
                    "cross_k": torch.stack(mks), "cross_v": torch.stack(mvs)}


def decode_step(params: EncDec, cfg: ModelConfig, tokens, pos: int, cache):
    """One token: writes the new self-attention K/V rows into `cache` at
    `pos` and returns (f32 logits (B, V), cache)."""
    x = embed(params.embed.table, tokens)
    q_pos, kv_pos = _decode_positions(x.shape[0], cache["k"].shape[2], pos,
                                      x.device)
    for i, blk in enumerate(params.dec_layers):
        h = blk.ln1(x)
        k1, v1 = blk.self_attn.project_kv(cfg, h, q_pos)
        k_row, v_row = cache["k"][i], cache["v"][i]
        k_row[:, pos:pos + 1] = k1
        v_row[:, pos:pos + 1] = v1
        x = x + blk.self_attn(cfg, h, q_pos, kv=(k_row, v_row),
                              kv_positions=kv_pos)
        x = x + _cross_attend(blk.cross_attn, cfg, blk.ln2(x),
                              cache["cross_k"][i], cache["cross_v"][i])
        x = x + blk.mlp(blk.ln3(x))
    logits = unembed(params.head.table, params.final_norm(x))[:, 0]
    return logits, cache
