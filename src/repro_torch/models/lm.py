"""Decoder-LM assembly (the port of `repro/models/lm.py`), dense and vlm
families: init_params, init_cache, prefill, decode_step.

Layers are an `nn.ModuleList` walked in a Python loop, where the reference
scans stacked pytrees with `lax.scan`; the cache keeps the reference's
layer-stacked layout, {"k", "v"}: (L, B, T, Hkv, Dh) bf16. gemma3's 5:1
sliding-window pattern and h2o-danube's all-local one come through the
per-layer `is_local` flag (`swa_flags`).

`decode_step` writes the new K/V row into the cache in place (the
reference returns an updated copy) and returns the same dict.

The other families (moe, mla_moe, hybrid_ssm, rwkv, encdec) and the
training half (`forward`, `lm_loss`) are not ported yet (ROADMAP Queue 1
item 14).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from ..configs.base import ModelConfig
from .layers import DTYPE, MLP, Attention, Embedding, RMSNorm, embed, unembed

PORTED_FAMILIES = ("dense", "vlm")


def require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported to repro_torch "
            f"yet (ROADMAP Queue 1 item 14); ported: {PORTED_FAMILIES}")


# --------------------------------------------------------------------------
# Modules
# --------------------------------------------------------------------------

class Block(nn.Module):
    """One pre-norm transformer block: ln1, attn, ln2, mlp."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.attn = Attention(cfg, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, device)


class DecoderLM(nn.Module):
    """embed, layers, final_norm and, unless the embeddings are tied,
    head: the reference's parameter pytree as modules."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        require_ported(cfg)
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab, cfg.d_model, device)
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.head = (None if cfg.tie_embeddings
                     else Embedding(cfg.vocab, cfg.d_model, device))
        self.layers = nn.ModuleList(Block(cfg, device)
                                    for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def head_table(self) -> torch.Tensor:
        return (self.embed if self.head is None else self.head).table


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> DecoderLM:
    """Random bf16 parameters on `device`, drawn from `generator` (a
    torch.Generator on that device) with the reference's scales: norms 1,
    biases 0, embeddings N(0, 0.02^2), wq/wk/wv/wi/wg N(0, 1/d), wo
    N(0, 1/(H*Dh)) in attention and N(0, 1/d_ff) in the MLP."""
    model = DecoderLM(cfg, device)
    for mod in model.modules():
        if hasattr(mod, "reset_parameters"):
            mod.reset_parameters(generator)
    return model


def swa_flags(cfg: ModelConfig) -> Optional[List[bool]]:
    """Per layer: True where the layer uses the sliding window."""
    if cfg.sliding_window <= 0:
        return None
    if cfg.swa_pattern <= 0:
        return [True] * cfg.n_layers
    return [(i + 1) % cfg.swa_pattern != 0 for i in range(cfg.n_layers)]


def _layer_flags(cfg):
    flags = swa_flags(cfg)
    return [None] * cfg.n_layers if flags is None else flags


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device) -> Dict[str, torch.Tensor]:
    """Zeroed layer-stacked cache: {"k", "v"}: (L, B, max_len, Hkv, Dh)."""
    require_ported(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=DTYPE, device=device),
            "v": torch.zeros(shape, dtype=DTYPE, device=device)}


def _embed_inputs(params: DecoderLM, cfg, batch):
    """tokens (+ stub modality embeddings) -> (x, positions, n_prefix)."""
    x = embed(params.embed.table, batch["tokens"])
    n_prefix = 0
    if cfg.n_prefix_embeds and "embeds" in batch:
        x = torch.cat([batch["embeds"].to(x.dtype), x], dim=1)
        n_prefix = batch["embeds"].shape[1]
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    return x, positions, n_prefix


def _logits(params: DecoderLM, x):
    return unembed(params.head_table(), params.final_norm(x))


def prefill(params: DecoderLM, cfg: ModelConfig, batch):
    """Returns (last-position f32 logits (B, V), cache of the prompt's
    length: {"k", "v"}: (L, B, S, Hkv, Dh))."""
    x, positions, _ = _embed_inputs(params, cfg, batch)
    ks, vs = [], []
    for blk, fl in zip(params.layers, _layer_flags(cfg)):
        h = blk.ln1(x)
        k, v = blk.attn.project_kv(cfg, h, positions)
        x = x + blk.attn(cfg, h, positions, kv=(k, v),
                         kv_positions=positions, is_local=fl)
        x = x + blk.mlp(blk.ln2(x))
        ks.append(k)
        vs.append(v)
    logits = _logits(params, x[:, -1:])[:, 0]
    return logits, {"k": torch.stack(ks), "v": torch.stack(vs)}


def _decode_positions(batch_size: int, max_len: int, pos: int, device):
    q_pos = torch.full((batch_size, 1), pos, dtype=torch.int32, device=device)
    kv_pos = torch.arange(max_len, dtype=torch.int32,
                          device=device).expand(batch_size, max_len)
    return q_pos, kv_pos


def decode_step(params: DecoderLM, cfg: ModelConfig, tokens: torch.Tensor,
                pos: int, cache: Dict[str, torch.Tensor]):
    """tokens: (B, 1) int; pos: the current write index. Writes the new K/V
    rows into `cache` at `pos` and returns (f32 logits (B, V), cache)."""
    x = embed(params.embed.table, tokens)
    b = x.shape[0]
    max_len = cache["k"].shape[2]
    q_pos, kv_pos = _decode_positions(b, max_len, pos, x.device)
    for i, (blk, fl) in enumerate(zip(params.layers, _layer_flags(cfg))):
        h = blk.ln1(x)
        k1, v1 = blk.attn.project_kv(cfg, h, q_pos)
        k_row, v_row = cache["k"][i], cache["v"][i]
        k_row[:, pos:pos + 1] = k1
        v_row[:, pos:pos + 1] = v1
        x = x + blk.attn(cfg, h, q_pos, kv=(k_row, v_row),
                         kv_positions=kv_pos, is_local=fl)
        x = x + blk.mlp(blk.ln2(x))
    return _logits(params, x)[:, 0], cache
