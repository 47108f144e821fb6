"""Model + run configuration system (the port's copy of `repro.configs.base`,
kept field for field so that a config means the same in both packages).

One `ModelConfig` covers every assigned architecture family (dense GQA,
sliding-window, MLA+MoE, plain MoE, Mamba2 hybrid, RWKV6, enc-dec, VLM
backbone). Family-specific fields are ignored by other families. Every arch
module in repro_torch.configs exposes:

    CONFIG            — the full published configuration
    reduced()         — a tiny same-family config for CPU smoke tests

`SHAPES` defines the assigned input-shape set.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0            # per-expert FFN hidden size
    n_shared: int = 0            # shared (always-on) experts
    first_dense_layers: int = 0  # leading layers that use a dense FFN
    d_shared: int = 0            # shared-expert hidden (defaults d_expert)
    capacity_factor: float = 1.25
    route_scale: float = 1.0
    aux_free_bias: bool = False  # DeepSeek-V3 aux-loss-free load balancing


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 0         # 0 -> full-rank Q projection
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128
    attn_every: int = 6          # zamba2: shared attn block period (0 = none)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"        # dense | moe | mla_moe | hybrid_ssm | rwkv
                                 # | encdec | vlm
    n_layers: int = 12
    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 0            # 0 -> d_model // n_heads
    d_ff: int = 2048
    vocab: int = 32000
    qkv_bias: bool = False
    act: str = "silu"            # gated GLU activation
    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    # sliding-window attention: 0 = all-global. `swa_pattern = p` means every
    # p-th layer (1-indexed) is global, the rest local (gemma3: p=6);
    # p = 1 with sliding_window>0 would be all-global; use swa_pattern=0 for
    # "every layer local" (h2o-danube).
    sliding_window: int = 0
    swa_pattern: int = 0
    attn_logit_softcap: float = 0.0
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # enc-dec
    enc_layers: int = 0
    dec_layers: int = 0
    # vlm / audio stub frontend: number of precomputed embedding positions
    # that prefix the token sequence (0 = pure LM)
    n_prefix_embeds: int = 0
    # DeepSeek multi-token prediction depth (0 = off)
    mtp_depth: int = 0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_attention_free(self) -> bool:
        return self.family == "rwkv"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic path exists (long_500k eligibility, DESIGN.md §5)."""
        if self.family in ("hybrid_ssm", "rwkv"):
            return True
        # SWA-dominant: bounded KV on all/most layers.
        return self.sliding_window > 0

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for 6ND math."""
        d, dh = self.d_model, self.resolved_head_dim
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.family == "rwkv":
            per = d * d * 4 + d * self.d_ff * 2 + d * 12  # r,k,v,g,o + cmix
            return emb + self.n_layers * per
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * dh \
            + self.n_heads * dh * d
        if self.mla is not None:
            m = self.mla
            q_in = m.q_lora_rank or d
            attn = (d * m.q_lora_rank if m.q_lora_rank else 0) \
                + q_in * self.n_heads * (m.nope_head_dim + m.rope_head_dim) \
                + d * (m.kv_lora_rank + m.rope_head_dim) \
                + m.kv_lora_rank * self.n_heads * (m.nope_head_dim + m.v_head_dim) \
                + self.n_heads * m.v_head_dim * d
        ffn_dense = 3 * d * self.d_ff
        layers = self.enc_layers + self.dec_layers or self.n_layers
        if self.family in ("moe", "mla_moe") and self.moe:
            mo = self.moe
            moe_ffn = 3 * d * mo.d_expert * mo.n_experts \
                + 3 * d * (mo.d_shared or mo.d_expert) * mo.n_shared \
                + d * mo.n_experts
            n_moe = layers - mo.first_dense_layers
            return emb + mo.first_dense_layers * (attn + ffn_dense) \
                + n_moe * (attn + moe_ffn)
        if self.family == "hybrid_ssm":
            s = self.ssm or SSMConfig()
            d_in = s.expand * d
            per = 2 * d * d_in + d_in * s.d_conv + d_in * d \
                + (d_in // s.head_dim) * (2 + s.d_state * 0)
            n_attn = (self.n_layers // max(s.attn_every, 1)) and 1
            return emb + self.n_layers * per + (attn + ffn_dense)  # shared blk
        if self.family == "encdec":
            cross = attn
            return emb + self.enc_layers * (attn + ffn_dense) \
                + self.dec_layers * (attn + cross + ffn_dense)
        return emb + layers * (attn + ffn_dense)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top-k + shared only)."""
        if self.family not in ("moe", "mla_moe") or not self.moe:
            return self.param_count()
        full = self.param_count()
        mo = self.moe
        d = self.d_model
        layers = self.n_layers - mo.first_dense_layers
        all_experts = 3 * d * mo.d_expert * mo.n_experts * layers
        active = 3 * d * mo.d_expert * mo.top_k * layers
        return full - all_experts + active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"
    # Decode length: how many tokens each sequence generates against the
    # seq_len context ("decode" kind only; train/prefill ignore it). The
    # default matches the value `workload_for` historically hard-coded, so
    # the assigned shape set extracts identically to before the field
    # existed.
    new_tokens: int = 32


# The assigned LM shape set (identical across the 10 archs).
SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}
