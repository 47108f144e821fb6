"""The 10 assigned architectures as published configs + reduced smoke configs.

Sources per the assignment sheet (hf / arXiv ids inline); the port's copy
of `repro.configs.archs`. Every config builds and serves at its published
widths on the card (`repro_torch.models`, `repro_torch.train.serve`;
deepseek-v3-671b's 61 layers do not fit one card, so `chip_smoke.py` cuts
its depth); `reduced()` variants run on the CPU in the parity tests.
"""
from __future__ import annotations

import dataclasses

from .base import MLAConfig, MoEConfig, ModelConfig, SSMConfig

# --- llava-next-34b [vlm] — hf:llava-hf/llava-v1.6 (34B backbone) ---------
LLAVA_NEXT_34B = ModelConfig(
    name="llava-next-34b", family="vlm", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, head_dim=128, d_ff=20480, vocab=64000,
    rope_theta=5e6, n_prefix_embeds=576)  # anyres tiling frontend stubbed

# --- zamba2-7b [hybrid] — arXiv:2411.15242 --------------------------------
ZAMBA2_7B = ModelConfig(
    name="zamba2-7b", family="hybrid_ssm", n_layers=81, d_model=3584,
    n_heads=32, n_kv_heads=32, head_dim=112, d_ff=14336, vocab=32000,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128,
                  attn_every=6))

# --- olmoe-1b-7b [moe] — arXiv:2409.02060 ---------------------------------
OLMOE_1B_7B = ModelConfig(
    name="olmoe-1b-7b", family="moe", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, head_dim=128, d_ff=1024, vocab=50304,
    moe=MoEConfig(n_experts=64, top_k=8, d_expert=1024))

# --- deepseek-v3-671b [moe+MLA] — arXiv:2412.19437 ------------------------
DEEPSEEK_V3_671B = ModelConfig(
    name="deepseek-v3-671b", family="mla_moe", n_layers=61, d_model=7168,
    n_heads=128, n_kv_heads=128, d_ff=2048, vocab=129280,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
                  first_dense_layers=3, d_shared=2048, route_scale=2.5,
                  aux_free_bias=True),
    mtp_depth=1)

# --- gemma3-4b [dense] — hf:google/gemma-3 family -------------------------
GEMMA3_4B = ModelConfig(
    name="gemma3-4b", family="dense", n_layers=34, d_model=2560,
    n_heads=8, n_kv_heads=4, head_dim=256, d_ff=10240, vocab=262144,
    sliding_window=1024, swa_pattern=6,  # 5 local : 1 global, 128k context
    rope_theta=1e6, tie_embeddings=True)

# --- h2o-danube-1.8b [dense] — arXiv:2401.16818 ---------------------------
H2O_DANUBE_1_8B = ModelConfig(
    name="h2o-danube-1.8b", family="dense", n_layers=24, d_model=2560,
    n_heads=32, n_kv_heads=8, head_dim=80, d_ff=6912, vocab=32000,
    sliding_window=4096, swa_pattern=0)  # mistral-style all-layer SWA

# --- granite-3-2b [dense] — hf:ibm-granite/granite-3.0-2b-base ------------
GRANITE_3_2B = ModelConfig(
    name="granite-3-2b", family="dense", n_layers=40, d_model=2048,
    n_heads=32, n_kv_heads=8, head_dim=64, d_ff=8192, vocab=49155,
    tie_embeddings=True)

# --- qwen2.5-3b [dense] — hf:Qwen/Qwen2.5 family --------------------------
QWEN2_5_3B = ModelConfig(
    name="qwen2.5-3b", family="dense", n_layers=36, d_model=2048,
    n_heads=16, n_kv_heads=2, head_dim=128, d_ff=11008, vocab=151936,
    qkv_bias=True, rope_theta=1e6)

# --- seamless-m4t-medium [audio enc-dec] — arXiv:2308.11596 ---------------
SEAMLESS_M4T_MEDIUM = ModelConfig(
    name="seamless-m4t-medium", family="encdec", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, head_dim=64, d_ff=4096, vocab=256206,
    enc_layers=12, dec_layers=12, n_prefix_embeds=0)  # audio frontend stubbed

# --- rwkv6-7b [attention-free] — arXiv:2404.05892 (Finch) -----------------
RWKV6_7B = ModelConfig(
    name="rwkv6-7b", family="rwkv", n_layers=32, d_model=4096,
    n_heads=64, n_kv_heads=64, head_dim=64, d_ff=14336, vocab=65536)


ARCHS = {
    c.name: c for c in (
        LLAVA_NEXT_34B, ZAMBA2_7B, OLMOE_1B_7B, DEEPSEEK_V3_671B, GEMMA3_4B,
        H2O_DANUBE_1_8B, GRANITE_3_2B, QWEN2_5_3B, SEAMLESS_M4T_MEDIUM,
        RWKV6_7B)
}


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests: few layers, narrow width,
    few experts, small vocab — structure (GQA ratios, MoE routing, SWA
    pattern, MLA ranks, SSM interleave) preserved."""
    kw = dict(
        name=cfg.name + "-reduced", n_layers=min(cfg.n_layers, 4),
        d_model=128, d_ff=256, vocab=512,
        n_heads=max(4, min(cfg.n_heads, 8)),
        head_dim=32)
    kw["n_kv_heads"] = max(1, kw["n_heads"] // max(
        1, cfg.n_heads // max(cfg.n_kv_heads, 1)))
    if cfg.sliding_window:
        kw["sliding_window"] = 16
    if cfg.moe:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=8, top_k=min(cfg.moe.top_k, 2), d_expert=64,
            d_shared=64 if cfg.moe.n_shared else 0,
            first_dense_layers=min(cfg.moe.first_dense_layers, 1))
    if cfg.mla:
        kw["mla"] = MLAConfig(q_lora_rank=48, kv_lora_rank=32,
                              rope_head_dim=16, nope_head_dim=32,
                              v_head_dim=32)
        kw["head_dim"] = 0
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=32,
                                        chunk=8, attn_every=2)
        kw["n_layers"] = 5  # two shared-attn applications + tail layers
    if cfg.family == "encdec":
        kw["enc_layers"] = 2
        kw["dec_layers"] = 2
        kw["n_layers"] = 4
    if cfg.family == "vlm":
        kw["n_prefix_embeds"] = 8
    if cfg.mtp_depth:
        kw["mtp_depth"] = 1
    return dataclasses.replace(cfg, **kw)
