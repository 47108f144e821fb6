"""Workload extraction from framework ModelConfigs — the HW/SW co-design
bridge (DESIGN.md §2): the same `--arch` config that drives serving
lowers to a DxPTA Workload (GEMM list + electronic-unit ops + memory
traffic) so the paper's search runs over the assigned architectures.

Per-family GEMM decomposition notes (DESIGN.md §5):
  * attention-free recurrences (RWKV WKV, Mamba selective scan) are
    element-wise -> electronic unit; their projections are GEMMs;
  * sliding-window layers have window-bounded score GEMMs;
  * MoE experts contribute expected top-k load (B*S*top_k/E rows each);
  * MLA low-rank compress/expand are GEMMs;
  * decode workloads have M = batch (tiny-M GEMMs -> poor DDot-array
    utilization; visible in the DSE results).
"""
from __future__ import annotations

from typing import List

from ..configs.base import ModelConfig, ShapeConfig

from .workload import Gemm, Workload


def _attn_gemms(cfg, n_ctx, bt, batch, layers, gemms: List[Gemm],
                decode=False, window=None):
    """GQA attention GEMMs for `layers` layers. bt = batch*q_tokens."""
    dh = cfg.resolved_head_dim
    d = cfg.d_model
    d_q = cfg.n_heads * dh
    d_kv = cfg.n_kv_heads * dh
    q_tokens = bt // batch
    ctx = min(n_ctx, window) if window else n_ctx
    gemms.append(Gemm(bt, d, d_q + 2 * d_kv, layers))               # QKV
    gemms.append(Gemm(q_tokens, dh, ctx, layers * batch * cfg.n_heads))
    gemms.append(Gemm(q_tokens, ctx, dh, layers * batch * cfg.n_heads))
    gemms.append(Gemm(bt, d_q, d, layers))                          # out


def _mla_gemms(cfg, n_ctx, bt, batch, layers, gemms: List[Gemm],
               decode=False):
    m = cfg.mla
    d = cfg.d_model
    h = cfg.n_heads
    qd = m.nope_head_dim + m.rope_head_dim
    q_tokens = bt // batch
    if m.q_lora_rank:
        gemms.append(Gemm(bt, d, m.q_lora_rank, layers))
        gemms.append(Gemm(bt, m.q_lora_rank, h * qd, layers))
    else:
        gemms.append(Gemm(bt, d, h * qd, layers))
    gemms.append(Gemm(bt, d, m.kv_lora_rank + m.rope_head_dim, layers))
    if decode:
        # absorbed form: q->latent, scores/ctx against rank-R cache
        gemms.append(Gemm(bt, m.nope_head_dim, m.kv_lora_rank, layers * h))
        gemms.append(Gemm(q_tokens, m.kv_lora_rank + m.rope_head_dim, n_ctx,
                          layers * batch * h))
        gemms.append(Gemm(q_tokens, n_ctx, m.kv_lora_rank,
                          layers * batch * h))
        gemms.append(Gemm(bt, m.kv_lora_rank, m.v_head_dim, layers * h))
    else:
        gemms.append(Gemm(bt, m.kv_lora_rank,
                          h * (m.nope_head_dim + m.v_head_dim), layers))
        gemms.append(Gemm(q_tokens, qd, n_ctx, layers * batch * h))
        gemms.append(Gemm(q_tokens, n_ctx, m.v_head_dim, layers * batch * h))
    gemms.append(Gemm(bt, h * m.v_head_dim, d, layers))


def _ffn_gemms(cfg, bt, layers, gemms: List[Gemm]):
    gemms.append(Gemm(bt, cfg.d_model, cfg.d_ff, 2 * layers))  # wi + wg
    gemms.append(Gemm(bt, cfg.d_ff, cfg.d_model, layers))


def _moe_gemms(cfg, bt, layers, gemms: List[Gemm]):
    mo = cfg.moe
    d = cfg.d_model
    gemms.append(Gemm(bt, d, mo.n_experts, layers))            # router
    rows = max(1, bt * mo.top_k // mo.n_experts)               # per expert
    gemms.append(Gemm(rows, d, mo.d_expert, 2 * layers * mo.n_experts))
    gemms.append(Gemm(rows, mo.d_expert, d, layers * mo.n_experts))
    if mo.n_shared:
        ds = (mo.d_shared or mo.d_expert) * mo.n_shared
        gemms.append(Gemm(bt, d, ds, 2 * layers))
        gemms.append(Gemm(bt, ds, d, layers))


def _mamba_gemms(cfg, bt, batch, layers, gemms: List[Gemm], decode=False):
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    nh = d_in // s.head_dim
    proj_out = 2 * d_in + 2 * s.d_state + nh
    gemms.append(Gemm(bt, d, proj_out, layers))
    gemms.append(Gemm(bt, d_in, d, layers))
    if not decode:
        # intra-chunk SSD GEMMs (C.B^T + score-weighted value aggregation);
        # decode uses the element-wise recurrence (electronic unit).
        q_tokens = bt // batch
        nch = max(1, q_tokens // s.chunk)
        gemms.append(Gemm(s.chunk, s.d_state, s.chunk, layers * batch * nch))
        gemms.append(Gemm(s.chunk, s.chunk, d_in, layers * batch * nch))


def _rwkv_gemms(cfg, bt, layers, gemms: List[Gemm]):
    d = cfg.d_model
    gemms.append(Gemm(bt, d, d, 5 * layers))   # r, k, v, g, out projections
    gemms.append(Gemm(bt, d, 64, layers))      # decay LoRA down
    gemms.append(Gemm(bt, 64, d, layers))      # decay LoRA up
    gemms.append(Gemm(bt, d, cfg.d_ff, layers))        # channel-mix k
    gemms.append(Gemm(bt, cfg.d_ff, d, layers))        # channel-mix v
    gemms.append(Gemm(bt, d, d, layers))               # channel-mix r


def _elec_ops(cfg, n_ctx, bt, batch, layers, decode=False):
    """Softmax / LN / activations / recurrences on the electronic unit.

    Every branch scales with the `layers` parameter, never `cfg.n_layers`:
    the two only coincide when the caller happens to pass the full depth,
    and an `cfg.n_layers` alias would double-count whenever a family's
    electronic depth differs from its config depth (enc-dec already does;
    partial-depth scenario extraction would too).
    """
    d = cfg.d_model
    q_tokens = bt // batch
    ops = bt * d * 10 * layers                              # norms/residual
    if cfg.family == "rwkv":
        kd = cfg.resolved_head_dim
        ops += bt * cfg.n_heads * kd * kd * 3 * layers      # WKV update
        ops += bt * cfg.d_ff
    elif cfg.family == "hybrid_ssm":
        s = cfg.ssm
        d_in = s.expand * d
        ops += bt * (d_in // s.head_dim) * s.d_state * s.head_dim // \
            max(s.chunk, 1) * 3 * layers                    # inter-chunk
        ops += bt * d_in * 2 * layers                       # conv + gates
    else:
        ops += batch * cfg.n_heads * q_tokens * n_ctx * 3 * layers  # softmax
        ops += bt * cfg.d_ff * layers                       # activation
    return float(ops)


def _weight_bytes(cfg, weight_bits=4):
    return cfg.param_count() * weight_bits / 8.0


def _active_weight_bytes(cfg, weight_bits=4):
    return cfg.active_param_count() * weight_bits / 8.0


def _build(cfg: ModelConfig, name, seq, batch, *, decode=False,
           n_ctx=None, act_bits=4) -> Workload:
    n_ctx = n_ctx or seq
    if cfg.n_prefix_embeds and cfg.family != "encdec":
        # VLM/audio prefix embeddings are real sequence positions: in
        # prefill/train they flow through every layer alongside the text
        # tokens; in decode they sit in the attended context.
        if decode:
            n_ctx += cfg.n_prefix_embeds
        else:
            seq = seq + cfg.n_prefix_embeds
            n_ctx += cfg.n_prefix_embeds
    bt = batch * seq
    gemms: List[Gemm] = []
    fam = cfg.family

    attn_layers = cfg.n_layers
    if fam == "encdec":
        # prefill: encoder over seq/2 src frames + decoder over seq/2 tgt
        # tokens. decode: decoder only (cross-KV reused), src ctx = n_ctx/2.
        src = (n_ctx if decode else seq) // 2
        tgt = seq if decode else seq - src
        tgt_bt = batch * tgt
        if not decode:
            _attn_gemms(cfg, src, batch * src, batch, cfg.enc_layers, gemms)
            _ffn_gemms(cfg, batch * src, cfg.enc_layers, gemms)
        _attn_gemms(cfg, n_ctx if decode else tgt, tgt_bt, batch,
                    cfg.dec_layers, gemms, decode=decode)
        dh = cfg.resolved_head_dim
        gemms.append(Gemm(tgt, dh, src, cfg.dec_layers * batch * cfg.n_heads))
        gemms.append(Gemm(tgt, src, dh, cfg.dec_layers * batch * cfg.n_heads))
        _ffn_gemms(cfg, tgt_bt, cfg.dec_layers, gemms)
        layers_for_elec = cfg.enc_layers + cfg.dec_layers
    elif fam == "rwkv":
        _rwkv_gemms(cfg, bt, cfg.n_layers, gemms)
        layers_for_elec = cfg.n_layers
    elif fam == "hybrid_ssm":
        s = cfg.ssm
        n_shared = cfg.n_layers // s.attn_every
        _mamba_gemms(cfg, bt, batch, cfg.n_layers, gemms, decode=decode)
        _attn_gemms(cfg, n_ctx, bt, batch, n_shared, gemms, decode=decode)
        _ffn_gemms(cfg, bt, n_shared, gemms)
        layers_for_elec = cfg.n_layers
    else:
        window = cfg.sliding_window or None
        n_global = (cfg.n_layers // cfg.swa_pattern
                    if (window and cfg.swa_pattern) else
                    (0 if window else cfg.n_layers))
        n_local = cfg.n_layers - n_global
        if fam == "mla_moe":
            _mla_gemms(cfg, n_ctx, bt, batch, cfg.n_layers, gemms,
                       decode=decode)
        else:
            if n_local:
                _attn_gemms(cfg, n_ctx, bt, batch, n_local, gemms,
                            decode=decode, window=window)
            if n_global:
                _attn_gemms(cfg, n_ctx, bt, batch, n_global, gemms,
                            decode=decode)
        if fam in ("moe", "mla_moe"):
            mo = cfg.moe
            n_moe = cfg.n_layers - mo.first_dense_layers
            if mo.first_dense_layers:
                _ffn_gemms(cfg, bt, mo.first_dense_layers, gemms)
            _moe_gemms(cfg, bt, n_moe, gemms)
        else:
            _ffn_gemms(cfg, bt, cfg.n_layers, gemms)
        layers_for_elec = cfg.n_layers

    gemms.append(Gemm(bt, cfg.d_model, cfg.vocab, 1))   # LM head

    elec = _elec_ops(cfg, n_ctx, bt, batch, layers_for_elec, decode)
    wb = _active_weight_bytes(cfg) if decode else _weight_bytes(cfg)
    max_act = bt * max(cfg.d_ff, 3 * cfg.d_model) * act_bits / 8.0
    act_io = bt * cfg.d_model * 2 * act_bits / 8.0
    return Workload(name=name, gemms=tuple(gemms), elec_ops=elec,
                    weight_bytes=float(wb), act_io_bytes=float(act_io),
                    max_act_bytes=float(max_act), batch=batch)


def prefill_workload(cfg: ModelConfig, seq: int, batch: int) -> Workload:
    return _build(cfg, f"{cfg.name}-prefill{seq}b{batch}", seq, batch)


def training_workload(cfg: ModelConfig, seq: int, batch: int) -> Workload:
    """Forward+backward ~ 3x forward GEMM MACs (standard accounting)."""
    fwd = _build(cfg, f"{cfg.name}-train{seq}b{batch}", seq, batch)
    gemms = tuple(Gemm(g.m, g.k, g.n, g.count * 3) for g in fwd.gemms)
    return Workload(name=fwd.name, gemms=gemms, elec_ops=fwd.elec_ops * 2,
                    weight_bytes=fwd.weight_bytes * 3,
                    act_io_bytes=fwd.act_io_bytes * 2,
                    max_act_bytes=fwd.max_act_bytes, batch=batch)


def serving_workload(cfg: ModelConfig, seq_len: int, batch: int,
                     new_tokens: int) -> Workload:
    """Decode of `new_tokens` tokens against a seq_len context: M = batch
    per GEMM per step, context-length score GEMMs, re-streamed (active)
    weights every step.

    The decode length is part of the workload *name* — two decode
    workloads of the same (seq, batch) but different `new_tokens` are
    different questions, and the serve layer's memo keys include the name,
    so the names must not collide.
    """
    one = _build(cfg, f"{cfg.name}-decode{seq_len}b{batch}n{new_tokens}",
                 1, batch, decode=True, n_ctx=seq_len)
    gemms = tuple(Gemm(g.m, g.k, g.n, g.count * new_tokens)
                  for g in one.gemms)
    return Workload(name=one.name, gemms=gemms,
                    elec_ops=one.elec_ops * new_tokens,
                    weight_bytes=one.weight_bytes * new_tokens,
                    act_io_bytes=one.act_io_bytes * new_tokens,
                    max_act_bytes=one.max_act_bytes, batch=batch)


def workload_for(cfg: ModelConfig, shape: ShapeConfig) -> Workload:
    """Lower a (model config, input shape) pair to a DxPTA `Workload`.

    `shape.kind` picks the extraction path; `shape.new_tokens` is the
    decode length ("decode" kind only). Historically the decode length was
    hard-coded to 32 here, which silently gave every decode shape —
    `decode_32k` and `long_500k` alike — the same generation length; now
    it threads through from the shape.
    """
    if shape.kind == "train":
        return training_workload(cfg, shape.seq_len, shape.global_batch)
    if shape.kind == "prefill":
        return prefill_workload(cfg, shape.seq_len, shape.global_batch)
    if shape.kind != "decode":
        raise ValueError(f"unknown shape kind {shape.kind!r}; pick "
                         f"'train', 'prefill' or 'decode'")
    return serving_workload(cfg, shape.seq_len, shape.global_batch,
                            new_tokens=shape.new_tokens)
