"""Decoder-LM assembly for every decoder family (the port of
`repro/models/lm.py`): init_params, forward, lm_loss, init_cache, prefill,
decode_step.

Layers are `nn.ModuleList`s walked in a Python loop, where the reference
scans stacked pytrees with `lax.scan`; each family has its own block
modules, and the caches keep the reference's layer-stacked layouts:

  * dense, vlm  — `Block`s; {"k", "v"}: (L, B, T, Hkv, Dh) bf16. gemma3's
    5:1 sliding-window pattern and h2o-danube's all-local one come
    through the per-layer `is_local` flag (`swa_flags`);
  * moe         — `MoEBlock`s (attention + routed experts); {"k", "v"};
  * mla_moe     — `dense_layers` (MLA `Block`s) then `moe_layers` (MLA
    `MoEBlock`s), and the multi-token-prediction head `mtp`;
    {"c": (L, B, T, kv_lora_rank), "rope": (L, B, T, rope_dim)}, the
    rank-compressed latent cache decode attends against (absorbed form);
  * hybrid_ssm  — g = n_layers // attn_every groups of one `shared_attn`
    block application and `attn_every` `MambaLayer`s (`mamba_groups`, the
    reference's (g, a) stack flattened group by group), then the
    `mamba_tail`; {"h": (g a, B, H, d_state, Dh) f32, "conv": (g a, B,
    d_conv - 1, conv_dim), "k", "v": (g, B, T, Hkv, Dh)} and, with a tail,
    "h_tail", "conv_tail";
  * rwkv        — `RWKVLayer`s (time mix, channel mix); {"s": (L, B, H, K,
    K) f32, "last_t", "last_c": (L, B, 1, d)}.

`decode_step` writes the new cache rows and states into the cache in place
(the reference returns an updated copy) and returns the same dict. The
enc-dec family is `encdec.py`'s. `forward` takes no sharding rules and no
rematerialisation flag: the port runs on one card, and rematerialisation
belongs to training.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import mla as mla_mod
from . import moe as moe_mod
from . import rwkv as rwkv_mod
from . import ssd as ssd_mod
from .layers import (DTYPE, MLP, Attention, Embedding, RMSNorm, _param,
                     embed, softmax_xent, unembed)

DECODER_FAMILIES = ("dense", "vlm", "moe", "mla_moe", "hybrid_ssm", "rwkv")


# --------------------------------------------------------------------------
# Modules
# --------------------------------------------------------------------------

class Block(nn.Module):
    """One pre-norm transformer block: ln1, attn (GQA, or MLA with `mla`),
    ln2, mlp."""

    def __init__(self, cfg: ModelConfig, device=None, mla: bool = False):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.attn = (mla_mod.MLA(cfg, device) if mla
                     else Attention(cfg, device))
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.act, device)


class MoEBlock(nn.Module):
    """A block whose FFN is the routed experts: ln1, attn (GQA or MLA),
    ln2, moe."""

    def __init__(self, cfg: ModelConfig, device=None, mla: bool = False):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.attn = (mla_mod.MLA(cfg, device) if mla
                     else Attention(cfg, device))
        self.moe = moe_mod.MoE(cfg, device)


class MambaLayer(nn.Module):
    """ln, then the Mamba-2 mixer m, on the residual stream."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.m = ssd_mod.Mamba(cfg, device)


class RWKVLayer(nn.Module):
    """ln1, time mix, ln2, channel mix."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.time = rwkv_mod.RWKVTime(cfg, device)
        self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.channel = rwkv_mod.RWKVChannel(cfg, device)


class MTP(nn.Module):
    """DeepSeek-V3's multi-token prediction at depth 1: proj (2d, d), an
    MLA block, norm_h (trunk state) and norm_e (next-token embedding)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.proj = _param((2 * cfg.d_model, cfg.d_model), device)
        self.block = Block(cfg, device, mla=True)
        self.norm_h = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.norm_e = RMSNorm(cfg.d_model, cfg.norm_eps, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The reference draws N(0, 1), rounds it to bf16 and scales it in
        bf16 (not `_normal`'s scale-then-round)."""
        two_d, d = self.proj.shape
        draw = torch.randn((two_d, d), generator=generator,
                           device=self.proj.device, dtype=torch.float32)
        with torch.no_grad():
            self.proj.copy_(draw.to(DTYPE) * d ** -0.5)


class DecoderLM(nn.Module):
    """embed, final_norm, head (unless the embeddings are tied) and the
    family's layer stacks: the reference's parameter pytree as modules."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        fam = cfg.family
        if fam not in DECODER_FAMILIES:
            raise ValueError(f"DecoderLM builds the decoder families "
                             f"{DECODER_FAMILIES}, not {fam!r} ({cfg.name})")
        self.cfg = cfg
        self.embed = Embedding(cfg.vocab, cfg.d_model, device)
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, device)
        self.head = (None if cfg.tie_embeddings
                     else Embedding(cfg.vocab, cfg.d_model, device))
        self.mtp = None
        if fam in ("dense", "vlm"):
            self.layers = nn.ModuleList(Block(cfg, device)
                                        for _ in range(cfg.n_layers))
        elif fam == "moe":
            self.layers = nn.ModuleList(MoEBlock(cfg, device)
                                        for _ in range(cfg.n_layers))
        elif fam == "mla_moe":
            nd = cfg.moe.first_dense_layers
            self.dense_layers = nn.ModuleList(
                Block(cfg, device, mla=True) for _ in range(nd))
            self.moe_layers = nn.ModuleList(
                MoEBlock(cfg, device, mla=True)
                for _ in range(cfg.n_layers - nd))
            if cfg.mtp_depth:
                self.mtp = MTP(cfg, device)
        elif fam == "hybrid_ssm":
            g, a, tail = _hybrid_dims(cfg)
            self.mamba_groups = nn.ModuleList(MambaLayer(cfg, device)
                                              for _ in range(g * a))
            self.mamba_tail = nn.ModuleList(MambaLayer(cfg, device)
                                            for _ in range(tail))
            self.shared_attn = Block(cfg, device)
        else:  # rwkv
            self.layers = nn.ModuleList(RWKVLayer(cfg, device)
                                        for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def head_table(self) -> torch.Tensor:
        return (self.embed if self.head is None else self.head).table

    def blocks(self) -> List[nn.Module]:
        """The attention blocks in order (dense, vlm, moe, mla_moe)."""
        if self.cfg.family == "mla_moe":
            return list(self.dense_layers) + list(self.moe_layers)
        return list(self.layers)


def _hybrid_dims(cfg):
    """(groups g, attn_every a, tail layers) of a hybrid_ssm config."""
    a = cfg.ssm.attn_every
    g = cfg.n_layers // a
    return g, a, cfg.n_layers - g * a


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> DecoderLM:
    """Random parameters on `device`, drawn from `generator` (a
    torch.Generator on that device) with the reference's scales: norms 1,
    biases 0, embeddings N(0, 0.02^2), input projections N(0, 1/fan_in),
    output projections N(0, 1/fan_in of their own input), and each
    family's constants as the reference sets them (Mamba's a_log 0,
    d_skip 1, dt_bias 0; RWKV's w_base -1, u 0; the MoE route bias 0)."""
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


# --------------------------------------------------------------------------
# Blocks
# --------------------------------------------------------------------------

def _ffn(blk, cfg, h):
    """(the block's FFN output, its MoE aux loss or None)."""
    if isinstance(blk, MoEBlock):
        return moe_mod.apply_moe_dispatch(blk.moe, cfg, h)
    return blk.mlp(h), None


def _block_fwd(blk, cfg, x, positions, is_local=None):
    h = blk.ln1(x)
    if isinstance(blk.attn, mla_mod.MLA):
        x = x + mla_mod.apply_mla(blk.attn, cfg, h, positions)
    else:
        x = x + blk.attn(cfg, h, positions, is_local=is_local)
    y, aux = _ffn(blk, cfg, blk.ln2(x))
    return x + y, aux


def _attn_prefill(blk, cfg, x, positions, is_local=None):
    """A GQA block over the prompt: (x, its K and V rows)."""
    h = blk.ln1(x)
    k, v = blk.attn.project_kv(cfg, h, positions)
    x = x + blk.attn(cfg, h, positions, kv=(k, v), kv_positions=positions,
                     is_local=is_local)
    return x + _ffn(blk, cfg, blk.ln2(x))[0], k, v


def _mla_prefill(blk, cfg, x, positions):
    """An MLA block over the prompt: (x, its latent and rope-key rows)."""
    h = blk.ln1(x)
    c, r = mla_mod.latent_kv(blk.attn, cfg, h, positions)
    x = x + mla_mod.apply_mla(blk.attn, cfg, h, positions)
    return x + _ffn(blk, cfg, blk.ln2(x))[0], c, r


def _attn_decode(blk, cfg, x, pos, q_pos, kv_pos, k_row, v_row,
                 is_local=None):
    """One token through a GQA block, its K/V row written at `pos`."""
    h = blk.ln1(x)
    k1, v1 = blk.attn.project_kv(cfg, h, q_pos)
    k_row[:, pos:pos + 1] = k1
    v_row[:, pos:pos + 1] = v1
    x = x + blk.attn(cfg, h, q_pos, kv=(k_row, v_row), kv_positions=kv_pos,
                     is_local=is_local)
    return x + _ffn(blk, cfg, blk.ln2(x))[0]


def _mla_decode(blk, cfg, x, pos, q_pos, kv_pos, c_row, r_row):
    """One token through an MLA block (absorbed form), its latent and
    rope-key rows written at `pos`."""
    h = blk.ln1(x)
    c1, r1 = mla_mod.latent_kv(blk.attn, cfg, h, q_pos)
    c_row[:, pos:pos + 1] = c1
    r_row[:, pos:pos + 1] = r1
    x = x + mla_mod.decode_mla(blk.attn, cfg, h, q_pos, c_row, r_row, kv_pos)
    return x + _ffn(blk, cfg, blk.ln2(x))[0]


def _mamba_groups(params: DecoderLM, cfg):
    """[(group index, its Mamba layers with their flat indices)]."""
    g, a, _ = _hybrid_dims(cfg)
    return [(gi, [(gi * a + j, params.mamba_groups[gi * a + j])
                  for j in range(a)]) for gi in range(g)]


def _rwkv_layer(layer, cfg, x, last_t=None, state=None, last_c=None):
    """(x, new state, last time-mix input, last channel-mix input)."""
    y, (lt, s) = rwkv_mod.apply_rwkv_time(layer.time, cfg, layer.ln1(x),
                                          last=last_t, state=state)
    x = x + y
    y, lc = rwkv_mod.apply_rwkv_channel(layer.channel, cfg, layer.ln2(x),
                                        last=last_c)
    return x + y, s, lt, lc


# --------------------------------------------------------------------------
# Forward (scoring; training's forward without rematerialisation)
# --------------------------------------------------------------------------

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


def forward(params: DecoderLM, cfg: ModelConfig, batch):
    """Full-sequence forward. Returns dict(logits (B, S, V) f32, aux_moe
    (the MoE layers' summed aux loss, 0.0 without MoE), n_prefix, and for
    mla_moe with MTP, mtp_logits)."""
    x, positions, n_prefix = _embed_inputs(params, cfg, batch)
    fam = cfg.family
    auxs = []
    if fam == "hybrid_ssm":
        for _, layers in _mamba_groups(params, cfg):
            x, _ = _block_fwd(params.shared_attn, cfg, x, positions)
            for _, layer in layers:
                x = x + ssd_mod.apply_mamba(layer.m, cfg, layer.ln(x))
        for layer in params.mamba_tail:
            x = x + ssd_mod.apply_mamba(layer.m, cfg, layer.ln(x))
    elif fam == "rwkv":
        for layer in params.layers:
            x = _rwkv_layer(layer, cfg, x)[0]
    else:
        for blk, fl in zip(params.blocks(), _layer_flags(cfg)):
            x, aux = _block_fwd(blk, cfg, x, positions, fl)
            if aux is not None:
                auxs.append(aux)

    x = params.final_norm(x)
    table = params.head_table()
    out = {"logits": unembed(table, x),
           "aux_moe": torch.stack(auxs).sum() if auxs else 0.0,
           "n_prefix": n_prefix}
    if params.mtp is not None:
        # DeepSeek-V3 MTP at depth 1: the trunk state with the embedding of
        # the *next* token predicts token t + 2 (a plain bf16 product)
        mtp = params.mtp
        emb_next = torch.roll(embed(params.embed.table, batch["tokens"]), -1,
                              dims=1)
        h = torch.cat([mtp.norm_h(x), mtp.norm_e(emb_next)], dim=-1) \
            @ mtp.proj
        h, _ = _block_fwd(mtp.block, cfg, h.to(x.dtype), positions)
        out["mtp_logits"] = unembed(table, h)
    return out


def lm_loss(params: DecoderLM, cfg: ModelConfig, batch, aux_coeff=0.01,
            mtp_coeff=0.3):
    """Next-token loss (+ the MoE aux loss + MTP). Returns (loss, the
    forward's dict)."""
    out = forward(params, cfg, batch)
    tokens = batch["tokens"]
    npre = out["n_prefix"]
    # predict tokens[:, 1:] from positions [npre : -1]
    loss = softmax_xent(out["logits"][:, npre:-1], tokens[:, 1:],
                        batch.get("loss_mask"))
    if "mtp_logits" in out:
        loss = loss + mtp_coeff * softmax_xent(
            out["mtp_logits"][:, npre:-2], tokens[:, 2:])
    return loss + aux_coeff * out["aux_moe"], out


# --------------------------------------------------------------------------
# Cache, prefill, decode
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device) -> Dict[str, torch.Tensor]:
    """The zeroed layer-stacked cache of the family (module docstring)."""
    fam = cfg.family

    def zeros(*shape, dtype=DTYPE):
        return torch.zeros(shape, dtype=dtype, device=device)

    kv = (cfg.n_kv_heads, cfg.resolved_head_dim)
    if fam in ("dense", "vlm", "moe"):
        return {"k": zeros(cfg.n_layers, batch, max_len, *kv),
                "v": zeros(cfg.n_layers, batch, max_len, *kv)}
    if fam == "mla_moe":
        m = cfg.mla
        return {"c": zeros(cfg.n_layers, batch, max_len, m.kv_lora_rank),
                "rope": zeros(cfg.n_layers, batch, max_len, m.rope_head_dim)}
    if fam == "hybrid_ssm":
        g, a, tail = _hybrid_dims(cfg)
        state = ssd_mod.init_mamba_state(cfg, batch, device)
        h, conv = state["h"].shape, state["conv"].shape
        cache = {"h": zeros(g * a, *h, dtype=torch.float32),
                 "conv": zeros(g * a, *conv),
                 "k": zeros(g, batch, max_len, *kv),
                 "v": zeros(g, batch, max_len, *kv)}
        if tail:
            cache["h_tail"] = zeros(tail, *h, dtype=torch.float32)
            cache["conv_tail"] = zeros(tail, *conv)
        return cache
    if fam == "rwkv":
        kd = cfg.d_model // cfg.n_heads
        return {"s": zeros(cfg.n_layers, batch, cfg.n_heads, kd, kd,
                           dtype=torch.float32),
                "last_t": zeros(cfg.n_layers, batch, 1, cfg.d_model),
                "last_c": zeros(cfg.n_layers, batch, 1, cfg.d_model)}
    raise ValueError(f"init_cache: family {fam!r} is not a decoder family")


def prefill(params: DecoderLM, cfg: ModelConfig, batch):
    """Returns (last-position f32 logits (B, V), the cache of the prompt's
    length, laid out as `init_cache`'s)."""
    x, positions, _ = _embed_inputs(params, cfg, batch)
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        ks, vs = [], []
        for blk, fl in zip(params.layers, _layer_flags(cfg)):
            x, k, v = _attn_prefill(blk, cfg, x, positions, fl)
            ks.append(k)
            vs.append(v)
        cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    elif fam == "mla_moe":
        cs, rs = [], []
        for blk in params.blocks():
            x, c, r = _mla_prefill(blk, cfg, x, positions)
            cs.append(c)
            rs.append(r)
        cache = {"c": torch.stack(cs), "rope": torch.stack(rs)}
    elif fam == "hybrid_ssm":
        ks, vs, hs, convs = [], [], [], []

        def mamba(layer, x, hs, convs):
            y, st = ssd_mod.apply_mamba(layer.m, cfg, layer.ln(x),
                                        return_state=True)
            hs.append(st["h"])
            convs.append(st["conv"])
            return x + y

        for _, layers in _mamba_groups(params, cfg):
            x, k, v = _attn_prefill(params.shared_attn, cfg, x, positions)
            ks.append(k)
            vs.append(v)
            for _, layer in layers:
                x = mamba(layer, x, hs, convs)
        cache = {"h": torch.stack(hs), "conv": torch.stack(convs),
                 "k": torch.stack(ks), "v": torch.stack(vs)}
        if len(params.mamba_tail):
            hs, convs = [], []
            for layer in params.mamba_tail:
                x = mamba(layer, x, hs, convs)
            cache["h_tail"] = torch.stack(hs)
            cache["conv_tail"] = torch.stack(convs)
    else:  # rwkv
        ss, lts, lcs = [], [], []
        for layer in params.layers:
            x, s, lt, lc = _rwkv_layer(layer, cfg, x)
            ss.append(s)
            lts.append(lt)
            lcs.append(lc)
        cache = {"s": torch.stack(ss), "last_t": torch.stack(lts),
                 "last_c": torch.stack(lcs)}
    return _logits(params, x[:, -1:])[:, 0], cache


def _decode_positions(batch_size: int, max_len: int, pos: int, device):
    q_pos = torch.full((batch_size, 1), pos, dtype=torch.int32, device=device)
    kv_pos = torch.arange(max_len, dtype=torch.int32,
                          device=device).expand(batch_size, max_len)
    return q_pos, kv_pos


def _mamba_decode(layer, cfg, x, h_row, conv_row):
    """One token through a Mamba layer; its state rows updated in place."""
    y, st = ssd_mod.decode_mamba(layer.m, cfg, layer.ln(x),
                                 {"h": h_row, "conv": conv_row})
    h_row.copy_(st["h"])
    conv_row.copy_(st["conv"])
    return x + y


def decode_step(params: DecoderLM, cfg: ModelConfig, tokens: torch.Tensor,
                pos: int, cache: Dict[str, torch.Tensor]):
    """tokens: (B, 1) int; pos: the current write index. Writes the new
    cache rows (and recurrent states) into `cache` and returns (f32 logits
    (B, V), cache)."""
    x = embed(params.embed.table, tokens)
    fam = cfg.family
    rows = cache.get("c" if fam == "mla_moe" else "k")  # None for rwkv
    if rows is not None:
        q_pos, kv_pos = _decode_positions(x.shape[0], rows.shape[2], pos,
                                          x.device)
    if fam in ("dense", "vlm", "moe"):
        for i, (blk, fl) in enumerate(zip(params.layers, _layer_flags(cfg))):
            x = _attn_decode(blk, cfg, x, pos, q_pos, kv_pos, cache["k"][i],
                             cache["v"][i], fl)
    elif fam == "mla_moe":
        for i, blk in enumerate(params.blocks()):
            x = _mla_decode(blk, cfg, x, pos, q_pos, kv_pos, cache["c"][i],
                            cache["rope"][i])
    elif fam == "hybrid_ssm":
        for gi, layers in _mamba_groups(params, cfg):
            x = _attn_decode(params.shared_attn, cfg, x, pos, q_pos, kv_pos,
                             cache["k"][gi], cache["v"][gi])
            for i, layer in layers:
                x = _mamba_decode(layer, cfg, x, cache["h"][i],
                                  cache["conv"][i])
        for i, layer in enumerate(params.mamba_tail):
            x = _mamba_decode(layer, cfg, x, cache["h_tail"][i],
                              cache["conv_tail"][i])
    else:  # rwkv
        for i, layer in enumerate(params.layers):
            x, s, lt, lc = _rwkv_layer(layer, cfg, x, cache["last_t"][i],
                                       cache["s"][i], cache["last_c"][i])
            cache["s"][i].copy_(s)
            cache["last_t"][i].copy_(lt)
            cache["last_c"][i].copy_(lc)
    return _logits(params, x)[:, 0], cache
