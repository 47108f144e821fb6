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
enc-dec family is `encdec.py`'s. Every entry point takes `rules`
(`parallel.sharding.Rules`; `NULL_RULES` by default, which changes
nothing) and constrains the residual stream, the K/V rows and the logits
where the reference does. With `remat=True` (the default, as in the
reference) and gradients enabled, each layer body runs under
`torch.utils.checkpoint` where the reference puts `jax.checkpoint`: every
layer of a stack, each hybrid group (its shared attention and Mamba layers,
with no checkpoint inside) and each Mamba tail layer. Recomputation
changes no value.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..parallel.sharding import NULL_RULES, shard
from . import mla as mla_mod
from . import moe as moe_mod
from . import rwkv as rwkv_mod
from . import ssd as ssd_mod
from .layers import (DTYPE, MLP, Attention, Embedding, RMSNorm, _param,
                     embed, matmul16, positions_like, softmax_xent, unembed)

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

def _moe_groups(rules) -> int:
    return getattr(rules, "moe_groups", 1) or 1


def _ffn(blk, cfg, h, rules=NULL_RULES):
    """(the block's FFN output, its MoE aux loss or None)."""
    if isinstance(blk, MoEBlock):
        return moe_mod.apply_moe_dispatch(
            blk.moe, cfg, h, rules, groups=_moe_groups(rules))
    return blk.mlp(h, rules), None


def _block_fwd(blk, cfg, x, positions, is_local=None, rules=NULL_RULES):
    h = blk.ln1(x)
    if isinstance(blk.attn, mla_mod.MLA):
        x = x + mla_mod.apply_mla(blk.attn, cfg, h, positions, rules)
    else:
        x = x + blk.attn(cfg, h, positions, is_local=is_local, rules=rules)
    x = shard(x, rules.resid)
    y, aux = _ffn(blk, cfg, blk.ln2(x), rules)
    return shard(x + y, rules.resid), aux


def _attn_prefill(blk, cfg, x, positions, is_local=None, rules=NULL_RULES,
                  kv_spec=None):
    """A GQA block over the prompt: (x, its K and V rows, constrained to
    `kv_spec`)."""
    h = blk.ln1(x)
    k, v = blk.attn.project_kv(cfg, h, positions)
    k, v = shard(k, kv_spec), shard(v, kv_spec)
    x = x + blk.attn(cfg, h, positions, kv=(k, v), kv_positions=positions,
                     is_local=is_local, rules=rules)
    return shard(x + _ffn(blk, cfg, blk.ln2(x), rules)[0], rules.resid), k, v


def _mla_prefill(blk, cfg, x, positions, rules=NULL_RULES):
    """An MLA block over the prompt: (x, its latent and rope-key rows)."""
    h = blk.ln1(x)
    c, r = mla_mod.latent_kv(blk.attn, cfg, h, positions)
    x = x + mla_mod.apply_mla(blk.attn, cfg, h, positions, rules)
    return shard(x + _ffn(blk, cfg, blk.ln2(x), rules)[0], rules.resid), c, r


def write_row(rows, pos: int, new):
    """`rows` (B, T, ...) with `new` (B, 1, ...) at `pos`: written in place
    into a plain tensor (the card's cache); on a DTensor, functionally (the
    reference's `dynamic_update_slice` is functional too), into a new
    DTensor of the same placements. A DTensor whose T is sharded over more
    than one device is written on its shards, with no collective
    (`_write_row_sharded`); one whose T is whole takes `slice_scatter`."""
    from torch.distributed.tensor import DTensor

    from ..parallel.sharding import split_dims
    if isinstance(rows, DTensor):
        if split_dims(rows, 1):
            return _write_row_sharded(rows, pos, new)
        return torch.slice_scatter(rows, new, dim=1, start=pos, end=pos + 1)
    rows[:, pos:pos + 1] = new
    return rows


def _write_row_sharded(rows, pos: int, new):
    """`write_row` on a DTensor whose T is split, in GSPMD's form of the
    reference's `dynamic_update_slice`: every shard runs the same clamped,
    masked one-row write into its local rows — at the local index of `pos`
    where it holds that row (`sharding.held_indices`: DTensor's own order
    of splits), else at a clamped index, writing back the row it holds
    there — so only the shard holding `pos` changes. `new` is laid out as
    `rows` is on every other dimension (its one row whole on every shard of
    T) first."""
    from torch.distributed.tensor import DTensor, Replicate

    from ..parallel.sharding import (as_dtensor, held_indices, local_index,
                                     redistribute, sharded_dim)
    mesh, pl = rows.device_mesh, tuple(rows.placements)
    new = redistribute(as_dtensor(new, mesh),
                       [Replicate() if sharded_dim(p) == 1 else p
                        for p in pl]).to_local()
    at = local_index(rows, 1, pos)
    hit = at is not None
    if not hit:
        held = held_indices(rows, 1)
        at = min(max(pos - held[0], 0), len(held) - 1)
    local = rows.to_local()
    src = new if hit else local[:, at:at + 1]
    out = torch.slice_scatter(local, src.to(local.dtype), dim=1, start=at,
                              end=at + 1)
    return DTensor.from_local(out, mesh, pl, run_check=False,
                              shape=rows.shape, stride=rows.stride())


def _attn_decode(blk, cfg, x, pos, q_pos, kv_pos, k_row, v_row,
                 is_local=None, rules=NULL_RULES):
    """One token through a GQA block, its K/V row written at `pos`.
    Returns (x, the K rows, the V rows)."""
    h = blk.ln1(x)
    k1, v1 = blk.attn.project_kv(cfg, h, q_pos)
    k_row = shard(write_row(k_row, pos, k1), rules.kv_cache)
    v_row = shard(write_row(v_row, pos, v1), rules.kv_cache)
    x = x + blk.attn(cfg, h, q_pos, kv=(k_row, v_row), kv_positions=kv_pos,
                     is_local=is_local, rules=rules)
    return x + _ffn(blk, cfg, blk.ln2(x), rules)[0], k_row, v_row


def _mla_decode(blk, cfg, x, pos, q_pos, kv_pos, c_row, r_row,
                rules=NULL_RULES):
    """One token through an MLA block (absorbed form), its latent and
    rope-key rows written at `pos`. Returns (x, the latent rows, the
    rope-key rows)."""
    h = blk.ln1(x)
    c1, r1 = mla_mod.latent_kv(blk.attn, cfg, h, q_pos)
    c_row = write_row(c_row, pos, c1)
    r_row = write_row(r_row, pos, r1)
    x = x + mla_mod.decode_mla(blk.attn, cfg, h, q_pos, c_row, r_row, kv_pos,
                               rules)
    return x + _ffn(blk, cfg, blk.ln2(x), rules)[0], c_row, r_row


def _mamba_groups(params: DecoderLM, cfg):
    """[(group index, its Mamba layers with their flat indices)]."""
    g, a, _ = _hybrid_dims(cfg)
    return [(gi, [(gi * a + j, params.mamba_groups[gi * a + j])
                  for j in range(a)]) for gi in range(g)]


def _rwkv_layer(layer, cfg, x, last_t=None, state=None, last_c=None,
                rules=NULL_RULES, resid=None):
    """(x, new state, last time-mix input, last channel-mix input); the
    residual stream constrained to `resid` after each half."""
    y, (lt, s) = rwkv_mod.apply_rwkv_time(
        layer.time, cfg, layer.ln1(x), last=last_t, state=state, rules=rules)
    x = shard(x + y, resid)
    y, lc = rwkv_mod.apply_rwkv_channel(layer.channel, cfg, layer.ln2(x),
                                        last=last_c, rules=rules)
    return shard(x + y, resid), s, lt, lc


# --------------------------------------------------------------------------
# Forward (training and scoring)
# --------------------------------------------------------------------------

def _embed_inputs(params: DecoderLM, cfg, batch):
    """tokens (+ stub modality embeddings) -> (x, positions, n_prefix)."""
    x = embed(params.embed.table, batch["tokens"])
    n_prefix = 0
    if cfg.n_prefix_embeds and "embeds" in batch:
        x = torch.cat([batch["embeds"].to(x.dtype), x], dim=1)
        n_prefix = batch["embeds"].shape[1]
    return x, positions_like(x), n_prefix


def _logits(params: DecoderLM, x):
    return unembed(params.head_table(), params.final_norm(x))


def remat_fn(fn, remat: bool):
    """`fn`, run under `torch.utils.checkpoint` (non-reentrant) when
    `remat` is set and autograd records: the reference's `jax.checkpoint`
    around a layer body. Its activations are recomputed in the backward
    pass instead of kept."""
    if not (remat and torch.is_grad_enabled()):
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def forward(params: DecoderLM, cfg: ModelConfig, batch, rules=NULL_RULES,
            remat: bool = True):
    """Full-sequence forward. Returns dict(logits (B, S, V) f32, aux_moe
    (the MoE layers' summed aux loss, 0.0 without MoE), n_prefix, and for
    mla_moe with MTP, mtp_logits)."""
    x, positions, n_prefix = _embed_inputs(params, cfg, batch)
    x = shard(x, rules.resid)
    fam = cfg.family
    auxs = []
    if fam == "hybrid_ssm":
        def mamba_body(layer, x):
            y = ssd_mod.apply_mamba(layer.m, cfg, layer.ln(x), rules=rules)
            return shard(x + y, rules.resid)

        def group_body(layers, x):
            x, _ = _block_fwd(params.shared_attn, cfg, x, positions,
                              rules=rules)
            for _, layer in layers:
                x = mamba_body(layer, x)
            return x

        group, tail = remat_fn(group_body, remat), remat_fn(mamba_body, remat)
        for _, layers in _mamba_groups(params, cfg):
            x = group(layers, x)
        for layer in params.mamba_tail:
            x = tail(layer, x)
    elif fam == "rwkv":
        body = remat_fn(lambda layer, x: _rwkv_layer(
            layer, cfg, x, rules=rules, resid=rules.resid)[0], remat)
        for layer in params.layers:
            x = body(layer, x)
    else:
        body = remat_fn(lambda blk, x, fl: _block_fwd(blk, cfg, x, positions,
                                                      fl, rules), remat)
        for blk, fl in zip(params.blocks(), _layer_flags(cfg)):
            x, aux = body(blk, x, fl)
            if aux is not None:
                auxs.append(aux)

    x = params.final_norm(x)
    table = params.head_table()
    out = {"logits": shard(unembed(table, x), rules.logits),
           "aux_moe": torch.stack(auxs).sum() if auxs else 0.0,
           "n_prefix": n_prefix}
    if params.mtp is not None:
        # DeepSeek-V3 MTP at depth 1: the trunk state with the embedding of
        # the *next* token predicts token t + 2 (a plain bf16 product)
        mtp = params.mtp
        emb_next = torch.roll(embed(params.embed.table, batch["tokens"]), -1,
                              dims=1)
        h = matmul16(torch.cat([mtp.norm_h(x), mtp.norm_e(emb_next)],
                               dim=-1), mtp.proj)
        h, _ = _block_fwd(mtp.block, cfg, h.to(x.dtype), positions,
                          rules=rules)
        out["mtp_logits"] = shard(unembed(table, h), rules.logits)
    return out


def lm_loss(params: DecoderLM, cfg: ModelConfig, batch, rules=NULL_RULES,
            remat: bool = True, aux_coeff=0.01, mtp_coeff=0.3):
    """Next-token loss (+ the MoE aux loss + MTP). Returns (loss, the
    forward's dict)."""
    out = forward(params, cfg, batch, rules, remat)
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


def prefill(params: DecoderLM, cfg: ModelConfig, batch, rules=NULL_RULES):
    """Returns (last-position f32 logits (B, V), the cache of the prompt's
    length, laid out as `init_cache`'s)."""
    x, positions, _ = _embed_inputs(params, cfg, batch)
    x = shard(x, rules.resid)
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        ks, vs = [], []
        for blk, fl in zip(params.layers, _layer_flags(cfg)):
            x, k, v = _attn_prefill(blk, cfg, x, positions, fl, rules,
                                    rules.kv_cache)
            ks.append(k)
            vs.append(v)
        cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    elif fam == "mla_moe":
        cs, rs = [], []
        for blk in params.blocks():
            x, c, r = _mla_prefill(blk, cfg, x, positions, rules)
            cs.append(c)
            rs.append(r)
        cache = {"c": torch.stack(cs), "rope": torch.stack(rs)}
    elif fam == "hybrid_ssm":
        ks, vs, hs, convs = [], [], [], []

        def mamba(layer, x, hs, convs):
            y, st = ssd_mod.apply_mamba(layer.m, cfg, layer.ln(x),
                                        return_state=True, rules=rules)
            hs.append(st["h"])
            convs.append(st["conv"])
            return shard(x + y, rules.resid)

        for _, layers in _mamba_groups(params, cfg):
            x, k, v = _attn_prefill(params.shared_attn, cfg, x, positions,
                                    rules=rules)
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
            x, s, lt, lc = _rwkv_layer(layer, cfg, x, rules=rules,
                                       resid=rules.resid)
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
    """One token through a Mamba layer. Returns (x, its new state rows)."""
    y, st = ssd_mod.decode_mamba(layer.m, cfg, layer.ln(x),
                                 {"h": h_row, "conv": conv_row})
    return x + y, st["h"], st["conv"]


class _Rows:
    """A decode step's view of one layer-stacked cache: row i read as
    `cache[name][i]`; `set` writes a layer's new rows back, in place into a
    plain cache (the card's), and on DTensors (the dry-run's sharded
    caches, which take no in-place write) restacked into a new cache entry
    at the end of the step, as the reference's layer scan returns it."""

    def __init__(self, cache):
        from torch.distributed.tensor import DTensor
        self.cache = cache
        self.functional = any(isinstance(t, DTensor) for t in cache.values())
        self.new = {}

    def set(self, name, i, row):
        if self.functional:
            self.new.setdefault(name, {})[i] = row
        elif row is not self.cache[name][i] and \
                row.data_ptr() != self.cache[name][i].data_ptr():
            self.cache[name][i].copy_(row)

    def result(self):
        for name, rows in self.new.items():
            self.cache[name] = torch.stack([rows[i]
                                            for i in range(len(rows))])
        return self.cache


def decode_step(params: DecoderLM, cfg: ModelConfig, tokens: torch.Tensor,
                pos: int, cache: Dict[str, torch.Tensor], rules=NULL_RULES):
    """tokens: (B, 1) int; pos: the current write index. Writes the new
    cache rows (and recurrent states) into `cache` and returns (f32 logits
    (B, V), cache)."""
    x = embed(params.embed.table, tokens)
    fam = cfg.family
    rows = cache.get("c" if fam == "mla_moe" else "k")  # None for rwkv
    if rows is not None:
        q_pos, kv_pos = _decode_positions(x.shape[0], rows.shape[2], pos,
                                          x.device)
    out = _Rows(cache)
    if fam in ("dense", "vlm", "moe"):
        for i, (blk, fl) in enumerate(zip(params.layers, _layer_flags(cfg))):
            x, k, v = _attn_decode(blk, cfg, x, pos, q_pos, kv_pos,
                                   cache["k"][i], cache["v"][i], fl, rules)
            out.set("k", i, k)
            out.set("v", i, v)
    elif fam == "mla_moe":
        for i, blk in enumerate(params.blocks()):
            x, c, r = _mla_decode(blk, cfg, x, pos, q_pos, kv_pos,
                                  cache["c"][i], cache["rope"][i], rules)
            out.set("c", i, c)
            out.set("rope", i, r)
    elif fam == "hybrid_ssm":
        for gi, layers in _mamba_groups(params, cfg):
            x, k, v = _attn_decode(params.shared_attn, cfg, x, pos, q_pos,
                                   kv_pos, cache["k"][gi], cache["v"][gi],
                                   rules=rules)
            out.set("k", gi, k)
            out.set("v", gi, v)
            for i, layer in layers:
                x, h, conv = _mamba_decode(layer, cfg, x, cache["h"][i],
                                           cache["conv"][i])
                out.set("h", i, h)
                out.set("conv", i, conv)
        for i, layer in enumerate(params.mamba_tail):
            x, h, conv = _mamba_decode(layer, cfg, x, cache["h_tail"][i],
                                       cache["conv_tail"][i])
            out.set("h_tail", i, h)
            out.set("conv_tail", i, conv)
    else:  # rwkv
        for i, layer in enumerate(params.layers):
            x, s, lt, lc = _rwkv_layer(layer, cfg, x, cache["last_t"][i],
                                       cache["s"][i], cache["last_c"][i],
                                       rules)
            out.set("s", i, s)
            out.set("last_t", i, lt)
            out.set("last_c", i, lc)
    return _logits(params, x)[:, 0], out.result()
