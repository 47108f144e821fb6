"""Sharding specs of the parameters, caches and batches (the port of
`repro/parallel/specs.py`).

`param_specs` is keyed by the port's parameter names
(`nn.Module.named_parameters`); a parameter inside a layer stack is one
layer's slice of the reference's stacked leaf, so its spec is the
reference's without the stack's leading layer axes (`interop.
reference_leaf` says where each name lies in the reference's tree). The
caches keep the reference's layer-stacked layouts, and their specs the
leading layer axis. `distribute_params` / `distribute_tensors` lay tensors
out as DTensors by these specs, each sanitized against its shape first (an
input must divide evenly, as GSPMD demands of the reference's inputs).
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

from ..configs.base import ModelConfig
from ..interop import reference_leaf
from ..models.layers import attention_specs, mlp_specs
from ..models.mla import mla_specs
from ..models.moe import moe_specs
from ..models.rwkv import rwkv_channel_specs, rwkv_time_specs
from ..models.ssd import mamba_specs
from .sharding import (Rules, Spec, axis_sizes, local_shape, placements,
                       register_product_strategies, sanitize_spec)


def _ln(rules):
    return {"scale": rules.replicated}


def _block_specs(cfg, rules, kind="attn", moe=False):
    s = {"ln1": _ln(rules), "ln2": _ln(rules)}
    s["attn"] = mla_specs(cfg, rules) if kind == "mla" \
        else attention_specs(rules)
    if moe:
        s["moe"] = moe_specs(cfg, rules)
    else:
        s["mlp"] = mlp_specs(rules)
    return s


def _spec_tree(cfg: ModelConfig, rules: Rules):
    """The reference's spec tree, one layer of each stack."""
    r = rules
    specs = {"embed": {"table": r.embed}, "final_norm": _ln(r)}
    if not cfg.tie_embeddings:
        specs["head"] = {"table": r.embed}
    fam = cfg.family
    if fam in ("dense", "vlm"):
        specs["layers"] = _block_specs(cfg, r)
    elif fam == "moe":
        specs["layers"] = _block_specs(cfg, r, moe=True)
    elif fam == "mla_moe":
        specs["dense_layers"] = _block_specs(cfg, r, kind="mla")
        specs["moe_layers"] = _block_specs(cfg, r, kind="mla", moe=True)
        if cfg.mtp_depth:
            specs["mtp"] = {"proj": r.w_col,
                            "block": _block_specs(cfg, r, kind="mla"),
                            "norm_h": _ln(r), "norm_e": _ln(r)}
    elif fam == "hybrid_ssm":
        layer = {"ln": _ln(r), "m": mamba_specs(r)}
        specs["mamba_groups"] = layer
        specs["mamba_tail"] = layer
        specs["shared_attn"] = _block_specs(cfg, r)
    elif fam == "rwkv":
        specs["layers"] = {"ln1": _ln(r), "time": rwkv_time_specs(r),
                           "ln2": _ln(r), "channel": rwkv_channel_specs(r)}
    elif fam == "encdec":
        enc = {"ln1": _ln(r), "attn": attention_specs(r), "ln2": _ln(r),
               "mlp": mlp_specs(r)}
        dec = {"ln1": _ln(r), "self_attn": attention_specs(r),
               "ln2": _ln(r), "cross_attn": attention_specs(r),
               "ln3": _ln(r), "mlp": mlp_specs(r)}
        specs = {"adapter": r.w_col, "enc_layers": enc,
                 "enc_norm": _ln(r), "embed": {"table": r.embed},
                 "dec_layers": dec, "final_norm": _ln(r),
                 "head": {"table": r.embed}}
    else:
        raise ValueError(fam)
    return specs


def param_specs(cfg: ModelConfig, rules: Rules, params=None
                ) -> Dict[str, Spec]:
    """{parameter name: its spec} for `models.init_params(cfg)`'s model
    (`params`, or one built on the meta device); a parameter with no spec
    in the reference's tree raises KeyError, as the reference's `_prune`
    does."""
    if params is None:
        from ..models import encdec, lm
        params = (encdec.EncDec if cfg.family == "encdec"
                  else lm.DecoderLM)(cfg, torch.device("meta"))
    tree = _spec_tree(cfg, rules)
    out = {}
    for name, _ in params.named_parameters():
        node = tree
        for key in reference_leaf(name, cfg)[0]:
            if key not in node:
                raise KeyError(f"no spec for param {key!r}")
            node = node[key]
        out[name] = node
    return out


def cache_specs(cfg: ModelConfig, rules: Rules) -> Dict[str, Spec]:
    """Specs of `models.init_cache(cfg, ...)`'s entries (leading layer
    axis included)."""
    r = rules
    kv = (None, *r.kv_cache)
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        return {"k": kv, "v": kv}
    if fam == "mla_moe":
        lat = (None, r.kv_cache[0], r.kv_cache[1], None)
        return {"c": lat, "rope": lat}
    if fam == "hybrid_ssm":
        st = (None, *r.ssm_state)
        conv = (None, r.kv_cache[0], None, r.model_axis)
        out = {"h": st, "conv": conv, "k": kv, "v": kv}
        if cfg.n_layers % cfg.ssm.attn_every:
            out["h_tail"] = st
            out["conv_tail"] = conv
        return out
    if fam == "rwkv":
        return {"s": (None, *r.ssm_state),
                "last_t": (None, r.kv_cache[0], None, r.model_axis),
                "last_c": (None, r.kv_cache[0], None, r.model_axis)}
    if fam == "encdec":
        return {"k": kv, "v": kv, "cross_k": kv, "cross_v": kv}
    raise ValueError(fam)


def batch_specs(cfg: ModelConfig, rules: Rules, kind: str = "train"
                ) -> Dict[str, Spec]:
    r = rules
    specs = {"tokens": (r.data_axes, None)}
    if cfg.family == "vlm":
        specs["embeds"] = (r.data_axes, None, None)
    if cfg.family == "encdec":
        specs["src_embeds"] = (r.data_axes, None, None)
    return specs


def distribute(t: torch.Tensor, spec, mesh):
    """`t` as a DTensor on `mesh` laid out by `spec` (None: replicated),
    sanitized against its shape. A meta tensor becomes a DTensor of meta
    shards (nothing is allocated), a DTensor is redistributed, and any
    other tensor is scattered from the full one (`distribute_tensor`)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    register_product_strategies()
    sizes = axis_sizes(mesh)
    spec = sanitize_spec(t.shape, spec if spec is not None else (), sizes)
    pl = placements(spec, mesh)
    if isinstance(t, DTensor):
        return t.redistribute(mesh, pl)
    if t.is_meta:
        local = torch.empty(local_shape(t.shape, spec, sizes), dtype=t.dtype,
                            device="meta")
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return distribute_tensor(t.detach(), mesh, pl)


def distribute_tensors(tensors: Mapping[str, torch.Tensor],
                       specs: Mapping[str, Spec], mesh) -> Dict:
    """{name: `distribute(tensor, specs[name], mesh)`}."""
    return {n: distribute(t, specs[n], mesh) for n, t in tensors.items()}


def distribute_params(model: torch.nn.Module, specs: Mapping[str, Spec],
                      mesh) -> torch.nn.Module:
    """Replace each parameter of `model` by its DTensor on `mesh`
    (`distribute`), keeping its requires_grad; returns `model`."""
    for name, p in list(model.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        setattr(mod, leaf, torch.nn.Parameter(distribute(p, specs[name], mesh),
                                              requires_grad=p.requires_grad))
    return model
