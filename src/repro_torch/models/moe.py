"""Mixture-of-Experts FFN (the port of `repro/models/moe.py`).

Routing: softmax top-k (OLMoE) or sigmoid + aux-loss-free bias top-k with a
shared expert (DeepSeek-V3). Dispatch: the token -> expert assignments are
packed into a capacity-bounded (E, C, D) buffer (assignments over capacity
drop to the residual path), run through batched expert GEMMs and combined
back with their routing weights. Two dispatches, as in the reference: the
stable sort (`apply_moe`, the default) and GShard's per-group cumsum
(`apply_moe_cumsum`); `apply_moe_dispatch(..., mode=)` picks one per call,
the module default `DISPATCH_MODE` (the reference's) where `mode` is None
(`launch.dryrun.apply_perf_flags` sets it). Under
sharding rules the (E, C, D) buffer and the experts' output are constrained
to `rules.expert_tokens` (the cumsum dispatch's (G, E, C, D) ones to groups
over the data axes and experts over the EP axes), as in the reference.

Bit-level choices, each the reference's:
  * top-k keeps the lower expert id first on ties (`jax.lax.top_k`): a
    stable descending sort, never `torch.topk`, whose order on ties is
    unspecified (sigmoid scores saturate to 1.0 in f32 and tie);
  * the capacity is computed in Python from the token count;
  * kept rows enter the buffer by an index write (dropped ones into a
    spare row the experts never read), and each token's k expert outputs
    are summed in bf16 in the reference's scatter order
    (ascending expert id for the sort dispatch, top-k order for cumsum),
    rounding at each add: no atomic adds, whose bf16 order changes from
    run to run on a card.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..parallel.sharding import (NULL_RULES, replicated, shard, sharded_dim,
                                 unshard)
from .layers import (DTYPE, MLP, _normal_, _param, einsum32, mlp_specs,
                     sigmoid, silu)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class MoE(nn.Module):
    """router (d, E) f32, wi/wg (E, d, d_expert), wo (E, d_expert, d);
    route_bias (E,) f32 with `aux_free_bias`; the shared expert `shared`
    (an MLP of width (d_shared or d_expert) * n_shared) with `n_shared`."""

    def __init__(self, cfg, device=None):
        super().__init__()
        mo, d = cfg.moe, cfg.d_model
        self.router = _param((d, mo.n_experts), device, torch.float32)
        self.wi = _param((mo.n_experts, d, mo.d_expert), device)
        self.wg = _param((mo.n_experts, d, mo.d_expert), device)
        self.wo = _param((mo.n_experts, mo.d_expert, d), device)
        self.route_bias = (_param((mo.n_experts,), device, torch.float32)
                           if mo.aux_free_bias else None)
        self.shared = (MLP(d, (mo.d_shared or mo.d_expert) * mo.n_shared,
                           device=device) if mo.n_shared else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        d, e = self.router.shape
        d_expert = self.wi.shape[-1]
        with torch.no_grad():
            _normal_(self.router, generator, d ** -0.5)
            _normal_(self.wi, generator, d ** -0.5)
            _normal_(self.wg, generator, d ** -0.5)
            _normal_(self.wo, generator, d_expert ** -0.5)
            if self.route_bias is not None:
                self.route_bias.zero_()


def moe_specs(cfg, rules):
    s = {"router": rules.replicated, "wi": rules.w_expert_in,
         "wg": rules.w_expert_in, "wo": rules.w_expert_out,
         "route_bias": rules.replicated}
    if cfg.moe.n_shared:
        s["shared"] = mlp_specs(rules)
    return s


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """`jax.lax.top_k` over the last axis: the k largest values and their
    indices, the lower index first among equal values."""
    vals, ids = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def route(p: MoE, cfg, xf: torch.Tensor):
    """xf: (T, D) f32 -> (weights (T, k) f32, expert ids (T, k) int64,
    aux scalar)."""
    mo = cfg.moe
    logits = xf @ p.router                                  # (T, E) f32
    if mo.aux_free_bias:
        scores = sigmoid(logits)
        _, ids = top_k(scores + p.route_bias, mo.top_k)     # bias steers
        w = torch.gather(scores, -1, ids)                   # weights do not
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        w = w * mo.route_scale
        probs = scores / torch.clamp(scores.sum(-1, keepdim=True), min=1e-9)
    else:
        probs = torch.softmax(logits, dim=-1)
        w, ids = top_k(probs, mo.top_k)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance aux loss (monitored; optional in training)
    load = torch.nn.functional.one_hot(ids[:, 0], mo.n_experts).float() \
        .mean(0)
    aux = mo.n_experts * torch.sum(load * probs.mean(0))
    return w, ids, aux


def _experts(p: MoE, buf: torch.Tensor) -> torch.Tensor:
    """The batched expert FFN over a (..., E, C, D) bf16 buffer."""
    h = einsum32("...ecd,edf->...ecf", buf, p.wi).to(buf.dtype)
    g = einsum32("...ecd,edf->...ecf", buf, p.wg).to(buf.dtype)
    return einsum32("...ecf,efd->...ecd", h * silu(g), p.wo).to(buf.dtype)


def _or_spare(keep, dest, spare: int):
    """Buffer rows for an index write: the kept assignments' (unique)
    destinations, the dropped ones' the spare row `spare`, which the
    experts never read. No boolean-mask indexing, whose result size the
    host must wait for."""
    return torch.where(keep, dest, torch.full_like(dest, spare))


def _put_rows(buf, index, rows):
    """`buf[index] = rows`: in place on a plain tensor; on a DTensor the
    out-of-place `index_put` (DTensor has no strategy for the in-place
    one, and the dry-run's gather fallback retries functional ops only)."""
    from torch.distributed.tensor import DTensor
    if isinstance(buf, DTensor):
        return buf.index_put(index, rows)
    buf[index] = rows
    return buf


def _merged(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`x` with dimensions `dim` and `dim + 1` merged into one. Where the
    second is sharded and the first is longer than one, the second is
    gathered first: no flatten keeps it a plain shard (DTensor gives it a
    `_StridedShard`, or refuses it: torch 2.11, even over one device), and
    the dispatch gathers the rows anyway (its row reads by index and its
    `searchsorted` run on whole operands)."""
    if x.shape[dim] > 1 and any(sharded_dim(p) == dim + 1
                                for p in getattr(x, "placements", ())):
        x = unshard(x, (dim + 1,))
    shape = tuple(x.shape)
    return x.reshape(shape[:dim] + (shape[dim] * shape[dim + 1],)
                     + shape[dim + 2:])


def _combine(contrib: torch.Tensor) -> torch.Tensor:
    """(T, k, D) bf16 -> (T, D): each token's k contributions added in
    order into a zero bf16 row, rounding at each add (the reference's
    scatter-add into a bf16 buffer)."""
    out = torch.zeros_like(contrib[:, 0])
    for j in range(contrib.shape[1]):
        out = out + contrib[:, j]
    return out


def _shared(p: MoE, x: torch.Tensor, out: torch.Tensor,
            rules) -> torch.Tensor:
    return out if p.shared is None else out + p.shared(x, rules)


def apply_moe(p: MoE, cfg, x: torch.Tensor, rules=NULL_RULES):
    """The sort dispatch. x: (B, S, D) -> ((B, S, D), aux scalar)."""
    mo = cfg.moe
    b, s, d = x.shape
    t, k, n_e = b * s, mo.top_k, mo.n_experts
    xf = _merged(x, 0)
    w, ids, aux = route(p, cfg, xf.float())

    e_flat = ids.reshape(t * k)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    tok_sorted = order // k                     # = repeat(arange(t), k)[order]
    w_sorted = w.reshape(t * k).to(DTYPE)[order]

    cap = _round_up(int(t * k / n_e * mo.capacity_factor) or 1, 8)
    # searchsorted has no DTensor sharding strategy: under sharding rules
    # it runs replicated (`replicated`, DTensor's local_map)
    starts = replicated(torch.searchsorted, e_sorted,
                        torch.arange(n_e, device=x.device))
    pos_in_e = torch.arange(t * k, device=x.device) - starts[e_sorted]
    keep = pos_in_e < cap
    dest = e_sorted * cap + torch.clamp(pos_in_e, 0, cap - 1)

    buf = _put_rows(xf.new_zeros((n_e * cap + 1, d)),
                    (_or_spare(keep, dest, n_e * cap),), xf[tok_sorted])
    buf = shard(buf[:-1].reshape(n_e, cap, d), rules.expert_tokens)
    y = _merged(shard(_experts(p, buf), rules.expert_tokens), 0)

    y_sorted = y[dest] * (w_sorted * keep.to(DTYPE))[:, None]
    # Back to (token, k) in ascending expert order: a token's k assignments
    # lie in the sorted list in that order (distinct ids, stable sort).
    by_token = torch.argsort(tok_sorted, stable=True)
    out = _combine(y_sorted[by_token].reshape(t, k, d))
    return _shared(p, x, out.reshape(b, s, d).to(x.dtype), rules), aux


def apply_moe_cumsum(p: MoE, cfg, x: torch.Tensor, rules=NULL_RULES,
                     groups: int = 1):
    """GShard-style capacity dispatch: tokens stay in `groups` fixed groups,
    and an assignment's position in its expert comes from a per-group
    cumsum over one-hot assignments (no sort)."""
    mo = cfg.moe
    b, s, d = x.shape
    t, k, n_e = b * s, mo.top_k, mo.n_experts
    xf = _merged(x, 0)
    w, ids, aux = route(p, cfg, xf.float())

    if t % groups:
        groups = 1
    g_sz = t * k // groups
    cap = _round_up(int(g_sz / n_e * mo.capacity_factor) or 1, 8)

    e_flat = ids.reshape(groups, g_sz)
    onehot = torch.nn.functional.one_hot(e_flat, n_e)       # (G, gk, E)
    pos = ((torch.cumsum(onehot, dim=1) - 1) * onehot).sum(-1)
    keep = pos < cap
    dest = e_flat * cap + torch.clamp(pos, 0, cap - 1)      # (G, gk)

    tok_local = torch.arange(g_sz, device=x.device) // k
    xg = xf.reshape(groups, t // groups, d)
    buf = xf.new_zeros((groups, n_e * cap + 1, d))
    g_ids = torch.arange(groups, device=x.device)[:, None]
    buf = _put_rows(buf, (g_ids, _or_spare(keep, dest, n_e * cap)),
                    xg[:, tok_local])
    buf = shard(buf[:, :-1].reshape(groups, n_e, cap, d), _group_spec(rules))
    y = _merged(shard(_experts(p, buf), _group_spec(rules)), 1)

    y_tok = torch.gather(y, 1, dest[..., None].expand(groups, g_sz, d))
    y_tok = y_tok * (w.reshape(groups, g_sz).to(y.dtype)
                     * keep.to(y.dtype))[..., None]
    # a group's assignments are (token, j) in flat order: the reference's
    # scatter adds a token's k outputs in top-k order
    out = _combine(y_tok.reshape(t, k, d))
    return _shared(p, x, out.reshape(b, s, d).to(x.dtype), rules), aux


def _group_spec(rules):
    """(G, E, C, D) spec: groups over the data axes, experts over the EP
    axes (an axis EP uses leaves the group dim: serving-time EP can span
    the whole mesh, and a mesh axis shards one dim)."""
    if rules.model_axis is None:
        return None
    ep = rules.ep_axes
    d_axes = tuple(a for a in (rules._d() or ()) if a not in ep)
    return (d_axes or None, ep, None, None)


DISPATCH_MODE = "sort"  # "sort" (baseline) | "cumsum" (GShard-style)


def apply_moe_dispatch(p: MoE, cfg, x: torch.Tensor, rules=NULL_RULES,
                       groups: int = 1, mode=None):
    """The MoE FFN by the dispatch `mode` names ("sort" or "cumsum";
    None: `DISPATCH_MODE`)."""
    mode = mode or DISPATCH_MODE
    if mode == "cumsum":
        return apply_moe_cumsum(p, cfg, x, rules, groups)
    if mode != "sort":
        raise ValueError(f"unknown MoE dispatch mode {mode!r}")
    return apply_moe(p, cfg, x, rules)
