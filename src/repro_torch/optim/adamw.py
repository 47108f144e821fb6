"""AdamW + schedules (the port of `repro/optim/adamw.py`), op for op.

Not `torch.optim.AdamW`, whose update differs: it decays `p` by
`1 - lr * wd` before the step and folds the bias corrections into the step
size and `eps`. Here, as in the reference: global-norm clipping with
`+1e-9`, coupled weight decay (`wd * p` added to the update) on matrices
only, the warmup-cosine schedule, and moments kept in `moment_dtype`.

Parameters, gradients and moments are dicts keyed by name (a model's
`named_parameters()`; a missing or None gradient is zero, as the
reference's gradient of an unused parameter). With `model_cfg`, the names
are the port's module names and each one is the slice of a reference leaf
(`interop.reference_leaf`): weight decay then follows the reference leaf's
rank (a layer stack adds its layer axes, so a stacked norm scale is
decayed and an unstacked one is not), and `global_norm` sums per reference
leaf in the reference's leaf order. Without it, every tensor is a leaf of
its own, in sorted-name order. `apply` updates parameters and moments in
place.

Float32 parity with JAX's weak typing: every Python constant enters as a
float32 0-d tensor, folded in Python (float64) where the reference's
Python expression folds it (`1 - cfg.b1`) and rounded once; division is by
tensors (PyTorch's CUDA division by a Python scalar multiplies by its
reciprocal); no `addcmul`/`alpha=` (no fused multiply-add).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional

import torch

from ..models.layers import _f32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: Any = torch.float32
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor       # int32 0-d
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_ratio * lr (f32 0-d)."""
    dev = step.device
    step = step.to(torch.float32)
    one = _f32(1.0, dev)
    warm = torch.minimum(step / _f32(max(cfg.warmup_steps, 1), dev), one)
    prog = torch.clamp(
        (step - _f32(cfg.warmup_steps, dev))
        / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), dev), 0.0, 1.0)
    cos = _f32(0.5, dev) * (one + torch.cos(_f32(math.pi, dev) * prog))
    frac = _f32(cfg.min_lr_ratio, dev) + _f32(1 - cfg.min_lr_ratio, dev) * cos
    return _f32(cfg.lr, dev) * warm * frac


def init(cfg: AdamWConfig, params: Dict[str, torch.Tensor]) -> OptState:
    device = next(iter(params.values())).device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        mu={n: torch.zeros_like(p, dtype=cfg.moment_dtype)
            for n, p in params.items()},
        nu={n: torch.zeros_like(p, dtype=cfg.moment_dtype)
            for n, p in params.items()})


def _leaves(names, model_cfg):
    """[(leaf, [names of its slices in layer order])] in the reference's
    leaf order; each name a leaf of its own without `model_cfg`."""
    if model_cfg is None:
        return [(n, [n]) for n in sorted(names)]
    from ..interop import reference_order
    return reference_order(names, model_cfg)


def global_norm(tree: Dict[str, torch.Tensor], model_cfg=None):
    """sqrt of the sum over leaves, in leaf order, of each leaf's f32 sum of
    squares (a stacked leaf's sum adds its slices' sums)."""
    total = None
    for _, names in _leaves(tree, model_cfg):
        parts = [torch.sum(torch.square(tree[n].to(torch.float32)))
                 for n in names]
        leaf = torch.sum(torch.stack(parts))
        total = leaf if total is None else total + leaf
    return torch.sqrt(total)


def _ranks(params, model_cfg):
    if model_cfg is None:
        return {n: p.dim() for n, p in params.items()}
    from ..interop import reference_rank
    return {n: reference_rank(n, p, model_cfg) for n, p in params.items()}


@torch.no_grad()
def apply(cfg: AdamWConfig, params: Dict[str, torch.Tensor],
          grads: Dict[str, Optional[torch.Tensor]], state: OptState,
          model_cfg=None):
    """Returns (params, new_state, metrics {"grad_norm", "lr"}).

    Each parameter and moment is overwritten in place as its leaf is
    updated (rounded to its dtype as the reference's `astype` rounds), so
    one leaf's f32 temporaries live at a time and no second copy of the
    state is made — what training at a published width needs; the same
    dicts come back, the step as a new tensor."""
    dev = next(iter(params.values())).device
    grads = {n: (grads.get(n) if grads.get(n) is not None
                 else torch.zeros_like(p)) for n, p in params.items()}
    gnorm = global_norm(grads, model_cfg)
    if cfg.grad_clip > 0:
        scale = torch.minimum(_f32(1.0, dev), _f32(cfg.grad_clip, dev)
                              / (gnorm + _f32(1e-9, dev)))
    else:
        scale = _f32(1.0, dev)
    step = state.step + 1
    lr = schedule(cfg, step)
    stepf = step.to(torch.float32)
    one = _f32(1.0, dev)
    c1 = one - torch.pow(_f32(cfg.b1, dev), stepf)
    c2 = one - torch.pow(_f32(cfg.b2, dev), stepf)
    b1, b2 = _f32(cfg.b1, dev), _f32(cfg.b2, dev)
    nb1, nb2 = _f32(1 - cfg.b1, dev), _f32(1 - cfg.b2, dev)
    eps, wd = _f32(cfg.eps, dev), _f32(cfg.weight_decay, dev)
    ranks = _ranks(params, model_cfg)

    for n, p in params.items():
        g = grads[n].to(torch.float32) * scale
        m32 = b1 * state.mu[n].to(torch.float32) + nb1 * g
        v32 = b2 * state.nu[n].to(torch.float32) + nb2 * g * g
        mhat = m32 / c1
        vhat = v32 / c2
        delta = mhat / (torch.sqrt(vhat) + eps)
        if cfg.weight_decay > 0 and ranks[n] >= 2:   # decay matrices only
            delta = delta + wd * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * delta)
        state.mu[n].copy_(m32)
        state.nu[n].copy_(v32)
    return params, OptState(step, state.mu, state.nu), {"grad_norm": gnorm,
                                                        "lr": lr}
