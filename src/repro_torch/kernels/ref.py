"""Oracles for the kernels (the port's copy of `repro/kernels/ref.py`):
float64 numpy ones for the DSE kernels, plain torch ones for the 4-bit DDot
GEMM and for attention."""
from __future__ import annotations

import numpy as np
import torch

from ..core.photonic_model import CONSTANTS, DeviceConstants
from ..core.search import evaluate_grid
from ..core.workload import Workload


def dse_eval_ref(grid: np.ndarray, wl: Workload,
                 c: DeviceConstants = CONSTANTS):
    """Oracle for kernels.ops.dse_eval_grid: (G, 4) [area, power, energy,
    latency] via the core (numpy) model, cast to float32."""
    m = evaluate_grid(grid, wl, c)
    return np.stack([m["area"], m["power"], m["energy"], m["latency"]],
                    axis=1).astype(np.float32)


def dse_search_ref(grid: np.ndarray, wl: Workload, constraints,
                   c: DeviceConstants = CONSTANTS):
    """Oracle for kernels.ops.dse_search_grid: (best_idx or -1, n_feasible)
    via the core (numpy, float64) model with the first-hit argmin rule."""
    m = evaluate_grid(grid, wl, c)
    ok = np.asarray(constraints.satisfied(m["area"], m["power"], m["energy"],
                                          m["latency"]))
    n_feasible = int(ok.sum())
    if n_feasible == 0:
        return -1, 0
    edp = np.where(ok, m["edp"], np.inf)
    return int(np.argmin(edp)), n_feasible


def dse_pareto_ref(grid: np.ndarray, wl: Workload, constraints,
                   objectives=("area", "power", "edp"),
                   c: DeviceConstants = CONSTANTS):
    """Oracle for the frontier path (kernels.ops.dse_pareto_multi after the
    host refinement): lex-sorted (front_rows, n_feasible) via the core
    float64 model and the exact pareto_mask reduction."""
    from ..core.pareto import pareto_mask

    m = evaluate_grid(grid, wl, c)
    ok = np.asarray(constraints.satisfied(m["area"], m["power"], m["energy"],
                                          m["latency"]))
    pts = np.stack([np.asarray(m[k], np.float64)[ok] for k in objectives],
                   axis=1)
    front = np.asarray(grid)[ok][pareto_mask(pts)].astype(np.int64)
    return front[np.lexsort(front.T[::-1])], int(ok.sum())


QMAX = 7.0
NEG_INF = -1e30


def quantize4(x, axis: int):
    """Symmetric 4-bit quantization along `axis` (the contraction dim).

    Returns float32 (q, scale) with x ~= q * scale, q integer-valued in
    [-QMAX, QMAX]. Both divisions take a tensor divisor: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal instead.
    """
    x = torch.as_tensor(x).float()
    qmax = torch.tensor(QMAX, dtype=torch.float32, device=x.device)
    s = x.abs().amax(dim=axis, keepdim=True) / qmax
    s = torch.where(s == 0.0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(x / s), -QMAX, QMAX)
    return q, s


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (IEEE sqrtf, as CUDA and
    XLA take it). PyTorch's vectorized CPU float32 sqrt is not correctly
    rounded (sqrt(2535) comes out one ulp low); the float64 root rounded
    once to float32 is, for every float32 input."""
    return torch.sqrt(x.double()).float()


def ddot_matmul_ref(a, b, noise_rms: float = 0.0, z=None):
    """Oracle for kernels.ops.ddot_matmul: quantize -> exact int GEMM ->
    dequant (+ shot noise)."""
    qa, sa = quantize4(a, axis=1)          # per-row of A
    qb, sb = quantize4(b, axis=0)          # per-column of B
    acc = qa @ qb
    if noise_rms > 0.0:
        power = qa.abs() @ qb.abs()
        nr = torch.tensor(np.float32(noise_rms), device=acc.device)
        acc = acc + (nr * sqrt_f32(power)) * z
    return acc * sa * sb


def flash_attention_ref(q, k, v, causal: bool = True):
    """Oracle for kernels.ops.flash_attention: plain softmax attention in
    float32, cast to q's dtype. q, k, v: (BH, S, D)."""
    d = q.shape[-1]
    scale = torch.tensor(np.float32(d ** -0.5), device=q.device)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        sq, skv = q.shape[1], k.shape[1]
        mask = (torch.arange(skv, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
