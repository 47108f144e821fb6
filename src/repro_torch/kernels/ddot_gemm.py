"""Hopper kernel for the photonic DDot-array GEMM, beside its plain PyTorch
version.

`ddot_gemm_quantized` replaces `repro/kernels/ddot_gemm.py`'s Pallas kernel
of the same name: a GEMM on symmetric 4-bit operands (integers in [-7, 7],
quantized per row of A and per column of B by `ops.ddot_matmul`) with exact
accumulation, optional coherent shot noise `noise_rms * sqrt(|qa| @ |qb|)
* z` in quantized units, then the dequantization `* sa * sb`.

Exactness: every product is an integer of magnitude at most 49, so while
49 * K < 2**24 (K <= K_MAX) every partial sum is an integer that float32
holds exactly, and the reference's float32 accumulation equals the exact
integer sum whatever the order. The CUDA kernel (`csrc/lm_kernels.cu`)
carries the operands as int8 and accumulates in int32 on the tensor cores,
the plain version multiplies them as float32; both then run the epilogue in
the reference's float32 order, `(acc + (noise_rms * sqrt(pow)) * z) * sa *
sb`, so the two are equal bit for bit, with and without noise, given the
same `z`.

Layout: the kernel reads B K-major, as the (N, K) rows of `qb.T` (8-bit
tensor-core operands are K-major only). The wrapper keeps the reference's
(K, N) signature and passes `qb.T` without a copy when that view is
contiguous, which is the case of a quantized transposed view such as the
LM head's `table.T`; otherwise it makes the K-major copy (`k_major`).

The wrapper takes tensors. Given CUDA tensors it launches the kernel (and
counts the launch in `LAUNCHES`) or raises; given CPU tensors it runs the
plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .dse_eval import _check, _ptr, _require, _stream
from .ref import sqrt_f32

QMAX = 7.0
#: Largest contraction length for which float32 sums of 4-bit products stay
#: exact integers (49 * K < 2**24).
K_MAX = (2 ** 24 - 1) // 49

#: Launch count of the kernel; the wrapper adds one where it launches it.
LAUNCHES = {"ddot_gemm_quantized": 0}


def _noise_scale(noise_rms: float, device) -> torch.Tensor:
    """float32(noise_rms) as a 0-d tensor (JAX's weak-typed Python float)."""
    return torch.tensor(np.float32(noise_rms), device=device)


def ddot_gemm_quantized_plain(qa: torch.Tensor, qb: torch.Tensor,
                              sa: torch.Tensor, sb: torch.Tensor,
                              z: Optional[torch.Tensor] = None, *,
                              noise_rms: float = 0.0) -> torch.Tensor:
    """Plain version of `ddot_gemm_quantized` (same operands and result)."""
    a, b = qa.float(), qb.float()
    acc = a @ b
    if noise_rms > 0.0:
        power = a.abs() @ b.abs()
        acc = acc + (_noise_scale(noise_rms, acc.device)
                     * sqrt_f32(power)) * z
    return acc * sa * sb


def _check_operands(qa, qb, sa, sb, z, noise_rms):
    if qa.dim() != 2 or qb.dim() != 2 or qa.shape[1] != qb.shape[0]:
        raise ValueError(f"ddot_gemm_quantized: qa {tuple(qa.shape)} and qb "
                         f"{tuple(qb.shape)} are not (M, K) and (K, N)")
    m, k = qa.shape
    n = qb.shape[1]
    if k > K_MAX:
        raise ValueError(f"ddot_gemm_quantized: K = {k} exceeds {K_MAX}; "
                         f"past it float32 sums of 4-bit products are no "
                         f"longer exact integers")
    if tuple(sa.shape) != (m, 1) or tuple(sb.shape) != (1, n):
        raise ValueError(f"ddot_gemm_quantized: scales {tuple(sa.shape)}, "
                         f"{tuple(sb.shape)} do not match ({m}, 1), (1, {n})")
    if noise_rms > 0.0 and (z is None or tuple(z.shape) != (m, n)):
        raise ValueError(f"ddot_gemm_quantized: noise_rms > 0 needs z of "
                         f"shape ({m}, {n})")
    return m, k, n


def k_major(qb: torch.Tensor) -> torch.Tensor:
    """The (N, K) K-major rows of a (K, N) operand: the view `qb.T` when it
    is contiguous, else a contiguous copy of it."""
    qbt = qb.T
    return qbt if qbt.is_contiguous() else qbt.contiguous()


def ddot_gemm_quantized(qa: torch.Tensor, qb: torch.Tensor, sa: torch.Tensor,
                        sb: torch.Tensor, z: Optional[torch.Tensor] = None, *,
                        noise_rms: float = 0.0) -> torch.Tensor:
    """Quantized GEMM on pre-quantized operands, any M, K <= K_MAX, N.

    qa (M, K) and qb (K, N) int8 holding integers in [-QMAX, QMAX] (qa
    contiguous; qb contiguous or the transpose of a contiguous (N, K)
    tensor, the layout the kernel reads without a copy); sa (M, 1)
    and sb (1, N) float32 dequantization scales; z (M, N) float32 standard
    normal draws, read only when noise_rms > 0. Returns (M, N) float32.
    Replaces `repro/kernels/ddot_gemm.py:ddot_gemm_quantized`.
    """
    m, k, n = _check_operands(qa, qb, sa, sb, z, noise_rms)
    if not qa.is_cuda:
        return ddot_gemm_quantized_plain(qa, qb, sa, sb, z,
                                         noise_rms=noise_rms)
    from ._build import count_launch, load_library
    noisy = noise_rms > 0.0
    qbt = k_major(qb)
    ops = [qa, qbt, sa, sb] + ([z] if noisy else [])
    _require(ops, [torch.int8, torch.int8, torch.float32, torch.float32,
                   torch.float32], "ddot_gemm_quantized")
    out = torch.empty((m, n), dtype=torch.float32, device=qa.device)
    rc = load_library("lm_kernels").ddot_gemm_launch(
        _ptr(qa), _ptr(qbt), _ptr(sa), _ptr(sb),
        _ptr(z) if noisy else None, _ptr(out), ctypes.c_int(m),
        ctypes.c_int(n), ctypes.c_int(k), ctypes.c_int(int(noisy)),
        ctypes.c_float(float(np.float32(noise_rms))), _stream())
    _check(rc, "ddot_gemm_quantized")
    count_launch(LAUNCHES, "ddot_gemm_quantized")
    return out
