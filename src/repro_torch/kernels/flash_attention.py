"""Hopper kernel for the fused (flash) attention forward, beside its plain
PyTorch version.

`flash_attention_bhsd` replaces `repro/kernels/flash_attention.py`'s Pallas
kernel of the same name: online-softmax attention on (BH, S, D) tensors,
f32 running max and denominator, scores `(q . k) * f32(D**-0.5)`, masked
scores -1e30, causal key blocks past the query block skipped, and
`acc / max(l, 1e-30)` in q's dtype. Two CUDA kernels compute it, chosen
by dtype and head dim (`tensor_core_path`):

  * bf16 with D % 8 == 0 (every config's head dim): `csrc/flash_attention.cu`,
    scores and P . V on the tensor cores (wgmma), K/V streamed by TMA in
    tiles of 128 keys (64 past D = 128); it rounds P to bf16 before P . V;
  * f32, and bf16 with another D: `csrc/lm_kernels.cu`'s CUDA-core kernel
    (TF32 products would miss the f32 tolerance).

Both take any D <= MAX_HEAD_DIM and any S (they mask their own ragged
tiles); K/V may hold fewer heads than Q (`group` query heads per KV head,
query row bh reading KV row bh // group), which is the reference wrapper's
repeat of K/V without the copy.

Its plain version is plain softmax attention (`ref.flash_attention_ref`
after the same repeat). Exponentials, summation order and the bf16 P differ
between them, so they agree to a tolerance, not bit for bit: the
reference's own (2e-5 in f32, 2e-2 in bf16).

The wrapper takes tensors. Given CUDA tensors it launches one of the two
kernels (and counts the launch in `LAUNCHES` under that kernel's name) or
raises; given CPU tensors it runs the plain version.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .dse_eval import _check, _ptr, _require, _stream
from .ref import flash_attention_ref

MAX_HEAD_DIM = 256

#: Launch counts of the two kernels (the tensor-core one, then the CUDA-core
#: one); the wrapper adds one where it launches a kernel.
LAUNCHES = {"flash_attention_bhsd": 0, "flash_attention_bhsd_cuda_cores": 0}


def tensor_core_path(dtype: torch.dtype, d: int) -> bool:
    """Whether (BH, S, d) operands of `dtype` run the tensor-core kernel:
    bf16 (its wgmma operand type) with d % 8 == 0 (TMA's 16-byte row
    stride); everything else runs the CUDA-core kernel."""
    return dtype == torch.bfloat16 and d % 8 == 0 and 0 < d <= MAX_HEAD_DIM


def flash_attention_bhsd_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = True,
                               group: int = 1) -> torch.Tensor:
    """Plain version of `flash_attention_bhsd` (same operands and result)."""
    if group > 1:
        k = k.repeat_interleave(group, dim=0)
        v = v.repeat_interleave(group, dim=0)
    return flash_attention_ref(q, k, v, causal=causal)


def _check_operands(q, k, v, group):
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3:
        raise ValueError(f"flash_attention_bhsd: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         f"(BH, S, D) tensors")
    bh, _, d = q.shape
    if k.shape[2] != d or group < 1 or k.shape[0] * group != bh:
        raise ValueError(f"flash_attention_bhsd: k/v {tuple(k.shape)} do not "
                         f"hold {bh} // {group} heads of width {d}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_bhsd: head dim {d} exceeds "
                         f"{MAX_HEAD_DIM}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention_bhsd: dtype {q.dtype} is not "
                         f"float32 or bfloat16")


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         group: int = 1) -> torch.Tensor:
    """q (BH, Sq, D); k, v (BH // group, Skv, D), all f32 or all bf16 ->
    (BH, Sq, D) in q's dtype. Replaces
    `repro/kernels/flash_attention.py:flash_attention_bhsd`."""
    _check_operands(q, k, v, group)
    if not q.is_cuda:
        return flash_attention_bhsd_plain(q, k, v, causal=causal, group=group)
    from ._build import load_library
    _require([q, k, v], [q.dtype] * 3, "flash_attention_bhsd")
    bh, sq, d = q.shape
    out = torch.empty_like(q)
    args = [_ptr(q), _ptr(k), _ptr(v), _ptr(out), ctypes.c_int(bh),
            ctypes.c_int(sq), ctypes.c_int(k.shape[1]), ctypes.c_int(d),
            ctypes.c_int(group), ctypes.c_int(int(causal)),
            ctypes.c_float(float(np.float32(d ** -0.5)))]
    if tensor_core_path(q.dtype, d):
        name = "flash_attention_bhsd"
        rc = load_library("flash_attention").flash_attention_wgmma_launch(
            *args, _stream())
    else:
        name = "flash_attention_bhsd_cuda_cores"
        rc = load_library("lm_kernels").flash_attention_launch(
            *args, ctypes.c_int(int(q.dtype == torch.bfloat16)), _stream())
    _check(rc, name)
    LAUNCHES[name] += 1
    return out
