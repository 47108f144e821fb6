"""Hopper kernel for the fused (flash) attention forward, beside its plain
PyTorch version.

`flash_attention_bhsd` replaces `repro/kernels/flash_attention.py`'s Pallas
kernel of the same name: online-softmax attention on (BH, S, D) tensors,
f32 running max and denominator, scores `(q . k) * f32(D**-0.5)`, masked
scores -1e30, causal key blocks past the query block skipped, and
`acc / max(l, 1e-30)` in q's dtype. Two CUDA kernels compute it, both on
the tensor cores, chosen by dtype and head dim (`wgmma_path`):

  * bf16 with D % 8 == 0 (every config's head dim): `csrc/flash_attention.cu`,
    scores and P . V on wgmma, K/V streamed by TMA in tiles of 128 keys (64
    past D = 128); it rounds P to bf16 before P . V;
  * f32, and bf16 with another D: `csrc/flash_attention_tf32.cu`, mma.sync
    in TF32. One TF32 pass would miss the f32 tolerance by about 100x, so
    f32 products take three (3xTF32: x = hi + lo, a_lo b_hi + a_hi b_lo +
    a_hi b_hi); bf16 operands are exact in TF32 and take one. Key tiles
    are 32 keys. When the grid of 64-row query blocks is smaller than the
    CTAs the card holds at once, the keys are split across CTAs
    (`tf32_splits`) and a second kernel of the same call
    merges the partial (acc, m, l) from a scratch buffer the wrapper
    allocates.

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
from .ref import NEG_INF, flash_attention_ref  # noqa: F401  (public)

MAX_HEAD_DIM = 256

#: Query rows of one block of the TF32 kernel (four warps of 16 rows).
TF32_BLOCK_Q = 64
#: Keys of one K/V tile of the TF32 kernel.
TF32_BLOCK_K = 32
#: Launch counts of the two kernels (the wgmma one, then the TF32 one); the
#: wrapper adds one where it launches a kernel (a TF32 call that merges
#: split keys launches its merge kernel inside the same count).
LAUNCHES = {"flash_attention_bhsd": 0, "flash_attention_bhsd_tf32": 0}


def wgmma_path(dtype: torch.dtype, d: int) -> bool:
    """Whether (BH, S, d) operands of `dtype` run the wgmma kernel: bf16
    (its wgmma operand type) with d % 8 == 0 (TMA's 16-byte row stride);
    everything else runs the TF32 mma.sync kernel."""
    return dtype == torch.bfloat16 and d % 8 == 0 and 0 < d <= MAX_HEAD_DIM


def tf32_splits(bh: int, sq: int, skv: int, d: int, n_sm: int) -> int:
    """Key splits of a TF32 call on a card of `n_sm` SMs: as many as keep
    the (query block, head, split) grid within the CTAs the card holds at
    once (two an SM up to D = 128, whose blocks take 101 KB of shared
    memory; one past it, up to 200 KB), at most one per key tile and at
    most 64."""
    blocks = bh * -(-sq // TF32_BLOCK_Q)
    tiles = -(-skv // TF32_BLOCK_K)
    resident = (2 if d <= 128 else 1) * n_sm
    return max(1, min(tiles, resident // max(blocks, 1), 64))


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
    from ._build import count_launch, load_library
    _require([q, k, v], [q.dtype] * 3, "flash_attention_bhsd")
    bh, sq, d = q.shape
    out = torch.empty_like(q)
    args = [_ptr(q), _ptr(k), _ptr(v), _ptr(out), ctypes.c_int(bh),
            ctypes.c_int(sq), ctypes.c_int(k.shape[1]), ctypes.c_int(d),
            ctypes.c_int(group), ctypes.c_int(int(causal)),
            ctypes.c_float(float(np.float32(d ** -0.5)))]
    if wgmma_path(q.dtype, d):
        name = "flash_attention_bhsd"
        rc = load_library("flash_attention").flash_attention_wgmma_launch(
            *args, _stream())
    else:
        name = "flash_attention_bhsd_tf32"
        n_sm = torch.cuda.get_device_properties(q.device).multi_processor_count
        splits = tf32_splits(bh, sq, k.shape[1], d, n_sm)
        part = (torch.empty(splits * bh * sq * (-(-d // 8) * 8 + 2),
                            dtype=torch.float32, device=q.device)
                if splits > 1 else None)
        rc = load_library("flash_attention_tf32").flash_attention_tf32_launch(
            *args, ctypes.c_int(int(q.dtype == torch.bfloat16)),
            ctypes.c_int(splits),
            None if part is None else _ptr(part), _stream())
    _check(rc, name)
    count_launch(LAUNCHES, name)
    return out
