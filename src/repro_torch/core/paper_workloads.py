"""The paper's evaluation workloads: DeiT-T/S/B (ImageNet, 224x224, patch 16)
and BERT-B/L (seq 128). Batch sizes are the calibration choice that places the
found-config energy/latency in the paper's reported ranges (<=39 mJ, <=6 ms
under 50 mJ / 10 ms constraints); see DESIGN.md Sec. 8.
"""
from __future__ import annotations

from .workload import Gemm, Workload, transformer_encoder_workload

_PATCHES = 196          # 224/16 squared
_TOKENS_VIT = _PATCHES + 1
_PATCH_DIM = 16 * 16 * 3


def deit(variant: str, batch: int = 8) -> Workload:
    dims = {"tiny": (192, 3, 768), "small": (384, 6, 1536),
            "base": (768, 12, 3072)}[variant]
    d, h, ff = dims
    return transformer_encoder_workload(
        f"deit-{variant}", layers=12, d_model=d, heads=h, d_ff=ff,
        tokens=_TOKENS_VIT, batch=batch, vocab=1000,
        stem_gemm=Gemm(_PATCHES, _PATCH_DIM, d))


def bert(variant: str, batch: int = 4, seq: int = 128) -> Workload:
    dims = {"base": (12, 768, 12, 3072), "large": (24, 1024, 16, 4096)}[variant]
    layers, d, h, ff = dims
    # Embedding lookup is a gather (electronic); pooler+classifier head GEMM.
    return transformer_encoder_workload(
        f"bert-{variant}", layers=layers, d_model=d, heads=h, d_ff=ff,
        tokens=seq, batch=batch,
        extra_gemms=(Gemm(batch, d, d, 1), Gemm(batch, d, 2, 1)),
        extra_weight_bytes=30522 * d * 0.5)  # 4-bit embedding table


PAPER_WORKLOADS = {
    "deit-t": lambda: deit("tiny", batch=16),
    "deit-s": lambda: deit("small", batch=16),
    "deit-b": lambda: deit("base", batch=8),
    "bert-b": lambda: bert("base", batch=8),
    "bert-l": lambda: bert("large", batch=4),
}


def load(name: str) -> Workload:
    return PAPER_WORKLOADS[name]()
