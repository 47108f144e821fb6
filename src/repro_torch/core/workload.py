"""Workload description consumed by the DxPTA performance model.

A workload is the list of GEMMs a transformer inference executes (the part the
photonic tensor cores accelerate), plus the element-wise operation count that
stays on the electronic unit (softmax, LayerNorm, activations, residuals,
recurrences), plus memory-traffic figures. This is the HW/SW co-design
interface: the paper's DeiT/BERT models (and, in the JAX package, its model
zoo specs) lower to this structure. Host-side numpy, as in `repro`.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Gemm:
    m: int
    k: int
    n: int
    count: int = 1          # how many times this GEMM shape runs per batch

    @property
    def macs(self) -> int:
        return self.m * self.k * self.n * self.count


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    gemms: tuple            # tuple[Gemm, ...]
    elec_ops: float         # element-wise ops on the electronic unit
    weight_bytes: float     # off-chip weight traffic per batch (quantized)
    act_io_bytes: float     # off-chip activation I/O per batch
    max_act_bytes: float    # largest single-layer activation (SRAM sizing)
    batch: int = 1          # inferences folded into the figures above

    def __post_init__(self):
        for g in self.gemms:
            if g.m < 1 or g.k < 1 or g.n < 1 or g.count < 1:
                raise ValueError(
                    f"workload {self.name!r}: GEMM dims/count must be "
                    f">= 1, got ({g.m}, {g.k}, {g.n}) x {g.count} — "
                    f"an extraction bug, not a searchable shape")
            # gemm_array is int64; a dim past 2**63 would wrap silently
            # there. (The int32 *device* ceiling is checked later, at
            # kernel baking, because the int64 host engines are exact far
            # beyond it — see performance_model.require_i32_dims.)
            if max(g.m, g.k, g.n, g.count) >= 2**63:
                raise ValueError(
                    f"workload {self.name!r}: GEMM dim {max(g.m, g.k, g.n)}"
                    f" exceeds int64 — not representable in gemm_array")
        for f in ("elec_ops", "weight_bytes", "act_io_bytes",
                  "max_act_bytes"):
            v = getattr(self, f)
            if not (v == v) or v < 0 or v == float("inf"):
                raise ValueError(f"workload {self.name!r}: {f}={v!r} must "
                                 f"be finite and >= 0")

    @property
    def total_macs(self) -> float:
        return float(sum(g.macs for g in self.gemms))

    @property
    def gemm_array(self) -> np.ndarray:
        """(W, 4) int64 array [M, K, N, count] — the vectorized-eval format."""
        return np.array([[g.m, g.k, g.n, g.count] for g in self.gemms],
                        dtype=np.int64)

    def scaled(self, batch: int) -> "Workload":
        """Same per-inference workload at a different batch size."""
        if batch == self.batch:
            return self
        s = batch / self.batch
        gemms = []
        for g in self.gemms:
            # Batch scales either the M dimension (token-parallel GEMMs) or
            # the count (per-head GEMMs); scaling count is always sound.
            gemms.append(Gemm(g.m, g.k, g.n, max(1, round(g.count * s))))
        return dataclasses.replace(
            self, gemms=tuple(gemms), elec_ops=self.elec_ops * s,
            weight_bytes=self.weight_bytes,  # weights stream once per batch
            act_io_bytes=self.act_io_bytes * s,
            max_act_bytes=self.max_act_bytes, batch=batch,
            name=f"{self.name}@b{batch}")


def _quant_bytes(elems: float, bits: int) -> float:
    return elems * bits / 8.0


def transformer_encoder_workload(
    name: str,
    *,
    layers: int,
    d_model: int,
    heads: int,
    d_ff: int,
    tokens: int,
    batch: int = 1,
    kv_heads: int | None = None,
    vocab: int = 0,
    stem_gemm: Gemm | None = None,
    act_bits: int = 4,
    weight_bits: int = 4,
    extra_gemms: Sequence[Gemm] = (),
    extra_elec_ops: float = 0.0,
    extra_weight_bytes: float = 0.0,
) -> Workload:
    """Standard encoder (DeiT / BERT / ViT backbone) GEMM decomposition.

    Per layer: QKV projection, per-head score GEMM, per-head attn*V GEMM,
    output projection, FFN up + down. Softmax/LN/GELU/residual are electronic.
    """
    kv_heads = kv_heads or heads
    dh = d_model // heads
    bt = batch * tokens
    d_q = heads * dh
    d_kv = kv_heads * dh
    gemms = [
        Gemm(bt, d_model, d_q + 2 * d_kv, layers),          # fused QKV
        Gemm(tokens, dh, tokens, layers * batch * heads),   # Q K^T
        Gemm(tokens, tokens, dh, layers * batch * heads),   # scores * V
        Gemm(bt, d_q, d_model, layers),                     # output proj
        Gemm(bt, d_model, d_ff, layers),                    # FFN up
        Gemm(bt, d_ff, d_model, layers),                    # FFN down
    ]
    if stem_gemm is not None:
        gemms.append(dataclasses.replace(stem_gemm, count=stem_gemm.count * batch))
    if vocab:
        gemms.append(Gemm(batch, d_model, vocab, 1))        # classifier head
    gemms.extend(extra_gemms)

    elec = (
        batch * heads * tokens * tokens * layers * 3        # softmax (exp/sum/div)
        + bt * d_model * 2 * layers * 4                     # 2 LN (stats+scale)
        + bt * d_ff * layers                                # GELU
        + bt * d_model * 2 * layers                         # residual adds
        + extra_elec_ops
    )
    params = layers * (d_model * (d_q + 2 * d_kv) + d_q * d_model
                       + 2 * d_model * d_ff) + vocab * d_model
    if stem_gemm is not None:
        params += stem_gemm.k * stem_gemm.n
    weight_bytes = _quant_bytes(params, weight_bits) + extra_weight_bytes
    max_act = _quant_bytes(bt * max(d_ff, d_q + 2 * d_kv), act_bits)
    act_io = _quant_bytes(bt * d_model * 2, act_bits)       # in + out once
    return Workload(name=name, gemms=tuple(gemms), elec_ops=float(elec),
                    weight_bytes=float(weight_bytes), act_io_bytes=float(act_io),
                    max_act_bytes=float(max_act), batch=batch)


def merge_workloads(name: str, parts: Sequence[Workload], batch: int) -> Workload:
    gemms = tuple(g for p in parts for g in p.gemms)
    return Workload(
        name=name, gemms=gemms,
        elec_ops=float(sum(p.elec_ops for p in parts)),
        weight_bytes=float(sum(p.weight_bytes for p in parts)),
        act_io_bytes=float(sum(p.act_io_bytes for p in parts)),
        max_act_bytes=float(max(p.max_act_bytes for p in parts)),
        batch=batch)
