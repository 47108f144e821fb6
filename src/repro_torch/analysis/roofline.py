"""Roofline terms of a dry-run cell on H100s (the port of
`repro/analysis/roofline.py`, with NVIDIA's numbers in place of the TPU's).

    compute term    = FLOPs / (chips * 989e12 FLOP/s)         [bf16 dense]
    memory term     = HBM bytes / (chips * 3.35e12 B/s)       [HBM3]
    collective term = collective_bytes_per_chip / 50e9 B/s    [link]

`PEAK_FLOPS` is the H100 SXM's dense bf16 tensor-core rate and `HBM_BW`
its HBM3 bandwidth (NVIDIA H100 Tensor Core GPU data sheet, SXM column,
without sparsity); the reference's compute term is bf16 too.
`F32_OPS_PER_S` is the same sheet's float32 rate outside the tensor cores
(67 TFLOP/s), the bound of the port's exec-safe f32 products. `ICI_BW` is
one 400 Gb/s NDR InfiniBand port a GPU, as a DGX H100 has (NVIDIA DGX H100
data sheet: eight ConnectX-7 400 Gb/s ports for eight GPUs): a 256-card
mesh spans 32 eight-card nodes, so its "model" axis of 16 crosses a node
boundary and every collective is bound by that port, not by NVLink's
900 GB/s inside a node.

FLOPs are whole-program totals (the trace counts ops at their global
shapes), so they are divided by the chip count; HBM bytes likewise;
collective bytes are summed per participant (each op's local result), so
they are per-chip already.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

PEAK_FLOPS = 989e12          # bf16 dense, per card
F32_OPS_PER_S = 67e12        # float32 outside the tensor cores, per card
HBM_BW = 3.35e12             # bytes/s per card
ICI_BW = 50e9                # bytes/s per card (one 400 Gb/s NDR port)


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    collective_bytes_per_chip: float
    chips: int
    model_flops: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_chip / ICI_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound(self) -> float:
        """Perfect-overlap bound: the slowest of the three engines."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> Optional[float]:
        """MODEL_FLOPS / traced FLOPs: remat / padding / dispatch waste."""
        if not self.model_flops or not self.flops:
            return None
        return self.model_flops / self.flops

    @property
    def roofline_fraction(self) -> Optional[float]:
        """Useful-FLOPs MFU bound implied by this program: time the cards
        must spend / time doing useful math at peak."""
        if not self.model_flops:
            return None
        t_useful = self.model_flops / (self.chips * PEAK_FLOPS)
        t = self.step_time_lower_bound
        return t_useful / t if t > 0 else None

    def as_dict(self) -> Dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "chips": self.chips, "model_flops": self.model_flops,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(cfg, shape) -> float:
    """6·N·D for training, 2·N·D for forward-only; N = active params."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence per step
    return 2.0 * n * shape.global_batch
