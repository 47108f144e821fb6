"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on: "cuda" unless the caller
    names another. A CUDA device with no card present raises — the entry
    points never carry on on the CPU unless asked to (device="cpu" runs the
    plain PyTorch version of every kernel; "meta" builds shapes only, as
    the dry-run does)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"device must be a cuda, cpu or meta device, got "
                         f"{dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available to this process; pass "
            "device='cpu' to run the plain PyTorch versions of the kernels")
    return dev
