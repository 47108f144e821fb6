"""The device mesh of the DSE candidate fan-out (the port of
`repro/launch/mesh.py`'s `make_candidate_mesh`).

A mesh here is the tuple of torch devices the 1-D candidate axis
(`parallel.sharding.CANDIDATE_AXIS`) spans: `search(..., shard=N)` cuts
each evaluation's candidates into one contiguous slice per device, launches
every slice on its own device and combines the per-slice reductions on the
host. The production and host meshes of the LM side wait for the dry-run's
slice (ROADMAP item 15).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .._device import resolve_device


def make_candidate_mesh(shard: int, device=None) -> Tuple[torch.device, ...]:
    """The devices a `shard`-way candidate fan-out runs on.

    On a CUDA device: `cuda:0 .. cuda:k-1` with `k = shard` clamped to the
    cards this process sees, so `shard=4` on a one-card machine runs one
    shard, as the reference's mesh clamps to `len(jax.devices())`. On the
    CPU: the one CPU device (the reference's CPU host has one device unless
    `XLA_FLAGS` forces more). Results do not depend on `k`: the shard count
    only moves where the per-shard reductions run.
    """
    dev = resolve_device(device)
    if dev.type != "cuda":
        return (torch.device("cpu"),)
    k = max(1, min(int(shard), torch.cuda.device_count()))
    return tuple(torch.device("cuda", i) for i in range(k))


def shard_mesh(shard, device=None) -> Optional[Tuple[torch.device, ...]]:
    """The mesh an evaluation under `shard=` runs on: None when it runs
    unsharded (`shard` None or 1), else `make_candidate_mesh(shard,
    device)`. A one-device mesh still takes the sharded layout (padding,
    block counts), as the reference's does."""
    if shard is None or int(shard) <= 1:
        return None
    return make_candidate_mesh(shard, device)
