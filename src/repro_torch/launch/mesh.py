"""Device meshes (the port of `repro/launch/mesh.py`).

The production meshes are abstract: `make_production_mesh` lays a
(data=16, model=16) mesh of 256 H100s, or a (pod=2, data=16, model=16) one
of 512, over a fake process group (`torch.testing`'s "fake" backend: every
collective returns at once, nothing is sent), so that the dry-run can shard
meta tensors across cards this process does not have. The group has 512
ranks and this process is rank 0; the single-pod mesh takes ranks 0-255,
as the reference's takes the first 256 of its 512 placeholder devices. It
is set up once a process (`init_fake_world`) and torn down by the caller
(`destroy_fake_world`). `make_host_mesh` is the (1, n) mesh of the cards
present, over a real process group the caller has initialized.

A mesh here is the tuple of torch devices the 1-D candidate axis
(`parallel.sharding.CANDIDATE_AXIS`) spans: `search(..., shard=N)` cuts
each evaluation's candidates into one contiguous slice per device, launches
every slice on its own device and combines the per-slice reductions on the
host.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .._device import resolve_device

#: ranks of the fake world the production meshes lie on
PRODUCTION_WORLD = 512


def init_fake_world(world_size: int = PRODUCTION_WORLD) -> None:
    """Initialize the process group as a fake one of `world_size` ranks
    (this process rank 0), unless one of that size is up. The fake backend
    ships with torch's testing package; a torch without it fails here."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world_size or \
                dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()} process group of "
                f"{dist.get_world_size()} ranks is up; the production "
                f"meshes need a fake one of {world_size}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def destroy_fake_world() -> None:
    """Destroy the process group, and with it what DTensor cached about its
    meshes: a mesh of the next world that equals one of this world's (same
    ranks, names and device type) would otherwise reuse cached plans that
    name this world's destroyed groups."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    clear_dtensor_caches()


def clear_dtensor_caches() -> None:
    """Clear DTensor's sharding-propagation caches, its native one too, and
    redistribution caches (those this torch has) and the port's own
    placement cache."""
    import sys
    if "torch.distributed.tensor" not in sys.modules:
        return
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import _redistribute

    from ..parallel import sharding
    prop = DTensor._op_dispatcher.sharding_propagator
    for cache in (getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                          None),
                  getattr(prop.propagate_op_sharding, "cache_clear", None),
                  getattr(_redistribute._gen_transform_infos, "cache_clear",
                          None),
                  getattr(_redistribute, "clear_redistribute_planner_cache",
                          None),
                  sharding._held.cache_clear):
        if cache is not None:
            cache()


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The (16, 16) ("data", "model") mesh of 256 placeholder cards, or the
    (2, 16, 16) ("pod", "data", "model") one of 512, on the fake world
    (initialized here if it is not up). `device_type` is what the
    placeholders are ("cuda": H100s; the CPU tests pass "cpu", where
    DTensor replaces an all-to-all by an all-gather)."""
    from torch.distributed.device_mesh import DeviceMesh

    init_fake_world()
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for k in shape:
        n *= k
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cuda"):
    """The (1, n) ("data", "model") mesh of the n cards present (one CPU
    device for "cpu"), over the process group the caller initialized with a
    world of n ranks."""
    from torch.distributed.device_mesh import DeviceMesh

    n = torch.cuda.device_count() if device_type == "cuda" else 1
    return DeviceMesh(device_type, torch.arange(n).reshape(1, n),
                      mesh_dim_names=("data", "model"))


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
