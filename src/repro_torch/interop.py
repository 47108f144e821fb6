"""Carry the reference package's state across to the port.

The DxPTA search has no weights: its state is the device constants, the
workload (its GEMM list and traffic figures), the constraint box, a config
and a product space's axes. `from_reference` reads any of those reference
objects field by field (duck typing on the dataclass fields — nothing of
`repro` is imported) and returns the port's equal object, so one process
can hand a `repro` workload to `repro_torch` and compare the two engines on
the same inputs.

The models have weights: `params_from_reference` carries a reference
parameter pytree (as numpy arrays) of any family into the port's model, bit
for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.arch_params import Constraints, PTAConfig
from .core.factorized import FactorizedSpace
from .core.photonic_model import DeviceConstants
from .core.workload import Gemm, Workload

# Reference class name -> port class; every one is a frozen dataclass whose
# fields carry over one to one (Workload's GEMM tuple element by element).
_PORT_TYPES = {cls.__name__: cls for cls in
               (DeviceConstants, Constraints, PTAConfig, FactorizedSpace,
                Gemm, Workload)}


def from_reference(obj):
    """The port's counterpart of a reference `DeviceConstants`, `Workload`,
    `Gemm`, `Constraints`, `PTAConfig` or `FactorizedSpace`; lists, tuples
    and dicts of them convert element by element, and a port object comes
    back unchanged."""
    if isinstance(obj, tuple(_PORT_TYPES.values())):
        return obj
    if isinstance(obj, dict):
        return {k: from_reference(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(from_reference(v) for v in obj)
    cls = _PORT_TYPES.get(type(obj).__name__)
    if cls is None or not dataclasses.is_dataclass(obj):
        raise TypeError(f"no repro_torch counterpart for {type(obj)!r}")
    values = {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}
    if cls is Workload:
        values["gemms"] = tuple(from_reference(g) for g in values["gemms"])
    if cls is FactorizedSpace:
        values["axes"] = tuple(tuple(int(v) for v in a)
                               for a in values["axes"])
    return cls(**values)


def _tensor(a, device) -> torch.Tensor:
    """A numpy array as a tensor on `device`, bit for bit. The reference's
    bf16 arrays come as `ml_dtypes.bfloat16`, which torch.from_numpy
    rejects: they travel as their uint16 bits."""
    a = np.array(a)  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


#: The layer stacks: a reference leaf under one of these names has leading
#: layer axes, one entry per module of the port's ModuleList of that name.
STACKS = ("layers", "dense_layers", "moe_layers", "mamba_groups",
          "mamba_tail", "enc_layers", "dec_layers")


def reference_leaf(name: str, cfg):
    """Where the port's parameter `name` (a `named_parameters` name) lies
    in the reference's pytree: (path of dict keys, index into the leaf's
    leading layer axes, () outside a stack). The port's module names are
    the reference's keys; a stack's flat module index unstacks as one layer
    axis, and `mamba_groups`' as its two, (group, layer in group)."""
    parts = name.split(".")
    if parts[0] not in STACKS:
        return tuple(parts), ()
    i = int(parts[1])
    if parts[0] == "mamba_groups":
        a = cfg.ssm.attn_every
        return (parts[0],) + tuple(parts[2:]), (i // a, i % a)
    return (parts[0],) + tuple(parts[2:]), (i,)


def params_from_reference(params, cfg, device=None):
    """The port's model (`lm.DecoderLM`, or `encdec.EncDec` for the encdec
    family) holding a reference model's parameters, bit for bit.

    `params` is `repro.models.init_params`'s pytree with numpy leaves (or
    any leaves `np.asarray` reads). Every parameter of the port takes the
    leaf `reference_leaf` names (the stacks `layers`, `dense_layers`,
    `moe_layers`, `mamba_groups`, `mamba_tail`, `enc_layers` and
    `dec_layers` unstacked into the module lists, expert tensors whole),
    whose shape and dtype must be the parameter's; a reference leaf that no
    parameter takes is an error too.
    """
    from ._device import resolve_device
    from .models import encdec, lm

    dev = resolve_device(device)
    model = (encdec.EncDec(cfg, dev) if cfg.family == "encdec"
             else lm.DecoderLM(cfg, dev))
    taken = set()
    for name, dst in model.named_parameters():
        path, index = reference_leaf(name, cfg)
        src = params
        for key in path:
            src = src[key]
        t = _tensor(np.asarray(src)[index], dev)
        if t.shape != dst.shape or t.dtype != dst.dtype:
            raise ValueError(f"reference leaf {'/'.join(path)}{list(index)} "
                             f"{tuple(t.shape)} {t.dtype} does not fit "
                             f"{name} {tuple(dst.shape)} {dst.dtype}")
        with torch.no_grad():
            dst.copy_(t)
        taken.add(path)
    left = sorted("/".join(map(str, p)) for p in _leaf_paths(params)
                  if p not in taken)
    if left:
        raise ValueError(f"reference leaves with no parameter in the port: "
                         f"{left}")
    return model


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, prefix + (k,))
    else:
        yield prefix
