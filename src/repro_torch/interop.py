"""Carry the reference package's state across to the port.

The DxPTA search has no weights: its state is the device constants, the
workload (its GEMM list and traffic figures), the constraint box, a config
and a product space's axes. `from_reference` reads any of those reference
objects field by field (duck typing on the dataclass fields — nothing of
`repro` is imported) and returns the port's equal object, so one process
can hand a `repro` workload to `repro_torch` and compare the two engines on
the same inputs.

The LM has weights: `lm_params_from_reference` carries a reference
parameter pytree (as numpy arrays) into the port's `DecoderLM`, bit for bit.
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


def lm_params_from_reference(params, cfg, device=None):
    """The port's `DecoderLM` holding a reference LM's parameters.

    `params` is `repro.models.init_params`'s pytree with numpy leaves (or
    any leaves `np.asarray` reads): embed/table, head/table (untied),
    final_norm/scale and the layer stack `layers`, whose leading axis
    (one entry per layer) is unstacked into the module list (ln1, ln2,
    attn/{wq, wk, wv, wo, bq, bk, bv}, mlp/{wi, wg, wo}).
    """
    from ._device import resolve_device
    from .models.lm import DecoderLM

    dev = resolve_device(device)
    model = DecoderLM(cfg, dev)

    def put(dst, src):
        t = _tensor(src, dev)
        if t.shape != dst.shape or t.dtype != dst.dtype:
            raise ValueError(f"reference leaf {tuple(t.shape)} {t.dtype} "
                             f"does not fit {tuple(dst.shape)} {dst.dtype}")
        with torch.no_grad():
            dst.copy_(t)

    put(model.embed.table, params["embed"]["table"])
    put(model.final_norm.scale, params["final_norm"]["scale"])
    if model.head is not None:
        put(model.head.table, params["head"]["table"])
    stack = params["layers"]
    for i, blk in enumerate(model.layers):
        put(blk.ln1.scale, np.asarray(stack["ln1"]["scale"])[i])
        put(blk.ln2.scale, np.asarray(stack["ln2"]["scale"])[i])
        names = ("wq", "wk", "wv", "wo") + (("bq", "bk", "bv")
                                            if blk.attn.has_bias else ())
        for n in names:
            put(getattr(blk.attn, n), np.asarray(stack["attn"][n])[i])
        for n in ("wi", "wg", "wo"):
            put(getattr(blk.mlp, n), np.asarray(stack["mlp"][n])[i])
    return model
