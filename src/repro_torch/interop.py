"""Carry the reference package's state across to the port.

The DxPTA search has no weights: its state is the device constants, the
workload (its GEMM list and traffic figures), the constraint box, a config
and a product space's axes. `from_reference` reads any of those reference
objects field by field (duck typing on the dataclass fields — nothing of
`repro` is imported) and returns the port's equal object, so one process
can hand a `repro` workload to `repro_torch` and compare the two engines on
the same inputs.
"""
from __future__ import annotations

import dataclasses

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
