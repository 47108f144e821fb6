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
for bit, and `params_to_reference` carries it back. Training state goes
both ways too: `opt_state_to_reference` / `opt_state_from_reference` move
AdamW's state between the port's per-parameter moments and the
reference's layer-stacked ones, so either package resumes the other's
checkpoint.
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
    """A numpy array (or tensor) as a tensor on `device`, bit for bit. The
    reference's bf16 arrays come as `ml_dtypes.bfloat16`, which
    torch.from_numpy rejects: they travel as their uint16 bits, and a
    uint16 array is read as such bits (no parameter or moment of either
    package is uint16)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device)
    a = np.array(a)  # a writable copy: JAX hands out read-only buffers
    if a.dtype.name in ("bfloat16", "uint16"):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def _host(t: torch.Tensor, numpy: bool):
    """A tensor on the host: numpy (bf16 as its uint16 bits) or a CPU
    tensor; a DTensor's full value."""
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    t = t.detach().cpu()
    if not numpy:
        return t
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


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
    any leaves `np.asarray` reads, or tensors; bf16 may come as uint16
    bits). Every parameter of the port takes the leaf `reference_leaf`
    names (the stacks `layers`, `dense_layers`, `moe_layers`,
    `mamba_groups`, `mamba_tail`, `enc_layers` and `dec_layers` unstacked
    into the module lists, expert tensors whole), whose shape and dtype
    must be the parameter's; a reference leaf that no parameter takes is an
    error too.
    """
    from ._device import resolve_device
    from .models import encdec, lm

    dev = resolve_device(device)
    model = (encdec.EncDec(cfg, dev) if cfg.family == "encdec"
             else lm.DecoderLM(cfg, dev))
    load_reference_(model, params, cfg)
    return model


def _unstack(tree, named, cfg, what, device):
    """{port name: its slice of `tree`'s reference leaf, a tensor on
    `device`}. `named` maps each port name to (shape, dtype), the dtype
    None to take the leaf's own; every leaf of `tree` must be taken."""
    out, taken = {}, set()
    for name, (shape, dtype) in named.items():
        path, index = reference_leaf(name, cfg)
        src = tree
        for key in path:
            src = src[key]
        if not isinstance(src, torch.Tensor):
            src = np.asarray(src)
        t = _tensor(src[index], device)
        if tuple(t.shape) != tuple(shape) or dtype not in (None, t.dtype):
            raise ValueError(f"reference {what} leaf {'/'.join(path)}"
                             f"{list(index)} {tuple(t.shape)} {t.dtype} does "
                             f"not fit {name} {tuple(shape)} {dtype}")
        out[name] = t
        taken.add(path)
    left = sorted("/".join(map(str, p)) for p in _leaf_paths(tree)
                  if p not in taken)
    if left:
        raise ValueError(f"reference {what} leaves with no parameter in the "
                         f"port: {left}")
    return out


def load_reference_(model, params, cfg):
    """Copy a reference parameter pytree into `model`'s parameters in
    place, bit for bit (the checks of `params_from_reference`)."""
    named = dict(model.named_parameters())
    src = _unstack(params, {n: (p.shape, p.dtype) for n, p in named.items()},
                   cfg, "parameter", model_device(model))
    with torch.no_grad():
        for name, p in named.items():
            p.copy_(src.pop(name))
    return model


def model_device(model) -> torch.device:
    return next(model.parameters()).device


def _restack(tensors, cfg, numpy: bool):
    """{port name: tensor} -> the reference's nested dict, the stacks'
    per-layer tensors stacked along their layer axes (`mamba_groups`
    along two), on the host."""
    groups = {}
    for name, t in tensors.items():
        path, index = reference_leaf(name, cfg)
        groups.setdefault(path, []).append((index, t))
    tree = {}
    for path, items in groups.items():
        if items[0][0] == ():
            leaf = _host(items[0][1], numpy)
        else:
            items.sort(key=lambda it: it[0])
            lead = tuple(max(i[k] for i, _ in items) + 1
                         for k in range(len(items[0][0])))
            leaf = torch.stack([t.detach().cpu() for _, t in items])
            leaf = _host(leaf.reshape(lead + tuple(leaf.shape[1:])), numpy)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def params_to_reference(model, cfg, numpy: bool = True):
    """The reference's parameter pytree of `model`: the exact inverse of
    `params_from_reference`. Leaves are numpy arrays (bf16 as its uint16
    bits, numpy having no bfloat16), or CPU tensors with `numpy=False`; the
    stacks are restacked along their layer axes."""
    return _restack(dict(model.named_parameters()), cfg, numpy)


def reference_rank(name: str, param: torch.Tensor, cfg) -> int:
    """The rank of the reference leaf the port's parameter `name` is a
    slice of: a stack adds its layer axes."""
    return param.dim() + len(reference_leaf(name, cfg)[1])


def reference_order(names, cfg):
    """The reference's leaves in `jax.tree.leaves` order (dict keys sorted
    at every level): [(path, [port names of the leaf in layer order])]."""
    groups = {}
    for name in names:
        path, index = reference_leaf(name, cfg)
        groups.setdefault(path, []).append((index, name))
    return [(path, [n for _, n in sorted(groups[path])])
            for path in sorted(groups)]


def opt_state_to_reference(state, cfg, numpy: bool = True):
    """An `optim.adamw.OptState` of the port (moments keyed by parameter
    name) in the reference's layout: OptState(step as an int32 scalar,
    mu and nu restacked as `params_to_reference` restacks the
    parameters)."""
    from .optim.adamw import OptState
    step = _host(state.step.reshape(()), numpy)
    return OptState(step, _restack(state.mu, cfg, numpy),
                    _restack(state.nu, cfg, numpy))


def opt_state_from_reference(ref_state, model, cfg):
    """The port's `OptState` for `model` from a reference `OptState`
    (`repro.optim.adamw.OptState`, or this package's reference-layout one),
    on the model's device: the step as an int32 0-d tensor, each moment
    leaf unstacked onto the parameter it belongs to, bit for bit, in the
    moments' own dtype."""
    from .optim.adamw import OptState

    dev = model_device(model)
    shapes = {n: (p.shape, None) for n, p in model.named_parameters()}
    mu, nu = (_unstack(tree, shapes, cfg, what, dev)
              for what, tree in (("mu", ref_state.mu), ("nu", ref_state.nu)))
    step = _tensor(ref_state.step, dev).to(torch.int32).reshape(())
    return OptState(step, {n: t.clone() for n, t in mu.items()},
                    {n: t.clone() for n, t in nu.items()})


def _leaf_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, prefix + (k,))
    else:
        yield prefix
