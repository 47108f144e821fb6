"""FLOP accounting of a traced torch program (the counterpart of
`repro/analysis/jaxpr_cost.py`).

`FlopCounter` is a dispatch mode that charges each aten op where the
program states it: an op on DTensors once, at its global shapes (DTensor's
own local ops and the redistributions it inserts run beneath the mode and
are not charged), an op on plain tensors at its shapes, and nothing to the
local ops of an explicit `shard()` redistribution. The rule by op class:

  * GEMMs — `mm`, `bmm`, `addmm`, `baddbmm`: 2·batch·m·n·k (`einsum` and
    `matmul` reach the mode as these); `convolution`: 2 · output elements
    · kernel volume · input channels / groups. Their sum is also kept
    alone (`gemm`), the number that equals the reference's `dot_general`
    FLOPs;
  * views and metadata — ops whose every result aliases an input without
    writing it (`view`, `reshape`, `expand`, `permute`, `transpose`,
    `slice`, `select`, `split`, `unsqueeze`, `detach`, ...), `_unsafe_view`
    and the uninitialized allocations `empty`/`empty_strided`: 0;
  * every other op — elementwise, reductions, copies and casts, fills,
    gathers and scatters, sorts, in-place updates: one FLOP per element of
    its largest result, as `jaxpr_cost` charges each non-dot equation.

Rematerialized forward ops are charged again where the backward pass
recomputes them. A loop that the models run through `models.layers.scan`
is traced once and charged times its trip count (`scaled`), as
`jaxpr_cost` multiplies a scan's body by its length. Counts are Python
ints (a train cell's FLOPs pass 2^53).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..parallel.sharding import GatherFallback, StridedViews, resharding
from .collectives import CollectiveCounter, collective_kind

_SCALE: contextvars.ContextVar = contextvars.ContextVar("op_cost_scale",
                                                        default=1)


def current_scale() -> int:
    """How many times the op being traced runs (1 outside `scaled`)."""
    return _SCALE.get()


@contextlib.contextmanager
def scaled(n: int):
    """Charge every op traced inside n times (nested: multiplied)."""
    token = _SCALE.set(_SCALE.get() * int(n))
    try:
        yield
    finally:
        _SCALE.reset(token)


aten = torch.ops.aten
_FREE = {aten._unsafe_view.default, aten.empty.memory_format,
         aten.empty_strided.default, aten.lift_fresh.default}


def _is_view(func) -> bool:
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def gemm_flops(func, args) -> int:
    """2·batch·m·n·k of a GEMM op (0 for any other op)."""
    packet = func.overloadpacket
    if packet in (aten.mm, aten.addmm):
        a, b = (args[0], args[1]) if packet is aten.mm else (args[1], args[2])
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if packet in (aten.bmm, aten.baddbmm):
        a, b = (args[0], args[1]) if packet is aten.bmm \
            else (args[1], args[2])
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if packet is aten.convolution:
        w = args[1]   # (out channels, in channels / groups, *kernel)
        return 2 * math.prod(_out_shape_conv(args)) * w.shape[1] \
            * math.prod(w.shape[2:])
    return 0


def _out_shape_conv(args):
    x, w, _, stride, padding, dilation, transposed, out_pad, _ = args[:9]
    if transposed:
        raise NotImplementedError("transposed convolution")
    spatial = [(x.shape[2 + i] + 2 * padding[i] - dilation[i]
                * (w.shape[2 + i] - 1) - 1) // stride[i] + 1
               for i in range(len(w.shape) - 2)]
    return [x.shape[0], w.shape[0], *spatial]


def op_flops(func, args, out) -> int:
    """The FLOPs the module docstring's rule charges `func` (once)."""
    g = gemm_flops(func, args)
    if g:
        return g
    if func in _FREE or _is_view(func):
        return 0
    return max((t.numel() for t in tree_leaves(out)
                if isinstance(t, torch.Tensor)), default=0)


class FlopCounter(TorchDispatchMode):
    """Accumulates `total` and `gemm` FLOPs (ints) of the ops it sees."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self.gemm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if resharding() or collective_kind(func) is not None:
            return out
        n = current_scale()
        g = gemm_flops(func, args)
        self.gemm += n * g
        self.total += n * (g or op_flops(func, args, out))
        return out


class FlopCount(NamedTuple):
    total: int
    gemm: int


class Tracer:
    """Everything one trace measures: FLOPs (total and GEMM, global),
    collectives and peak live bytes (local), with `models.layers.scan`
    loops charged once times their trip count. An op DTensor cannot shard
    runs on gathered inputs (`parallel.sharding.GatherFallback`, placed
    under the FLOP counter so the retry's FLOPs are charged once and its
    gathers counted as collectives; `fallbacks` counts them), and a view
    that flattens a sharded dimension that does not lead its group is
    counted by site (`parallel.sharding.StridedViews`; `strided_views`).
    The models' entry points open the rest of
    `parallel.sharding.dtensor_run`."""

    def __enter__(self):
        from ..models.layers import scan_hook

        self.flops = FlopCounter()
        self.local = CollectiveCounter()
        self.fallback = GatherFallback()
        self.views = StridedViews()
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(scan_hook(scaled))
        self._stack.enter_context(self.local)
        self._stack.enter_context(self.fallback)
        self._stack.enter_context(self.views)
        self._stack.enter_context(self.flops)
        return self

    def __exit__(self, *exc):
        return self._stack.__exit__(*exc)

    @property
    def fallbacks(self):
        return dict(self.fallback.counts)

    @property
    def strided_views(self):
        return dict(self.views.sites)


def flops(fn, *args) -> FlopCount:
    """FLOPs of fn(*args) (total, GEMM-only) by the module's rule."""
    with Tracer() as tr:
        fn(*args)
    return FlopCount(tr.flops.total, tr.flops.gemm)


def trace_flops(fn, *args) -> int:
    """Total FLOPs of fn(*args)."""
    return flops(fn, *args).total
