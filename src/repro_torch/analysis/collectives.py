"""Collective traffic of a traced torch program (the counterpart of
`repro/analysis/hlo.py`, which parses it from the compiled SPMD module).

`CollectiveCounter` is a dispatch mode at the level of the local shards: it
lets DTensor ops through to DTensor, and records each functional collective
that DTensor (or an explicit redistribution) issues on the shards —
`_c10d_functional.all_gather_into_tensor` as "all-gather",
`reduce_scatter_tensor` as "reduce-scatter", `all_reduce` as "all-reduce",
`all_to_all_single` as "all-to-all" (and their coalesced forms) — with the
bytes of its local result, which are per participant, as the reference's
HLO result sizes are; `typed` keeps each one's element type too, in the
HLO's names (`collective_bytes_by_dtype`). A loop body charged once for
its trip count (`op_cost.scaled`) counts that many times.

The same mode keeps the peak of the live bytes that the traced program
allocates on one device (every new storage of a local op, freed when its
storage dies): a lower bound of the program's temporary memory, since it
sees neither the allocator's rounding nor fragmentation, and on a
depth-cut trace it sees the cut depth's peak.

`collective_bytes_scaled` has no counterpart: the port's loops are not
compiled into while-loops whose bodies would need scaling after the fact.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Dict, Iterable, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

_KIND_OF = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_to_all_single": "all-to-all",
}

#: one recorded collective: (kind, result bytes, times it ran)
Event = Tuple[str, int, int]

# torch dtypes by the HLO's element type names
_HLO_DTYPE = {torch.float32: "f32", torch.bfloat16: "bf16",
              torch.float16: "f16", torch.float64: "f64",
              torch.int32: "s32", torch.int64: "s64", torch.bool: "pred"}


def collective_kind(func):
    """The kind of a `_c10d_functional` collective op, else None."""
    if func.namespace != "_c10d_functional":
        return None
    return _KIND_OF.get(func._opname)


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


class CollectiveCounter(TorchDispatchMode):
    """Records collectives (`events`, and in `typed` each with its element
    type: (kind, dtype, result bytes, times it ran)) and the peak of live
    local bytes (`peak_bytes`) while it is active; `scale` is read at each
    op from `op_cost.current_scale()`."""

    def __init__(self):
        super().__init__()
        self.events = []
        self.typed = []
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        from .op_cost import current_scale

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if any(_is_fake(t) for t in outs) or any(
                _is_fake(t) for t in tree_leaves((args, kwargs))):
            return out  # DTensor's sharding propagation on fake tensors
        kind = collective_kind(func)
        if kind is not None:
            n = current_scale()
            nbytes = n * sum(t.untyped_storage().nbytes() for t in outs)
            self.events.append((kind, nbytes, n))
            self.typed.append((kind, _HLO_DTYPE.get(outs[0].dtype,
                                                    str(outs[0].dtype)),
                               nbytes, n))
        self._track(args, kwargs, outs)
        return out

    def _track(self, args, kwargs, outs) -> None:
        inputs = {t.untyped_storage()._cdata
                  for t in tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in inputs or key in self._live:
                continue
            self._live.add(key)
            nbytes = st.nbytes()
            self.live_bytes += nbytes
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key, nbytes)

    def _free(self, key, nbytes) -> None:
        self._live.discard(key)
        self.live_bytes -= nbytes


def collective_bytes(events: Iterable[Event]) -> Dict[str, float]:
    """Sum of collective result bytes per kind (plus 'total')."""
    out: Dict[str, float] = defaultdict(float)
    for kind, nbytes, _ in events:
        out[kind] += nbytes
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return dict(out)


def collective_bytes_by_dtype(typed) -> Dict[str, float]:
    """Sum of collective result bytes per "kind dtype" (e.g.
    "reduce-scatter f32") of `CollectiveCounter.typed`."""
    out: Dict[str, float] = defaultdict(float)
    for kind, dtype, nbytes, _ in typed:
        out[f"{kind} {dtype}"] += nbytes
    return dict(out)


def collective_counts(events: Iterable[Event]) -> Dict[str, int]:
    """Number of collectives per kind."""
    out: Dict[str, int] = defaultdict(int)
    for kind, _, n in events:
        out[kind] += n
    return dict(out)
