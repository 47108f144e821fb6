"""Candidate-axis sharding specs (the candidate part of the port of
`repro/parallel/sharding.py`).

A spec is a plain tuple with one entry per dimension: None (replicated), a
mesh axis name, or a tuple of axis names. The DSE fan-out shards one
dimension over `CANDIDATE_AXIS`; `sanitize_spec` guards a spec against a
concrete shape. The LM side's `Rules`, `shard()` and `for_mesh` wait for
the dry-run's slice (ROADMAP item 15).
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple, Union

Spec = Tuple[Optional[Union[str, Tuple[str, ...]]], ...]

CANDIDATE_AXIS = "candidates"


def candidate_spec(rank: int, dim: int) -> Spec:
    """Spec sharding dimension `dim` of a rank-`rank` operand over the
    candidate axis, every other dimension replicated. Callers pad the
    candidate dimension to a mesh-size multiple first; `sanitize_spec` with
    the concrete shape guards it."""
    parts = [None] * rank
    parts[dim] = CANDIDATE_AXIS
    return tuple(parts)


def _prod(axes, sizes: Mapping[str, int]) -> int:
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def sanitize_spec(shape: Sequence[int], spec: Sequence,
                  axis_sizes: Mapping[str, int]) -> Spec:
    """Make `spec` valid for `shape` under divisibility rules.

    A mesh axis shards at most one dimension (its first occurrence). For
    each dimension whose sharded size does not divide it, axes are dropped
    (last first) and re-homed onto the trailing dimension, else the largest
    unsharded one, that they divide; axes that fit nowhere are dropped
    (replicated)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))

    def axes_of(e):
        if e is None:
            return []
        return [e] if isinstance(e, str) else list(e)

    out = [axes_of(e) for e in parts]
    seen = set()
    for axes in out:
        for a in list(axes):
            if a in seen:
                axes.remove(a)
            else:
                seen.add(a)
    homeless = []
    for i, axes in enumerate(out):
        while axes and shape[i] % _prod(axes, axis_sizes) != 0:
            homeless.append(axes.pop())
    for ax in homeless:
        order = sorted(range(len(shape)),
                       key=lambda j: (j != len(shape) - 1, -shape[j]))
        for i in order:
            if not out[i] and shape[i] % axis_sizes[ax] == 0:
                out[i] = [ax]
                break
    return tuple(None if not a else (a[0] if len(a) == 1 else tuple(a))
                 for a in out)
