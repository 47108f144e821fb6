"""Canonical memo keys for the search service (the port of
`repro.serve.cache`).

Two queries that mean the same thing must hit the same cache entry no
matter how they were spelled: constraint boxes arrive as `Constraints`
objects or as plain dicts in any key order, bounds arrive as ints or
floats, and workloads arrive as `Workload` objects whose identity is
their content, not their Python id. This module owns that
canonicalization — every key the service stores or looks up is built
here, from `core.runtime.fingerprint` digests of canonical forms.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple, Union

from ..core.arch_params import Constraints
from ..core.runtime import fingerprint
from ..core.workload import Workload

#: Constraint-box axes, in canonical (sorted) order.
BOX_FIELDS = ("area_mm2", "energy_mj", "latency_ms", "power_w")

Box = Tuple[Tuple[str, float], ...]


def canonical_box(constraints: Union[Constraints, Mapping]) -> Box:
    """Canonical form of a constraint box: sorted `(name, float)` pairs.

    Accepts a `Constraints` or any mapping over its field names (missing
    names take the paper defaults). Key order and int-vs-float spelling
    never reach the memo key:

    >>> canonical_box({"power_w": 5, "area_mm2": 50.0}) == \\
    ...     canonical_box({"area_mm2": 50, "power_w": 5.0})
    True
    >>> canonical_box(Constraints()) == canonical_box({})
    True
    >>> canonical_box({"watts": 5})  # doctest: +ELLIPSIS
    Traceback (most recent call last):
        ...
    ValueError: unknown constraint field(s) ['watts']...
    """
    if isinstance(constraints, Constraints):
        vals = {f: float(getattr(constraints, f)) for f in BOX_FIELDS}
    else:
        unknown = sorted(set(constraints) - set(BOX_FIELDS))
        if unknown:
            raise ValueError(f"unknown constraint field(s) {unknown}; "
                             f"expected a subset of {BOX_FIELDS}")
        # Round-trip through Constraints: validates the bounds (positive,
        # non-NaN) and fills defaults exactly like a direct construction.
        cons = Constraints(**{k: float(v) for k, v in constraints.items()})
        vals = {f: float(getattr(cons, f)) for f in BOX_FIELDS}
    return tuple((f, vals[f]) for f in BOX_FIELDS)


def box_constraints(box: Box) -> Constraints:
    """The `Constraints` a canonical box denotes (inverse of
    `canonical_box`)."""
    return Constraints(**dict(box))


def box_contains(outer: Box, inner: Box) -> bool:
    """True when `inner` is a *tightening* of `outer` (every bound at or
    below the outer bound) — the precondition of the warm
    constraint-delta path.

    >>> base = canonical_box({})
    >>> box_contains(base, canonical_box({"power_w": 4.0}))
    True
    >>> box_contains(base, canonical_box({"power_w": 6.0}))
    False
    """
    o, i = dict(outer), dict(inner)
    return all(i[f] <= o[f] for f in BOX_FIELDS)


def workload_key(wl: Workload) -> str:
    """Content fingerprint of a workload (the name rides along only to
    keep distinct aliases of identical GEMM lists distinguishable in
    service logs — it is part of the key, so cached results never cross
    workload names)."""
    return fingerprint(name=wl.name, gemms=wl.gemm_array,
                       elec_ops=wl.elec_ops, weight_bytes=wl.weight_bytes,
                       act_io_bytes=wl.act_io_bytes,
                       max_act_bytes=wl.max_act_bytes, batch=wl.batch)


def query_key(wl_key: str, box: Box, axes: tuple, objective: str,
              metrics: Optional[tuple], constants: str = "") -> str:
    """Memo key of one fully-specified query: canonical workload digest +
    canonical box + the product-space axes + objective (+ pareto metric
    tuple) + the service's constants fingerprint. Engine and chunking are
    deliberately *excluded*: every engine x chunk_size combination returns
    byte-identical winners/frontiers, so
    they name the same answer. `constants` is *included* (the service
    passes `SearchService.constants_fingerprint`): different
    `DeviceConstants` — or different calibrations / robust modes — price
    different cost models, so their answers, and the checkpoint
    directories `query_checkpoint_dir` derives from this key, must never
    collide."""
    return fingerprint(wl=wl_key, box=box, axes=axes, objective=objective,
                       metrics=metrics, constants=constants)


def base_key(wl_key: str, axes: tuple, objective: str,
             metrics: Optional[tuple], constants: str = "") -> str:
    """Key of the box-independent *base entry* (ledger + evaluated-point
    store) that warm constraint-delta queries re-price against — the
    `query_key` with the box left out (and the same constants
    fingerprint: a ledger priced under one cost model must not warm-start
    another's)."""
    return fingerprint(wl=wl_key, axes=axes, objective=objective,
                       metrics=metrics, constants=constants)
