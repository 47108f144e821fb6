"""Calibration uncertainty intervals through the photonic cost model (the
port of `repro.core.calibration`, with its own copies of the presets).

`core/photonic_model.py` is a table of analytic *point* constants, but a
real co-design flow characterizes components per technology node with
measurement error: a config that is feasible only under optimistic
per-device numbers is not a deployable answer. This module carries that
uncertainty as per-field `(lo, nominal, hi)` intervals over every
`DeviceConstants` field (`CalibratedConstants`) and reduces *robust*
("worst-case feasible") search to machinery the engine layer already has.

The reduction rests on one verified lemma (the `MONOTONE` table below,
numerically audited by `audit_monotonicity` and property-tested in
tests/test_robust_search.py): **every report metric is coordinate-wise
monotone in every device constant, and no constant pulls two metrics in
opposite directions.** Area/power/energy constants only ever *increase*
metrics; `f_clk_hz` / `dram_bw_bytes` / `elec_ops_per_s` only ever
*decrease* latency/energy/EDP (their worst case is the `lo` end);
`util` depends on no constant at all. Because the directions never
conflict across metrics, a single corner of the calibration box —
`worst_case()` — simultaneously maximizes every minimized metric, so

    robust search  ==  ordinary search at c = calibration.worst_case()

for every engine, objective, and composition knob (`factorized`,
`chunk_size`, `prune="bound"`, `runtime=`, serve): feasibility masked at
the worst corner is worst-case feasibility, the EDP incumbent is the
worst-case EDP, and the branch-and-bound slab bounds built at the worst
corner (`SlabBoundEvaluator(c=worst)`) are admissible lower bounds of the
worst-case metrics — it is literally a standard search under a different
`DeviceConstants`. The degenerate calibration (`lo == nominal == hi`)
makes `worst_case()` return the nominal constants, so results are
byte-identical to an uncalibrated search (the differential anchor pinned
by tests/test_robust_search.py).

Any (metric, field) pair the audit cannot certify — a direction conflict,
or a field explicitly marked `uncertified=` — falls back to conservative
interval arithmetic by vertex enumeration (`vertex_corners`): each metric
is per-field monotone in each constant separately, so its extrema over
the calibration box are attained at box *vertices*, and the elementwise
max over the 2^k vertices of the uncertified fields (certified fields
pinned at their worst end) is a sound upper bound of every metric — the
same replay-the-reference-model argument `SlabBoundEvaluator` uses to
bound slabs, applied to the constants box instead of the config box.
`core.search` routes robust queries with unresolved fields through that
host-side sweep (`_robust_vertex_search`).

Technology presets (JSON, `calibration_presets/`): `nominal` (degenerate
— the paper point calibration), `conservative` (guard-band intervals for
un-characterized silicon), and `node45` (a characterized per-node-style
table with asymmetric re-centered intervals). Load with
`load_calibration_preset(name)` or pass the name straight to
`search(..., calibration="conservative", robust="worst_case")`.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from .photonic_model import CONSTANTS, DeviceConstants

#: Directory of the shipped JSON technology presets.
PRESET_DIR = os.path.join(os.path.dirname(__file__), "calibration_presets")

FIELD_NAMES = tuple(f.name for f in dataclasses.fields(DeviceConstants))

_AREA_FIELDS = tuple(f for f in FIELD_NAMES if f.startswith("a_"))
#: Power-breakdown constants (every p_* field that power_breakdown sums;
#: p_elec is carried on DeviceConstants for reporting but enters no metric).
_POWER_FIELDS = tuple(f for f in FIELD_NAMES
                      if f.startswith("p_") and f != "p_elec")
#: Constants that sit in a denominator of the latency model: raising them
#: can only *lower* latency (and through power*latency, energy and EDP).
_RATE_FIELDS = ("f_clk_hz", "dram_bw_bytes", "elec_ops_per_s")
#: The derived-SRAM clip bounds feed area, power and energy monotonically.
_SRAM_FIELDS = ("sram_min_mb", "sram_max_mb")

#: Verified per-(metric, field) monotonicity directions of the report
#: metrics in each `DeviceConstants` field: +1 = nondecreasing, -1 =
#: nonincreasing; a field absent from a metric's row does not enter that
#: metric at all (direction 0). This is the lemma the worst-corner
#: reduction relies on; `audit_monotonicity` checks it numerically and
#: tests/test_robust_search.py property-tests it.
MONOTONE: Dict[str, Dict[str, int]] = {
    "area": {**{f: +1 for f in _AREA_FIELDS},
             **{f: +1 for f in _SRAM_FIELDS}},
    "power": {**{f: +1 for f in _POWER_FIELDS},
              **{f: +1 for f in _SRAM_FIELDS}},
    "latency": {f: -1 for f in _RATE_FIELDS},
    # energy = power*latency + e_dram*bytes + e_sram*sram_bytes(act_bits)
    "energy": {**{f: +1 for f in _POWER_FIELDS},
               **{f: +1 for f in _SRAM_FIELDS},
               "e_dram_per_byte": +1, "e_sram_per_byte": +1,
               "act_bits": +1, **{f: -1 for f in _RATE_FIELDS}},
    "util": {},
    # edp = energy * latency: the union of both factors' directions (they
    # never conflict — that is part of what the audit certifies).
    "edp": {**{f: +1 for f in _POWER_FIELDS},
            **{f: +1 for f in _SRAM_FIELDS},
            "e_dram_per_byte": +1, "e_sram_per_byte": +1,
            "act_bits": +1, **{f: -1 for f in _RATE_FIELDS}},
}


def metric_direction(metric: str, field: str) -> int:
    """Certified direction of `metric` in `field`: +1 / -1 / 0 (unused)."""
    return MONOTONE[metric].get(field, 0)


def field_direction(field: str) -> Optional[int]:
    """Consolidated worst-case direction of one constant across all
    metrics: +1 (worst at `hi`), -1 (worst at `lo`), 0 (enters no metric),
    or None when the table holds a cross-metric conflict — a field that
    raises one metric while lowering another has no single worst end, and
    robust search must fall back to vertex enumeration for it. The shipped
    model has no conflicting field (asserted by the audit)."""
    dirs = {MONOTONE[m][field] for m in MONOTONE if field in MONOTONE[m]}
    if not dirs:
        return 0
    if len(dirs) > 1:
        return None
    return dirs.pop()


Interval = Tuple[str, float, float, float]


def _is_number(v) -> bool:
    return isinstance(v, (int, float, np.integer, np.floating)) \
        and not isinstance(v, bool)


@dataclasses.dataclass(frozen=True)
class CalibratedConstants:
    """Per-field calibration intervals over every `DeviceConstants` field.

    `intervals` holds one `(name, lo, nominal, hi)` entry per field, in
    field order — hashable, so calibrations key lru caches and
    fingerprints directly. Fields the calibration does not vary are
    degenerate (`lo == nominal == hi`). Build with the classmethods
    (`from_dict`, `from_rel`, `degenerate`) or `load_calibration_preset`.

    `uncertified` names varying fields whose monotone direction must be
    treated as unknown: robust search prices them by conservative vertex
    enumeration instead of the certified worst corner (see module doc).
    With the shipped `MONOTONE` table it is only ever non-empty when set
    explicitly — the audit certifies every field of the current model.
    """

    intervals: Tuple[Interval, ...]
    uncertified: Tuple[str, ...] = ()

    def __post_init__(self):
        names = tuple(iv[0] for iv in self.intervals)
        if names != FIELD_NAMES:
            raise ValueError(
                f"calibration must cover every DeviceConstants field "
                f"exactly once in field order; got {names!r}")
        for name, lo, nom, hi in self.intervals:
            for label, v in (("lo", lo), ("nominal", nom), ("hi", hi)):
                if not _is_number(v):
                    raise ValueError(f"calibration {name}.{label} must be "
                                     f"a number, got {v!r}")
                if v != v or not np.isfinite(v):
                    raise ValueError(f"calibration {name}.{label} is "
                                     f"non-finite ({v!r})")
                if v <= 0:
                    raise ValueError(f"calibration {name}.{label} must be "
                                     f"> 0, got {v!r}")
            if not (lo <= nom <= hi):
                raise ValueError(f"calibration {name} needs lo <= nominal "
                                 f"<= hi, got ({lo!r}, {nom!r}, {hi!r})")
        unknown = sorted(set(self.uncertified) - set(FIELD_NAMES))
        if unknown:
            raise ValueError(f"uncertified names unknown field(s) "
                             f"{unknown}; expected DeviceConstants fields")

    # -- constructors ------------------------------------------------------

    @classmethod
    def degenerate(cls, c: DeviceConstants = CONSTANTS
                   ) -> "CalibratedConstants":
        """The point calibration of `c`: every interval collapsed."""
        return cls(tuple((f, getattr(c, f), getattr(c, f), getattr(c, f))
                         for f in FIELD_NAMES))

    @classmethod
    def from_dict(cls, spec: Mapping, base: DeviceConstants = CONSTANTS,
                  uncertified: Sequence[str] = ()) -> "CalibratedConstants":
        """Calibration from `{field: interval}`; unlisted fields collapse
        to `base`'s point value. An interval is `(lo, nominal, hi)`,
        `(lo, hi)` (nominal taken from `base`), or `{"rel": r}`
        (`nominal * (1 -/+ r)`)."""
        unknown = sorted(set(spec) - set(FIELD_NAMES))
        if unknown:
            raise ValueError(f"unknown DeviceConstants field(s) {unknown} "
                             f"in calibration spec")
        ivs = []
        for f in FIELD_NAMES:
            nom = getattr(base, f)
            if f not in spec:
                ivs.append((f, nom, nom, nom))
                continue
            v = spec[f]
            if isinstance(v, Mapping):
                rel = float(v["rel"])
                ivs.append((f, nom * (1.0 - rel), nom, nom * (1.0 + rel)))
            elif isinstance(v, Sequence) and len(v) == 3:
                ivs.append((f, float(v[0]), float(v[1]), float(v[2])))
            elif isinstance(v, Sequence) and len(v) == 2:
                ivs.append((f, float(v[0]), nom, float(v[1])))
            else:
                raise ValueError(f"calibration entry for {f!r} must be "
                                 f"(lo, nominal, hi), (lo, hi) or "
                                 f"{{'rel': r}}; got {v!r}")
        return cls(tuple(ivs), uncertified=tuple(uncertified))

    @classmethod
    def from_rel(cls, rel: float, fields: Optional[Sequence[str]] = None,
                 base: DeviceConstants = CONSTANTS) -> "CalibratedConstants":
        """Uniform +/- `rel` relative intervals on `fields` (default: every
        field a metric depends on)."""
        if fields is None:
            fields = sorted({f for row in MONOTONE.values() for f in row})
        return cls.from_dict({f: {"rel": rel} for f in fields}, base=base)

    @classmethod
    def from_json(cls, path: str) -> "CalibratedConstants":
        """Load a technology preset file (see calibration_presets/)."""
        with open(path) as fh:
            doc = json.load(fh)
        return cls.from_dict(doc.get("intervals", {}),
                             uncertified=tuple(doc.get("uncertified", ())))

    # -- corners -----------------------------------------------------------

    def interval(self, field: str) -> Tuple[float, float, float]:
        """(lo, nominal, hi) of one field."""
        for name, lo, nom, hi in self.intervals:
            if name == field:
                return (lo, nom, hi)
        raise KeyError(field)

    @property
    def varying(self) -> Tuple[str, ...]:
        """Fields with a non-degenerate interval, in field order."""
        return tuple(n for n, lo, _, hi in self.intervals if lo != hi)

    @property
    def is_degenerate(self) -> bool:
        """True when every interval is collapsed (lo == nominal == hi) —
        the calibration that must reproduce today's results byte-for-byte."""
        return not self.varying

    def unresolved(self) -> Tuple[str, ...]:
        """Varying fields robust search cannot take to a certified corner:
        explicitly `uncertified` ones plus any with a cross-metric
        direction conflict. Empty with the shipped model."""
        return tuple(f for f in self.varying
                     if f in self.uncertified or field_direction(f) is None)

    def _corner(self, sign: int) -> DeviceConstants:
        """sign=+1: each certified field at its metric-maximizing end;
        sign=-1: the metric-minimizing end. Degenerate and unresolved
        fields keep their exact nominal value (same object — preserving
        int-typed fields like `act_bits`, so the degenerate corner is the
        nominal `DeviceConstants`, equal and hash-equal to `CONSTANTS`
        under the default calibration)."""
        vals = {}
        unresolved = set(self.unresolved())
        for name, lo, nom, hi in self.intervals:
            d = field_direction(name)
            if lo == hi or name in unresolved or not d:
                vals[name] = nom
            else:
                vals[name] = hi if d * sign > 0 else lo
        return DeviceConstants(**vals)

    def nominal(self) -> DeviceConstants:
        """The plain point constants — every existing path runs on these
        untouched when no robust mode is requested."""
        return DeviceConstants(**{n: nom
                                  for n, _, nom, _ in self.intervals})

    def worst_case(self) -> DeviceConstants:
        """The corner that simultaneously maximizes every minimized report
        metric (the `MONOTONE` directions: +1 fields at `hi`, -1 fields at
        `lo`). Robust search is an ordinary search at these constants.
        Unresolved fields stay at nominal here — callers must route them
        through `vertex_corners` (core.search does; `serve` refuses)."""
        return self._corner(+1)

    def best_case(self) -> DeviceConstants:
        """The opposite corner — every metric at its most optimistic value;
        the lower edge of the reported uncertainty band."""
        return self._corner(-1)

    def vertex_corners(self, max_fields: int = 8, sign: int = +1
                       ) -> Tuple[DeviceConstants, ...]:
        """Conservative fallback corners: certified fields pinned at their
        worst (`sign=+1`, default) or best (`sign=-1`) end, unresolved
        fields enumerated over all 2^k (lo, hi) vertices. Elementwise max
        of any metric over the `sign=+1` corners is a sound worst-case
        bound (elementwise min over `sign=-1`, a sound best-case one),
        because each metric is per-field monotone in each constant
        separately, so its box extrema sit at vertices — the same
        replayed-monotone-ops argument that makes `SlabBoundEvaluator`'s
        slab bounds admissible. A fully certified calibration yields
        exactly one corner: `worst_case()` / `best_case()`."""
        unresolved = self.unresolved()
        if len(unresolved) > max_fields:
            raise ValueError(
                f"{len(unresolved)} uncertified varying fields would "
                f"enumerate 2^{len(unresolved)} corners; certify their "
                f"directions (MONOTONE) or reduce the calibration")
        base = self._corner(sign)
        corners = []
        for bits in range(1 << len(unresolved)):
            vals = {f: (self.interval(f)[2] if bits >> i & 1
                        else self.interval(f)[0])
                    for i, f in enumerate(unresolved)}
            corners.append(dataclasses.replace(base, **vals))
        return tuple(corners)


def as_calibration(calibration: Union["CalibratedConstants", Mapping, str]
                   ) -> "CalibratedConstants":
    """Coerce a `calibration=` argument: a `CalibratedConstants` passes
    through, a mapping goes through `from_dict`, a string names a preset."""
    if isinstance(calibration, CalibratedConstants):
        return calibration
    if isinstance(calibration, str):
        return load_calibration_preset(calibration)
    if isinstance(calibration, Mapping):
        return CalibratedConstants.from_dict(calibration)
    raise ValueError(f"calibration must be a CalibratedConstants, a "
                     f"{{field: interval}} mapping, or a preset name; "
                     f"got {calibration!r}")


def calibration_presets() -> Tuple[str, ...]:
    """Names of the shipped JSON technology presets."""
    return tuple(sorted(p[:-5] for p in os.listdir(PRESET_DIR)
                        if p.endswith(".json")))


def load_calibration_preset(name: str) -> CalibratedConstants:
    """Load a shipped preset by name (`nominal`, `conservative`, ...)."""
    path = os.path.join(PRESET_DIR, f"{name}.json")
    if not os.path.exists(path):
        raise ValueError(f"unknown calibration preset {name!r}; shipped "
                         f"presets: {', '.join(calibration_presets())}")
    return CalibratedConstants.from_json(path)


@dataclasses.dataclass(frozen=True)
class RobustBand:
    """The uncertainty band of a robust answer: the winner's (or each
    frontier row's) float64 reference metrics at the worst, nominal and
    best calibration corners. `worst` equals the metrics reported on the
    result itself (robust results are priced at the worst corner);
    `best`/`nominal` report how much headroom the calibration leaves.
    Values are floats on a `SearchResult` band and (F,)-arrays aligned
    with `front` on a `ParetoResult` band."""

    calibration: CalibratedConstants
    worst: Dict[str, Union[float, np.ndarray]]
    nominal: Dict[str, Union[float, np.ndarray]]
    best: Dict[str, Union[float, np.ndarray]]

    def width(self, metric: str):
        """worst - best: the calibration-induced spread of one metric."""
        return self.worst[metric] - self.best[metric]


def audit_monotonicity(configs, wl, c: DeviceConstants = CONSTANTS,
                       rel: float = 0.2):
    """Numerically check the `MONOTONE` table: for every (metric, field)
    pair, perturb `field` by -/+ `rel` around `c` and verify each metric
    of every config moves (weakly) in the certified direction — including
    direction 0, which asserts the metric does not depend on the field at
    all. Returns the violations as `(metric, field, direction)` tuples
    (empty == the table is certified for this model).

    Weak inequalities are the right check: the model's monotonicity is
    non-strict by construction (`max` branches, the derived-SRAM clip), and
    non-strict is all the worst-corner reduction needs.
    """
    from .search import evaluate_grid  # deferred: search imports this module
    grid = np.asarray(configs)
    violations = []
    fields = sorted({f for row in MONOTONE.values() for f in row}
                    | set(FIELD_NAMES))
    for field in fields:
        nom = getattr(c, field)
        lo_c = dataclasses.replace(c, **{field: nom * (1.0 - rel)})
        hi_c = dataclasses.replace(c, **{field: nom * (1.0 + rel)})
        m_lo = evaluate_grid(grid, wl, lo_c)
        m_hi = evaluate_grid(grid, wl, hi_c)
        for metric in MONOTONE:
            d = metric_direction(metric, field)
            delta = np.asarray(m_hi[metric]) - np.asarray(m_lo[metric])
            ok = (np.all(delta == 0.0) if d == 0
                  else np.all(d * delta >= 0.0))
            if not ok:
                violations.append((metric, field, d))
    return violations
