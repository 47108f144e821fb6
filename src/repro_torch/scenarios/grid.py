"""Scenario grids: the model zoo x serving-shape product, named and deduped
(the port of `repro.scenarios.grid`).

A *scenario* is one (model config, input shape) cell — exactly what
`core.extract.workload_for` lowers to a DxPTA `Workload`. A
`ScenarioGrid` spans the product model x kind x seq_len x batch x
new_tokens and expands it into a list of scenarios whose names and
extraction fingerprints are guaranteed collision-free, so the serve
layer's content-keyed memo (`serve.cache.workload_key` includes the
workload name) never conflates two different questions and never asks
the same question twice under different spellings.

Two normalizations make dedup exact:

  * `new_tokens` is a decode-only knob — train/prefill cells collapse it
    to the `ShapeConfig` default so the same prefill question cannot
    appear once per decode length;
  * `scenario_key` fingerprints the extraction *inputs* (config fields +
    the shape fields `workload_for` reads), so two spellings that would
    extract identical workloads share a key without running the
    extractor.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, List, Tuple, Union

from ..configs import ARCHS, get_config
from ..configs import reduced as _reduced
from ..configs.base import ModelConfig, ShapeConfig
from ..core.extract import workload_for
from ..core.runtime import fingerprint
from ..core.workload import Workload

#: Extraction paths `workload_for` dispatches on, in canonical order.
KINDS = ("train", "prefill", "decode")

_DEFAULT_NEW_TOKENS = ShapeConfig.__dataclass_fields__["new_tokens"].default

ModelLike = Union[str, ModelConfig]


def resolve_model(model: ModelLike) -> ModelConfig:
    """A `ModelConfig` from an arch-registry name or a config object."""
    if isinstance(model, ModelConfig):
        return model
    return get_config(model)


def scenario_shape(kind: str, seq_len: int, batch: int,
                   new_tokens: int = _DEFAULT_NEW_TOKENS) -> ShapeConfig:
    """Canonical `ShapeConfig` of one scenario cell.

    Non-decode kinds collapse `new_tokens` to the field default (the
    extractor ignores it there), so equal questions get equal shapes. The
    shape name encodes every field the extractor reads — distinct cells
    can never share a name.
    """
    if kind not in KINDS:
        raise ValueError(f"unknown scenario kind {kind!r}; pick from {KINDS}")
    if seq_len < 1 or batch < 1 or new_tokens < 1:
        raise ValueError(f"scenario dims must be >= 1, got seq_len={seq_len} "
                         f"batch={batch} new_tokens={new_tokens}")
    nt = int(new_tokens) if kind == "decode" else _DEFAULT_NEW_TOKENS
    name = f"{kind}{seq_len}b{batch}" + (f"n{nt}" if kind == "decode" else "")
    return ShapeConfig(name, int(seq_len), int(batch), kind, nt)


def scenario_key(cfg: ModelConfig, shape: ShapeConfig) -> str:
    """Content fingerprint of one extraction question.

    Equal exactly when `workload_for(cfg, shape)` would produce identical
    workloads: it digests every config field plus the shape fields the
    extractor reads — kind, seq_len, batch, and (decode only) new_tokens.
    The shape *name* is deliberately excluded; it never feeds extraction.
    """
    nt = shape.new_tokens if shape.kind == "decode" else None
    return fingerprint(cfg=dataclasses.asdict(cfg), kind=shape.kind,
                       seq=shape.seq_len, batch=shape.global_batch,
                       new_tokens=nt)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One (model, shape) cell of a sweep — hashable, extractable."""

    cfg: ModelConfig
    shape: ShapeConfig

    @property
    def name(self) -> str:
        """Human-facing scenario id: ``<model>/<shape>``."""
        return f"{self.cfg.name}/{self.shape.name}"

    @property
    def kind(self) -> str:
        """The scenario class: train | prefill | decode."""
        return self.shape.kind

    def key(self) -> str:
        """The extraction-content fingerprint (`scenario_key`)."""
        return scenario_key(self.cfg, self.shape)

    def workload(self) -> Workload:
        """Lower through `core.extract.workload_for`."""
        return workload_for(self.cfg, self.shape)


def _ints(vals) -> Tuple[int, ...]:
    return tuple(int(v) for v in vals)


@dataclasses.dataclass(frozen=True)
class ScenarioGrid:
    """A product grid of scenarios over the model zoo.

    `expand()` walks models x kinds x seq_lens x batches x new_tokens
    (the last axis applies to decode cells only), drops duplicate
    extraction questions via `scenario_key`, and verifies the surviving
    names are collision-free — a custom config reusing a registry name
    is an error here rather than a silent memo collision downstream.

    Args:
      models: arch-registry names and/or `ModelConfig` objects.
      kinds: subset of ``("train", "prefill", "decode")``.
      seq_lens / batches: positive ints, one scenario per combination.
      new_tokens: decode lengths; non-decode kinds ignore this axis.
      reduce: lower each model through `configs.reduced` first (tiny
        same-family configs — the CPU-smoke spelling of the zoo).
    """

    models: Tuple[ModelLike, ...]
    kinds: Tuple[str, ...] = ("prefill", "decode")
    seq_lens: Tuple[int, ...] = (2048,)
    batches: Tuple[int, ...] = (1,)
    new_tokens: Tuple[int, ...] = (_DEFAULT_NEW_TOKENS,)
    reduce: bool = False

    @classmethod
    def zoo(cls, **overrides) -> "ScenarioGrid":
        """The full 10-arch registry as the model axis."""
        overrides.setdefault("models", tuple(sorted(ARCHS)))
        return cls(**overrides)

    def expand(self) -> List[Scenario]:
        """The deduped, collision-checked scenario list, in grid order."""
        out: List[Scenario] = []
        seen_keys = {}
        names = {}
        for model in self.models:
            cfg = resolve_model(model)
            if self.reduce:
                cfg = _reduced(cfg)
            for kind in self.kinds:
                nts = _ints(self.new_tokens) if kind == "decode" \
                    else (_DEFAULT_NEW_TOKENS,)
                cells = itertools.product(_ints(self.seq_lens),
                                          _ints(self.batches), nts)
                for seq, batch, nt in cells:
                    sc = Scenario(cfg, scenario_shape(kind, seq, batch, nt))
                    k = sc.key()
                    if k in seen_keys:
                        continue
                    seen_keys[k] = sc
                    if sc.name in names:
                        raise ValueError(
                            f"scenario name collision: {sc.name!r} names "
                            f"two different extraction questions — model "
                            f"configs passed to a grid must have distinct "
                            f"names")
                    names[sc.name] = sc
                    out.append(sc)
        return out

    @property
    def size(self) -> int:
        """Number of distinct scenarios (`len(expand())`)."""
        return len(self.expand())


def dedup_scenarios(scenarios: Iterable[Scenario]) -> List[Scenario]:
    """Order-preserving dedup of an arbitrary scenario list by
    `scenario_key` (grids are already deduped; this covers hand-built
    lists fed straight to `sweep`)."""
    out, seen = [], set()
    for sc in scenarios:
        k = sc.key()
        if k not in seen:
            seen.add(k)
            out.append(sc)
    return out
