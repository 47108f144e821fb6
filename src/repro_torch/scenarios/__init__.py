"""Scenario co-search at serving scale: the model zoo x shape grid (the port
of `repro.scenarios`).

`grid` names and dedups the (model config, input shape) product —
every cell is one extraction question for `core.extract.workload_for` —
and `sweep` batches the whole grid through a resident
`serve.SearchService`, returning per-scenario winners plus the
cross-scenario summary: which architecture parameter the winning PTA
configs move between decode's tiny-M and prefill/train's large-M
pressure (the paper's Alg. 1 significance question, answered empirically
per scenario class). See ``docs/ARCHITECTURE.md`` for the extraction ->
search data flow.
"""
from .grid import (KINDS, Scenario, ScenarioGrid, dedup_scenarios,
                   resolve_model, scenario_key, scenario_shape)
from .sweep import (ScenarioResult, SweepReport, resolve_constraints,
                    sweep)

__all__ = [
    "KINDS", "Scenario", "ScenarioGrid", "ScenarioResult", "SweepReport",
    "dedup_scenarios", "resolve_constraints", "resolve_model",
    "scenario_key", "scenario_shape", "sweep",
]
