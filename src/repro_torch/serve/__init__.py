"""DSE-as-a-service: a resident co-search server over the engine layer (the
port of `repro.serve`).

One process answers many (workload, constraint-box) questions: the
`SearchService` keeps the built kernels, `core.factorized.FactorizedSpace` factor
tables and `SlabBoundEvaluator` dyadic-interval tables resident across
queries, memoizes results on a canonicalized (workload fingerprint,
constraint box) key, batches concurrent cold queries into the
multi-workload dynamic-constraint launches, and answers *tightened-box*
constraint-delta queries incrementally by re-pricing the prior search's
`SlabLedger` instead of re-searching the space. The reference's
`repro.scenarios` builds on this service to sweep whole model-zoo x shape
grids (ROADMAP Queue 1 item 12 ports it).
"""
from .batching import QueryBatcher, ServeQuery
from .cache import (box_contains, box_constraints, canonical_box,
                    query_key, workload_key)
from .dse_service import SearchService
from ..core.runtime import RuntimePolicy, SearchRuntime, gc_checkpoints
from ..core.calibration import (CalibratedConstants, RobustBand,
                                load_calibration_preset)

__all__ = [
    "CalibratedConstants", "QueryBatcher", "RobustBand", "RuntimePolicy",
    "SearchRuntime", "SearchService", "ServeQuery", "box_constraints",
    "box_contains", "canonical_box", "gc_checkpoints",
    "load_calibration_preset", "query_key", "workload_key",
]
