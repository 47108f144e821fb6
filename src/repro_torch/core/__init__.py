"""DxPTA core — the port of `repro.core`.

Pipeline: identify parameters (arch_params) -> analyze significance
(significance, Alg. 1) -> constraint-aware search (search, Alg. 2) over the
component-level cost model (photonic_model + performance_model), driven by
workload descriptions (workload, paper_workloads); factorized holds the
product-space evaluation, the branch-and-bound slab bounds and the slab
ledger, calibration the uncertainty intervals of robust search, and runtime
the resilient control plane (checkpoint/resume, retry, and degradation on
the CPU).
"""
from .arch_params import (ALG1_DEFAULTS, LT_BASE, LT_LARGE, PAPER_CONSTRAINTS,
                          Constraints, PTAConfig, config_grid, iter_configs)
from .calibration import (MONOTONE, CalibratedConstants, RobustBand,
                          as_calibration, audit_monotonicity,
                          calibration_presets, field_direction,
                          load_calibration_preset, metric_direction)
from .factorized import (FactorizedSpace, LedgerRecorder, SlabBoundEvaluator,
                         SlabLedger, cached_bound_evaluator, decode_digits,
                         factorized_evaluate_grid, slab_bounding_span,
                         slab_indices, slab_size, slab_spans)
from .paper_workloads import PAPER_WORKLOADS
from .pareto import (DEFAULT_OBJECTIVES, dominates, merge_fronts, pareto_front,
                     pareto_mask, pareto_search_refined)
from .performance_model import (I32_DIM_LIMIT, calc_edp, cycle_factor_tables,
                                eval_full, eval_wload, eval_wload_arrays,
                                fps, gemm_cycles, require_i32_dims,
                                workload_statics)
from .photonic_model import (CONSTANTS, DEFAULT_SRAM_MB, DeviceConstants,
                             area_breakdown, eval_hw, eval_hw_config,
                             power_breakdown, sram_mb_for_workload)
from .runtime import (FALLBACK_CHAIN, CheckpointMismatch, KillSearch,
                      LaunchError, LaunchExhausted, LaunchTimeout,
                      NanDetected, QueryTimeout, RuntimePolicy, SearchFault,
                      SearchRuntime, gc_checkpoints)
from .search import (ENGINES, FACTORIZED_ENGINES, PARETO_ENGINES,
                     REPORT_METRICS, ROBUST_ENGINES, ParetoResult,
                     SearchResult, WarmStart,
                     build_search_space, dxpta_search,
                     evaluate_grid, exhaustive_search,
                     grid_search_vectorized, hw_prefilter,
                     hw_prefilter_masks, merge_running_best,
                     progressive_candidates, search, search_workloads)
from .significance import (SignificanceScore, observe_significance,
                           refinement_sets, significant_params)
from .workload import Gemm, Workload, merge_workloads, transformer_encoder_workload

__all__ = [n for n in dir() if not n.startswith("_")]
