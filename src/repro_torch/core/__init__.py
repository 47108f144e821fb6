"""DxPTA core — the port of `repro.core` (so far: the min-EDP search and the
Pareto-frontier mode).

Pipeline: identify parameters (arch_params) -> analyze significance
(significance, Alg. 1) -> constraint-aware search (search, Alg. 2) over the
component-level cost model (photonic_model + performance_model), driven by
workload descriptions (workload, paper_workloads); factorized holds the
product-space evaluation and the branch-and-bound slab bounds.
"""
from .arch_params import (ALG1_DEFAULTS, LT_BASE, LT_LARGE, PAPER_CONSTRAINTS,
                          Constraints, PTAConfig, config_grid, iter_configs)
from .factorized import (FactorizedSpace, SlabBoundEvaluator,
                         cached_bound_evaluator, decode_digits,
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
from .search import (ENGINES, FACTORIZED_ENGINES, PARETO_ENGINES,
                     REPORT_METRICS, ParetoResult, SearchResult,
                     build_search_space, dxpta_search,
                     evaluate_grid, exhaustive_search,
                     grid_search_vectorized, hw_prefilter,
                     hw_prefilter_masks, merge_running_best,
                     progressive_candidates, search, search_workloads)
from .significance import (SignificanceScore, observe_significance,
                           refinement_sets, significant_params)
from .workload import Gemm, Workload, merge_workloads, transformer_encoder_workload

__all__ = ["ALG1_DEFAULTS", "CONSTANTS", "Constraints", "DEFAULT_OBJECTIVES",
           "DEFAULT_SRAM_MB", "DeviceConstants", "ENGINES",
           "FACTORIZED_ENGINES", "FactorizedSpace", "Gemm", "I32_DIM_LIMIT",
           "LT_BASE", "LT_LARGE", "PAPER_CONSTRAINTS", "PAPER_WORKLOADS",
           "PARETO_ENGINES", "PTAConfig", "ParetoResult", "REPORT_METRICS",
           "SearchResult", "SignificanceScore", "SlabBoundEvaluator",
           "Workload", "area_breakdown", "build_search_space",
           "cached_bound_evaluator", "calc_edp", "config_grid",
           "cycle_factor_tables", "decode_digits", "dominates", "dxpta_search",
           "eval_full", "eval_hw", "eval_hw_config", "eval_wload",
           "eval_wload_arrays", "evaluate_grid", "exhaustive_search",
           "factorized_evaluate_grid", "fps", "gemm_cycles",
           "grid_search_vectorized", "hw_prefilter", "hw_prefilter_masks",
           "iter_configs", "merge_fronts", "merge_running_best",
           "merge_workloads", "observe_significance", "pareto_front",
           "pareto_mask", "pareto_search_refined", "power_breakdown",
           "progressive_candidates", "refinement_sets", "require_i32_dims",
           "search", "search_workloads", "significant_params",
           "slab_bounding_span", "slab_indices", "slab_size", "slab_spans",
           "sram_mb_for_workload", "transformer_encoder_workload",
           "workload_statics"]
