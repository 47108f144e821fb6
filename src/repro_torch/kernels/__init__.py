"""The port's kernels: hand-written CUDA for Hopper (sm_90a) beside their
plain PyTorch versions (`dse_eval`), the host wrappers that drive them
(`ops`) and the float64 numpy oracles (`ref`)."""
from .ops import (cuda_grid_search, decode_rows_device, dse_eval_grid,
                  dse_pareto_multi, dse_pareto_multi_factorized,
                  dse_pareto_spans_factorized, dse_search_grid,
                  dse_search_multi, dse_search_multi_factorized,
                  dse_search_spans_factorized)
from .ref import dse_eval_ref, dse_search_ref

__all__ = ["cuda_grid_search", "decode_rows_device", "dse_eval_grid",
           "dse_eval_ref", "dse_pareto_multi", "dse_pareto_multi_factorized",
           "dse_pareto_spans_factorized", "dse_search_grid", "dse_search_multi",
           "dse_search_multi_factorized", "dse_search_spans_factorized",
           "dse_search_ref"]
