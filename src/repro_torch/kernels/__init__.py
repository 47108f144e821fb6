"""The port's kernels: hand-written CUDA for Hopper (sm_90a) beside their
plain PyTorch versions (`dse_eval`, `ddot_gemm`, `flash_attention`), the
host wrappers that drive them (`ops`) and the oracles (`ref`)."""
from .ops import (cuda_grid_search, ddot_matmul, decode_rows_device,
                  dse_eval_grid, dse_pareto_multi, dse_pareto_multi_factorized,
                  dse_pareto_spans_factorized, dse_search_grid,
                  dse_search_multi, dse_search_multi_factorized,
                  dse_search_spans_factorized, flash_attention,
                  photonic_matmul)
from .ref import (ddot_matmul_ref, dse_eval_ref, dse_pareto_ref,
                  dse_search_ref, flash_attention_ref, quantize4)

__all__ = ["cuda_grid_search", "ddot_matmul", "ddot_matmul_ref",
           "decode_rows_device", "dse_eval_grid", "dse_eval_ref",
           "dse_pareto_multi", "dse_pareto_multi_factorized",
           "dse_pareto_ref", "dse_pareto_spans_factorized", "dse_search_grid",
           "dse_search_multi",
           "dse_search_multi_factorized", "dse_search_spans_factorized",
           "dse_search_ref", "flash_attention", "flash_attention_ref",
           "photonic_matmul", "quantize4"]
