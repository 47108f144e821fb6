"""The port stands alone: it imports neither JAX nor the JAX package, and its
entry points run on the card unless the caller asks for the CPU.

No numeric tolerance applies here; every check is exact (module names, raised
errors, build flags).
"""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch.core as P
import repro_torch.models as M
from repro_torch.configs import get_config, reduced
from repro_torch.core.paper_workloads import load
from repro_torch.kernels import _build
from repro_torch.kernels import ops
from repro_torch.scenarios import ScenarioGrid, sweep
from repro_torch.train.serve import Request, Server

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
MODULES = ("repro_torch", "repro_torch.core", "repro_torch.core.search",
           "repro_torch.core.pareto",
           "repro_torch.core.factorized", "repro_torch.interop",
           "repro_torch.kernels", "repro_torch.kernels.dse_eval",
           "repro_torch.kernels.ops", "repro_torch.kernels.ref",
           "repro_torch.kernels._build", "repro_torch.configs",
           "repro_torch.core.extract", "repro_torch.models",
           "repro_torch.models.lm", "repro_torch.train.serve",
           "repro_torch.launch.serve", "repro_torch.kernels.ddot_gemm",
           "repro_torch.kernels.flash_attention",
           "repro_torch.core.calibration", "repro_torch.core.runtime",
           "repro_torch.checkpoint.checkpointing", "repro_torch.testing.faults",
           "repro_torch.serve.cache", "repro_torch.serve.batching",
           "repro_torch.serve.dse_service", "repro_torch.scenarios",
           "repro_torch.scenarios.grid", "repro_torch.scenarios.sweep",
           "repro_torch.parallel", "repro_torch.parallel.slab_sched",
           "repro_torch.models.layers", "repro_torch.models.moe",
           "repro_torch.models.mla", "repro_torch.models.ssd",
           "repro_torch.models.rwkv", "repro_torch.models.encdec")


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
            "print(repr(bad), 'torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.stdout.split() == ["[]", "True"]


def test_no_source_file_names_jax_or_the_reference_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro|ml_dtypes)"
                     r"(\.|\s|$)", re.M)
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    assert len(files) >= 15
    for f in files:
        assert not pat.search(f.read_text()), f


_CFG = reduced(get_config("granite-3-2b"))


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")


@pytest.mark.parametrize("call", [
    lambda wl: P.search(wl),
    lambda wl: P.search(wl, engine="cuda", factorized=True, prune="bound"),
    lambda wl: P.search_workloads([wl]),
    lambda wl: P.search(wl, calibration="node45", robust="worst_case"),
    lambda wl: P.search(wl, runtime=P.RuntimePolicy()),
    lambda wl: P.dxpta_search(wl),
    lambda wl: P.hw_prefilter(P.FactorizedSpace.full(3).to_grid(), wl,
                              P.Constraints()),
    lambda wl: ops.dse_search_grid(P.FactorizedSpace.full(3).to_grid(), wl,
                                   P.Constraints()),
    lambda wl: ops.decode_rows_device(P.FactorizedSpace.full(3), 0, 10),
    lambda wl: P.search(wl, objective="pareto"),
    lambda wl: P.pareto_front(P.FactorizedSpace.full(3).to_grid(), wl),
    lambda wl: ops.dse_pareto_multi(P.FactorizedSpace.full(3).to_grid(),
                                    [wl], [P.Constraints()]),
    lambda wl: ops.ddot_matmul(np.ones((4, 8), np.float32),
                               np.ones((8, 3), np.float32)),
    lambda wl: ops.photonic_matmul(np.ones((4, 8), np.float32),
                                   np.ones((8, 3), np.float32), 0.02, 7),
    lambda wl: ops.flash_attention(*[np.ones((1, 16, 4, 32), np.float32)] * 3),
    lambda wl: M.init_params(reduced(get_config("qwen2.5-3b"))),
    lambda wl: Server(_CFG, M.init_params(_CFG, device="cpu"), 1, 16)
    .generate([Request(prompt=np.arange(1, 5, dtype=np.int32), max_new=2)]),
    lambda wl: P.search(wl, factorized=True, prune="bound", workers=2),
    lambda wl: sweep(ScenarioGrid(models=("rwkv6-7b",), reduce=True)),
    lambda wl: M.init_params(reduced(get_config("olmoe-1b-7b"))),
    lambda wl: M.init_params(reduced(get_config("deepseek-v3-671b"))),
    lambda wl: M.init_params(reduced(get_config("zamba2-7b"))),
    lambda wl: M.init_params(reduced(get_config("rwkv6-7b"))),
    lambda wl: M.init_params(reduced(get_config("seamless-m4t-medium"))),
    lambda wl: M.init_cache(reduced(get_config("zamba2-7b")), 1, 8),
    lambda wl: M.init_cache(reduced(get_config("seamless-m4t-medium")), 1, 8,
                            src_len=4),
], ids=["search", "search_bound", "search_workloads", "search_robust",
        "search_runtime", "dxpta_search",
        "hw_prefilter", "dse_search_grid", "decode_rows_device",
        "search_pareto", "pareto_front", "dse_pareto_multi", "ddot_matmul",
        "photonic_matmul", "flash_attention", "init_params",
        "server_generate", "search_workers", "scenario_sweep",
        "init_params_moe", "init_params_mla_moe", "init_params_hybrid_ssm",
        "init_params_rwkv", "init_params_encdec", "init_cache_hybrid_ssm",
        "init_cache_encdec"])
def test_entry_points_raise_without_a_card(call):
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(load("deit-t"))


def test_kernel_build_keeps_the_float32_contract():
    # No FMA contraction and IEEE division are part of the kernels' parity
    # with their plain versions; the library name follows source and flags.
    assert "-fmad=false" in _build.NVCC_FLAGS
    assert not any("fast_math" in f or "prec-div=false" in f
                   for f in _build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    path = _build.library_path("dse_eval")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libdse_eval-") and path.suffix == ".so"


def test_lm_kernels_build_under_the_same_flags():
    # The exact sources share NVCC_FLAGS (one library each, content-
    # addressed): ddot_gemm's epilogue relies on -fmad=false as the DSE
    # kernels do. The two attention sources, held to a tolerance, build
    # with the same flags less -fmad=false, and never with fast math.
    assert _build.SOURCES == ("dse_eval", "lm_kernels", "flash_attention",
                              "flash_attention_tf32")
    assert _build.FLAGS["dse_eval"] == _build.FLAGS["lm_kernels"] \
        == _build.NVCC_FLAGS
    for name in ("flash_attention", "flash_attention_tf32"):
        assert _build.FLAGS[name] == tuple(
            f for f in _build.NVCC_FLAGS if f != "-fmad=false")
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
        assert "arch=compute_90a,code=sm_90a" in _build.FLAGS[name]
        assert not any("fast_math" in f or "prec-div=false" in f
                       for f in _build.FLAGS[name])
    assert set(_build._SIGNATURES["lm_kernels"]) == {"ddot_gemm_launch"}
    assert set(_build._SIGNATURES["flash_attention"]) == {
        "flash_attention_wgmma_launch"}
    assert set(_build._SIGNATURES["flash_attention_tf32"]) == {
        "flash_attention_tf32_launch", "flash_attention_tf32_smem_bytes"}
