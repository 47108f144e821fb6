"""The port's dry-run of h2o-danube-1.8b train_4k on the 512-card
(pod, data, model) mesh, in a subprocess on "cpu" meshes, with the
assertions of tests/test_dryrun_integration.py's multi-pod case, and the
cell's accounting: the donated state is the whole argument list but the
batch, and the extrapolated GEMM FLOPs are at least the analytic 6·N·D
of the dense layers' products (the attention scores and remat add)."""

from repro_torch.analysis.roofline import model_flops
from repro_torch.configs import SHAPES_BY_NAME, get_config

from test_torch_dryrun import run_cell


def test_dryrun_train_cell_multi_pod(tmp_path):
    (cell,) = run_cell("h2o-danube-1.8b", "train_4k", "multi", tmp_path)
    assert cell["status"] == "ok", cell.get("error")
    assert cell["chips"] == 512
    assert cell["collectives"]["total"] > 0      # pod axis must communicate
    assert cell["roofline"]["useful_flops_ratio"] > 0.05
    mem = cell["memory"]
    assert 0 < mem["alias_size_in_bytes"] < mem["argument_size_in_bytes"]
    mf = model_flops(get_config("h2o-danube-1.8b"),
                     SHAPES_BY_NAME["train_4k"])
    assert cell["gemm_flops"] >= mf * (1 - 0.1)
    assert cell["roofline"]["flops"] >= cell["gemm_flops"]
    assert cell["traced_cuts"] == [{"True": 1}, {"True": 2}]
    assert cell["compile_s"] > 0
