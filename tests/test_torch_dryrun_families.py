"""One decode cell of each of the six model families at its reduced config
on a small fake (pod=2, data=2, model=4) mesh, in process: status "ok",
with FLOPs, collectives and per-device memory, the parameters laid out by
`param_specs` and the cache by `cache_specs` (exact shard shapes)."""
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import destroy_fake_world, init_fake_world

FAMILIES = ("qwen2.5-3b", "olmoe-1b-7b", "deepseek-v3-671b", "zamba2-7b",
            "rwkv6-7b", "seamless-m4t-medium")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    init_fake_world()
    yield DeviceMesh("cpu", torch.arange(16).reshape(2, 2, 4),
                     mesh_dim_names=("pod", "data", "model"))
    destroy_fake_world()


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_cell_of_each_family(mesh, arch):
    cfg = reduced(get_config(arch))
    shape = ShapeConfig("decode_tiny", 32, 8, "decode")
    cell = D.measure_cell(cfg, shape, mesh)
    assert cell["status"] == "ok"
    rl = cell["roofline"]
    assert rl["flops"] >= cell["gemm_flops"] > 0
    assert rl["chips"] == 16
    assert cell["collectives"]["total"] > 0
    mem = cell["memory"]
    assert 0 < mem["alias_size_in_bytes"] < mem["argument_size_in_bytes"]
    assert mem["temp_size_in_bytes"] > 0
    _, args, _ = D.build_cell(cfg, shape, mesh)
    params, _, _, cache = args
    for name, p in params.named_parameters():
        assert p.to_local().is_meta, name
    assert D.argument_bytes(args, shape) == mem["argument_size_in_bytes"]
    assert sum(v.to_local().numel() * v.element_size()
               for v in cache.values()) == mem["alias_size_in_bytes"]
