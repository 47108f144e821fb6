"""The port's dry-run at published widths, and its sharding constraint.

* The assertions of tests/test_dryrun_integration.py (which the reference
  fails: its embedding gather raises a ShardingTypeError), each cell in a
  subprocess of `python -m repro_torch.launch.dryrun --device-type cpu`:
  granite-3-2b decode_32k on the 256-card mesh, the long-context skip
  policy (qwen2.5-3b skipped, rwkv6-7b traced). The 512-card train cell is
  in test_torch_dryrun_multipod.py, one decode cell a family on a small
  mesh in test_torch_dryrun_families.py, the rules on a real one-device
  mesh in test_torch_dryrun_one_device.py.
* `shard()` is the identity under NULL_RULES and on plain tensors, and
  redistributes a DTensor.
"""
import json
import os
import subprocess
import sys

import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.launch.mesh import destroy_fake_world, init_fake_world
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.specs import distribute

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_cell(arch, shape, mesh, tmp_path):
    out = tmp_path / f"{arch}-{shape}-{mesh}.json"
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--device-type", "cpu",
         "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    return json.load(open(out))


def test_dryrun_decode_cell_single_pod(tmp_path):
    (cell,) = run_cell("granite-3-2b", "decode_32k", "single", tmp_path)
    assert cell["status"] == "ok"
    assert cell["chips"] == 256
    rl = cell["roofline"]
    assert rl["flops"] > 0
    assert rl["t_memory_s"] > 0
    assert rl["bottleneck"] in ("compute", "memory", "collective")
    mem = cell["memory"]
    assert mem["alias_size_in_bytes"] <= mem["argument_size_in_bytes"]
    assert mem["temp_size_in_bytes"] > 0


def test_dryrun_long_context_skip_policy(tmp_path):
    (cell,) = run_cell("qwen2.5-3b", "long_500k", "single", tmp_path)
    assert cell["status"] == "skipped"
    (cell,) = run_cell("rwkv6-7b", "long_500k", "single", tmp_path)
    assert cell["status"] == "ok"


@pytest.fixture(scope="module")
def mesh():
    init_fake_world()
    yield DeviceMesh("cpu", torch.arange(16).reshape(4, 4),
                     mesh_dim_names=("data", "model"))
    destroy_fake_world()


def test_shard_is_the_identity_without_rules_or_on_a_plain_tensor(mesh):
    x = torch.ones(4, 8)
    assert shd.shard(x, shd.NULL_RULES.resid) is x
    assert shd.shard(x, ("data", "model")) is x
    d = distribute(torch.empty(8, 8, device="meta"), ("data", None), mesh)
    assert shd.shard(d, None) is d


def test_shard_redistributes_a_dtensor(mesh):
    d = distribute(torch.empty(8, 16, device="meta"), ("data", None), mesh)
    assert d.placements == (Shard(0), Replicate())
    e = shd.shard(d, (None, "model"))
    assert isinstance(e, DTensor) and e.placements == (Replicate(), Shard(1))
    assert e.to_local().shape == (8, 4)
    shd.set_active_axis_sizes({"data": 4, "model": 4})
    try:   # 2 rows cannot split 4 ways: sanitized onto the columns
        f = shd.shard(distribute(torch.empty(2, 16, device="meta"), (), mesh),
                      ("model", None))
    finally:
        shd.set_active_axis_sizes(None)
    assert f.placements == (Replicate(), Shard(1))



def test_dtensor_run_opens_its_contexts_only_for_dtensors(mesh):
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    def fallbacks():
        return sum(isinstance(m, shd.GatherFallback)
                   for m in _get_current_dispatch_mode_stack())

    d = distribute(torch.empty(8, 8, device="meta"), ("data", None), mesh)
    plain = torch.ones(8, 8, device="meta")
    with shd.dtensor_run(torch.nn.Linear(2, 2), {"x": plain}):
        assert fallbacks() == 0
        with pytest.raises(RuntimeError, match="mixed"):
            d + plain
    model = torch.nn.Linear(8, 8, device="meta")
    model.weight = torch.nn.Parameter(d)
    with shd.dtensor_run(model):
        assert fallbacks() == 1
        with shd.dtensor_run(model, {"x": d}):     # nested: nothing more
            assert fallbacks() == 1
        out = d + plain                           # still replicated in
        assert isinstance(out, DTensor) and out.placements == d.placements
    with shd.GatherFallback(), shd.dtensor_run({"x": d}):
        assert fallbacks() == 1                    # the caller's own
    with pytest.raises(RuntimeError, match="mixed"):
        d + plain
