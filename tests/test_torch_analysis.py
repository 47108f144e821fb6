"""The port's analysis stack (the analogues of tests/test_analysis.py): the
collective counter on a synthetic redistribution over a fake 16-rank CPU
mesh, the H100 roofline's terms, `model_flops` against the reference for
every arch x shape, and the report / compare renderings against the
reference's, character for character, on the same cell JSON. Every check
is exact except the roofline's float terms (pytest.approx's default
relative 1e-6, as the reference's own test)."""
import contextlib
import io
import json
import sys

import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

import repro.analysis.compare as ref_compare
import repro.analysis.report as ref_report
from repro.analysis.hlo import COLLECTIVE_KINDS as REF_KINDS
from repro.analysis.roofline import model_flops as ref_model_flops
from repro.configs import get_config as ref_get_config
from repro_torch.analysis import compare, report
from repro_torch.analysis.collectives import (COLLECTIVE_KINDS,
                                              CollectiveCounter,
                                              collective_bytes,
                                              collective_counts)
from repro_torch.analysis.roofline import (HBM_BW, ICI_BW, PEAK_FLOPS,
                                           Roofline, model_flops)
from repro_torch.configs import SHAPES_BY_NAME, get_config, list_archs
from repro_torch.launch.mesh import destroy_fake_world, init_fake_world


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    init_fake_world()
    yield DeviceMesh("cpu", torch.arange(16).reshape(4, 4),
                     mesh_dim_names=("data", "model"))
    destroy_fake_world()


def _dt(local_shape, mesh, placements, shape):
    return DTensor.from_local(torch.empty(local_shape, device="meta"), mesh,
                              placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def test_collective_kinds_are_the_references():
    assert COLLECTIVE_KINDS == REF_KINDS


def test_collective_counter_on_a_synthetic_redistribution(mesh):
    x = _dt((16, 8), mesh, (Shard(0), Shard(1)), (64, 32))
    p = _dt((16, 32), mesh, (Shard(0), Partial()), (64, 32))
    with CollectiveCounter() as cc:
        x.redistribute(mesh, (Shard(0), Replicate()))   # gather over model
        p.redistribute(mesh, (Shard(0), Replicate()))   # all-reduce
        p.redistribute(mesh, (Shard(0), Shard(1)))      # reduce-scatter
        x.redistribute(mesh, (Replicate(), Replicate()))  # two gathers
    b = collective_bytes(cc.events)
    assert b["all-gather"] == 16 * 32 * 4 + (16 * 32 * 4 + 64 * 32 * 4)
    assert b["all-reduce"] == 16 * 32 * 4
    assert b["reduce-scatter"] == 16 * 8 * 4
    assert b["total"] == sum(v for k, v in b.items() if k != "total")
    c = collective_counts(cc.events)
    assert c == {"all-gather": 3, "all-reduce": 1, "reduce-scatter": 1}


def test_collective_counter_charges_a_scaled_loop_its_trips(mesh):
    from repro_torch.analysis.op_cost import scaled
    x = _dt((16, 8), mesh, (Shard(0), Shard(1)), (64, 32))
    with CollectiveCounter() as cc:
        with scaled(5):
            x.redistribute(mesh, (Shard(0), Replicate()))
    assert collective_counts(cc.events) == {"all-gather": 5}
    assert collective_bytes(cc.events)["total"] == 5 * 16 * 32 * 4


def test_roofline_terms_and_bottleneck():
    r = Roofline(flops=256 * PEAK_FLOPS, hbm_bytes=256 * HBM_BW * 0.5,
                 collective_bytes_per_chip=ICI_BW * 0.1, chips=256,
                 model_flops=128 * PEAK_FLOPS)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(0.5)
    assert r.t_collective == pytest.approx(0.1)
    assert r.bottleneck == "compute"
    assert r.useful_flops_ratio == pytest.approx(0.5)
    assert r.roofline_fraction == pytest.approx(0.5)
    assert (PEAK_FLOPS, HBM_BW, ICI_BW) == (989e12, 3.35e12, 50e9)
    r = Roofline(flops=1.0, hbm_bytes=1.0,
                 collective_bytes_per_chip=ICI_BW, chips=2)
    assert r.bottleneck == "collective" and r.roofline_fraction is None


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_equal_the_reference(arch):
    for s in SHAPES_BY_NAME.values():
        assert model_flops(get_config(arch), s) == \
            ref_model_flops(ref_get_config(arch), s)


_OK = {"arch": "qwen2.5-3b", "shape": "train_4k", "mesh": "single",
       "chips": 256, "status": "ok", "compile_s": 12.25,
       "memory": {"argument_size_in_bytes": 123456789,
                  "output_size_in_bytes": 1234, "temp_size_in_bytes": 98765,
                  "alias_size_in_bytes": 4321},
       "collectives": {"all-gather": 1.5e9, "total": 1.5e9},
       "collective_counts": {"all-gather": 3},
       "roofline": Roofline(3.2e18, 4.5e12, 1.5e9, 256, 1.9e18).as_dict()}


def _cells():
    ok2 = dict(_OK, shape="decode_32k", mesh="multi", chips=512,
               memory={}, roofline=Roofline(2.0e12, 7.0e11, 2.2e10, 512,
                                            6.4e11).as_dict())
    no_model = dict(ok2, arch="granite-3-2b", roofline=Roofline(
        2.0e12, 7.0e11, 2.2e10, 512, 0.0).as_dict())
    skip = {"arch": "qwen2.5-3b", "shape": "long_500k", "mesh": "single",
            "chips": 256, "status": "skipped",
            "reason": "pure full-attention arch: no sub-quadratic path"}
    err = {"arch": "olmoe-1b-7b", "shape": "train_4k", "mesh": "multi",
           "chips": 512, "status": "error",
           "error": "RuntimeError: " + "x" * 80, "compile_s": 1.0}
    return [_OK, ok2, no_model, skip, err]


def test_report_tables_equal_the_references():
    cells = _cells()
    assert report.dryrun_table(cells) == ref_report.dryrun_table(cells)
    assert report.roofline_table(cells) == ref_report.roofline_table(cells)


def _main_output(module, argv):
    out = io.StringIO()
    saved = sys.argv
    sys.argv = ["prog"] + argv
    try:
        with contextlib.redirect_stdout(out):
            module.main()
    finally:
        sys.argv = saved
    return out.getvalue()


def test_report_and_compare_mains_equal_the_references(tmp_path):
    base, opt = tmp_path / "base.json", tmp_path / "opt.json"
    cells = [c for c in _cells() if c["arch"] != "granite-3-2b"]
    faster = [dict(c, roofline=dict(c["roofline"], roofline_fraction=(
        c["roofline"]["roofline_fraction"] or 0.01) * 3,
        t_collective_s=c["roofline"]["t_collective_s"] / 2))
        if c["status"] == "ok" else c for c in cells]
    base.write_text(json.dumps(cells))
    opt.write_text(json.dumps(faster))
    assert _main_output(report, [str(base)]) == \
        _main_output(ref_report, [str(base)])
    got = _main_output(compare, [str(base), str(opt)])
    assert got == _main_output(ref_compare, [str(base), str(opt)])
    assert "geometric-mean gain" in got
