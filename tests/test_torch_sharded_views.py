"""No reshape in the port's products flattens a sharded dimension that does
not lead its group (`models.layers._Plan`, `_on_shards`;
`models.moe._merged`).

Torch 2.13's DTensor gives such a flatten a `_StridedShard`; torch 2.11
refuses it, and `parallel.sharding.GatherFallback` reruns it on gathered
operands, where GSPMD never gathers for the reference.
`parallel.sharding.StridedViews` counts these flattens on either version.

* The counter itself: a strided flatten counts once, a plain one not at
  all, on either side of a `GatherFallback`.
* Each operand layout that the dry-run's cells flattened so on the parent
  tree (qwen2.5-3b's and llava-next-34b's decode projections on a
  head_dim-sharded weight, deepseek-v3-671b's `wo` with the heads summed
  after head_dim, prefill's batch-and-sequence-sharded activations into the
  projections and the MLP, grouped prefill's scores, a train step's FSDP
  weight, a (B, H, S, .) product with batch and heads sharded), at small
  widths on a fake 2 x 2 mesh of meta DTensors, through `einsum32` /
  `matmul32` in both product modes under the dry-run's strategy pricing:
  the counter reads 0 (on the parent tree it read 1 or 2 in every case),
  nothing is gathered, and the output's shape, placements and collective
  bytes are the parent's (`PARENT`), except where a sequence-sharded
  activation meets a weight sharded on an output dimension over the same
  mesh dimension (`COLUMN_PARALLEL`): there the parent's dry-run pricing
  gathered the weight and left the product on the sequence's shards, and
  the lowering gathers the activation over its sequence, as GSPMD does
  for the reference (and as torch 2.11's retry did for the parent), so
  that the product comes out in the heads' or hidden units' layout.
* The MoE dispatch's two merges: no strided flatten, nothing gathered.
* `_plan` on plain shapes (and on a layout that shards nothing) is the
  parent's, permutation for permutation (`PLAIN_PLANS`).
* Three dry-run cells (qwen2.5-3b prefill_32k, llava-next-34b and
  deepseek-v3-671b decode_32k, single pod) in subprocesses: no strided
  flatten, nothing gathered, GEMM FLOPs equal to the parent's and no
  collective kind above the parent's (`PARENT_CELLS`, the parent tree's
  dry-run on torch 2.13, bf16 mode).

The sharded products' numerics against the plain run are held on real gloo
ranks by tests/test_torch_seq_parallel_ranks.py and
tests/test_torch_seq_sharded_ranks.py.
"""
import json
import os
import subprocess
import sys

import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.analysis.collectives import (CollectiveCounter,
                                              collective_bytes)
from repro_torch.launch.dryrun import mesh_dim_strategy_costs
from repro_torch.launch.mesh import destroy_fake_world, init_fake_world
from repro_torch.models import layers, moe
from repro_torch.parallel import sharding as shd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
R, S = Replicate(), Shard

# name: (equation, a's shape and placements, b's, the parent's output
# placements and collective bytes a rank, the same in both product modes
# but for the bytes, which exec-safe mode doubles: its operands are f32)
PARENT = {
    "decode wk/wv, head_dim sharded": (
        "bsd,dhk->bshk", (4, 1, 16), (S(0), R), (16, 2, 8), (R, S(2)),
        (S(0), S(3)), {}),
    "decode wq, head_dim sharded": (
        "bsd,dhk->bshk", (4, 1, 16), (S(0), R), (16, 6, 8), (R, S(2)),
        (S(0), S(3)), {}),
    "decode wo, heads summed after head_dim": (
        "bqhd,hdm->bqm", (4, 1, 4, 8), (S(0), S(2)), (4, 8, 16), (R, S(0)),
        (S(0), "Partial"), {}),
    "prefill x into wk/wv": (
        "bsd,dhk->bshk", (4, 64, 16), (S(0), S(1)), (16, 2, 8), (R, S(2)),
        (S(0), S(1)), {"all-gather": 512}),
    "prefill x into wq": (
        "bsd,dhk->bshk", (4, 64, 16), (S(0), S(1)), (16, 4, 8), (R, S(1)),
        (S(0), S(1)), {"all-gather": 1024}),
    "prefill grouped scores": (
        "bqhgd,bkhd->bhgqk", (4, 64, 2, 2, 8), (S(0), S(1)), (4, 64, 2, 8),
        (S(0), R), (S(0), S(3)), {}),
    "prefill wo": (
        "bshk,hkd->bsd", (4, 64, 4, 8), (S(0), S(1)), (4, 8, 16), (R, S(0)),
        (S(0), S(1)), {"all-gather": 1024}),
    "prefill mlp up": (
        "...k,kn->...n", (4, 64, 16), (S(0), S(1)), (16, 32), (R, S(1)),
        (S(0), S(1)), {"all-gather": 1024}),
    "train x into an FSDP wq": (
        "bsd,dhk->bshk", (4, 64, 16), (S(0), S(1)), (16, 4, 8), (S(0), S(1)),
        (S(0), S(1)), {"all-gather": 1536}),
    "train scores, batch and heads sharded": (
        "bqhd,bkhd->bhqk", (4, 64, 4, 8), (S(0), S(2)), (4, 64, 4, 8),
        (S(0), S(2)), (S(0), S(1)), {}),
}
# the exec-safe route's bytes where they are not twice the bf16 route's
PARENT_SAFE_BYTES = {"train x into an FSDP wq": {"all-gather": 2560}}
# Cases whose output and bytes differ from the parent's (module
# docstring): the output's placements and the collective bytes a rank in
# bf16 / exec-safe mode (the activation's gather is f32 there; the FSDP
# weight's bf16 gather of 512 B comes first).
COLUMN_PARALLEL = {
    "prefill x into wk/wv": ((S(0), S(3)), 4096, 8192),
    "prefill x into wq": ((S(0), S(2)), 4096, 8192),
    "prefill mlp up": ((S(0), S(2)), 4096, 8192),
    "train x into an FSDP wq": ((S(0), S(2)), 4608, 8704),
}

# (equation, shapes) -> the parent's (perm_a, perm_b, perm_out, shape_a3,
# shape_b3, mid_out) of `_plan` on plain shapes
PLAIN_PLANS = [
    ("bsd,dhk->bshk", (2, 3, 4), (4, 5, 6),
     None, None, None, (6, 4), (4, 30), (2, 3, 5, 6)),
    ("bshk,hkd->bsd", (2, 3, 5, 6), (5, 6, 4),
     None, None, None, (6, 30), (30, 4), (2, 3, 4)),
    ("bqhgd,bkhd->bhgqk", (2, 3, 4, 5, 6), (2, 7, 4, 6),
     (0, 2, 3, 1, 4), (0, 2, 3, 1), None, (8, 15, 6), (8, 6, 7),
     (2, 4, 5, 3, 7)),
    ("bhgqk,bkhd->bqhgd", (2, 4, 5, 3, 7), (2, 7, 4, 6),
     (0, 1, 3, 2, 4), (0, 2, 1, 3), (0, 2, 1, 3, 4), (8, 15, 7), (8, 7, 6),
     (2, 4, 3, 5, 6)),
    ("...k,kn->...n", (2, 3, 4), (4, 5),
     None, None, None, (6, 4), (4, 5), (2, 3, 5)),
    ("bsd,vd->bsv", (2, 3, 4), (9, 4),
     None, (1, 0), None, (6, 4), (4, 9), (2, 3, 9)),
    ("bqhd,hdm->bqm", (2, 1, 4, 6), (4, 6, 5),
     (0, 1, 3, 2), (1, 0, 2), None, (2, 24), (24, 5), (2, 1, 5)),
    ("...ecd,edf->...ecf", (3, 4, 5, 6), (4, 6, 7),
     (1, 0, 2, 3), None, (1, 0, 2, 3), (4, 15, 6), (4, 6, 7), (4, 3, 5, 7)),
    ("bqhn,rhn->bqhr", (2, 1, 4, 6), (5, 4, 6),
     (2, 0, 1, 3), (1, 2, 0), (1, 2, 0, 3), (4, 2, 6), (4, 6, 5),
     (4, 2, 1, 5)),
    ("bhqk,bkr->bqhr", (2, 4, 1, 7), (2, 7, 5),
     (0, 2, 1, 3), None, None, (2, 4, 7), (2, 7, 5), (2, 1, 4, 5)),
]

# The parent tree's dry-run cells (single pod, bf16 mode, torch 2.13 on the
# CPU; `python -m repro_torch.launch.dryrun --device-type cpu`): collective
# bytes a card by kind and GEMM FLOPs. Its counter read 27 (qwen2.5-3b),
# 9 (llava-next-34b) and 16 (deepseek-v3-671b) strided flattens.
PARENT_CELLS = {
    ("qwen2.5-3b", "prefill_32k"): (
        {"all-gather": 2017822654464, "all-reduce": 51942260736,
         "reduce-scatter": 7700742144}, 15951734610329600),
    ("llava-next-34b", "decode_32k"): (
        {"all-gather": 981746688, "all-reduce": 27745024,
         "reduce-scatter": 147456}, 15901445324800),
    ("deepseek-v3-671b", "decode_32k"): (
        {"all-gather": 5834873856, "all-reduce": 161078400,
         "reduce-scatter": 63488}, 85598681432064),
}
# the torch version the figures above were measured on
PARENT_TORCH = "2.13"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    init_fake_world(4)
    shd.register_product_strategies()
    try:
        yield DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                         mesh_dim_names=("data", "model"))
    finally:
        destroy_fake_world()


def _meta(mesh, shape, pls, dtype=torch.bfloat16):
    local = list(shape)
    for n, p in zip(mesh.mesh.shape, pls):
        if isinstance(p, Shard):
            local[p.dim] //= int(n)
    return DTensor.from_local(
        torch.empty(local, dtype=dtype, device="meta"), mesh, pls,
        run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def _counted(fn, *args):
    """fn(*args) under a gather fallback and the counter: (result, strided
    flattens, gathered ops, collective bytes a rank by kind)."""
    shd.GATHERED.clear()
    with shd.GatherFallback(), CollectiveCounter() as cc, \
            shd.StridedViews() as views:
        out = fn(*args)
    got = {k: int(v) for k, v in collective_bytes(cc.events).items()
           if v and k != "total"}
    return out, views.count, dict(shd.GATHERED), got


@pytest.mark.parametrize("fallback_first", [True, False])
def test_the_counter_counts_a_strided_flatten_once(mesh, fallback_first):
    """(8, 2, 8) with its last dimension sharded, viewed as (8, 16): a
    `_StridedShard` on torch 2.13, a refusal (and a gathered retry) on
    torch 2.11; with the sharded dimension leading its group, nothing."""
    x = _meta(mesh, (8, 2, 8), (R, S(2)))
    lead = _meta(mesh, (8, 8, 2), (R, S(1)))
    views = shd.StridedViews()
    modes = ([shd.GatherFallback(), views] if fallback_first
             else [views, shd.GatherFallback()])
    with modes[0], modes[1]:
        x.reshape(8, 16)
        lead.reshape(8, 16)
    assert views.count == 1
    assert list(views.sites.values()) == [1]
    assert shd.flattens_trailing_shard(x, (8, 16))
    assert not shd.flattens_trailing_shard(lead, (8, 16))


@pytest.mark.parametrize("safe", [False, True], ids=["bf16", "exec-safe"])
@pytest.mark.parametrize("name", list(PARENT))
def test_table_layouts_flatten_plainly(mesh, name, safe):
    eq, sa, pa, sb, pb, want_pl, want_bytes = PARENT[name]
    a, b = _meta(mesh, sa, pa), _meta(mesh, sb, pb)
    if "FSDP" in name:
        b = torch.nn.Parameter(b, requires_grad=False)
    layers.set_exec_safe(safe)
    try:
        with mesh_dim_strategy_costs():
            out, strided, gathered, got = _counted(
                (lambda x, y: layers.matmul32(x, y))
                if eq.startswith("...") else
                (lambda x, y: layers.einsum32(eq, x, y)), a, b)
    finally:
        layers.set_exec_safe(False)
    assert strided == 0 and gathered == {}
    want_shape = torch.einsum(eq, torch.empty(sa, device="meta"),
                              torch.empty(sb, device="meta")).shape
    assert out.shape == want_shape and out.dtype == torch.float32
    if safe:
        want_bytes = PARENT_SAFE_BYTES.get(
            name, {k: 2 * v for k, v in want_bytes.items()})
    if name in COLUMN_PARALLEL:
        want_pl, *gathers = COLUMN_PARALLEL[name]
        want_bytes = {"all-gather": gathers[safe]}
    assert [p if isinstance(p, Shard) else "Partial" if p.is_partial()
            else p for p in out.placements] == list(want_pl)
    assert got == want_bytes


@pytest.mark.parametrize("case", [
    # x.reshape(t, d): (B, S, D), batch over "data", sequence over "model"
    ((4, 8, 16), (S(0), S(1)), 0, (S(0), R)),
    # the experts' (E, C, D) output: experts over "model", slots over "data"
    ((4, 8, 16), (S(1), S(0)), 0, (R, S(0))),
    # the cumsum dispatch's (G, E, C, D): groups over "data", experts over
    # "model" (merged as they are)
    ((2, 4, 8, 16), (S(0), S(1)), 1, (S(0), S(1))),
])
def test_moe_merges_flatten_plainly(mesh, case):
    shape, pls, dim, want = case
    x = _meta(mesh, shape, pls)
    out, strided, gathered, _ = _counted(moe._merged, x, dim)
    merged = shape[:dim] + (shape[dim] * shape[dim + 1],) + shape[dim + 2:]
    assert strided == 0 and gathered == {}
    assert tuple(out.shape) == merged and tuple(out.placements) == want


@pytest.mark.parametrize("plan", PLAIN_PLANS, ids=[p[0] for p in PLAIN_PLANS])
def test_plain_shapes_take_the_parents_plan(plan):
    eq, sa, sb, *want = plan
    for layout in ((), ((None, None),), ((None, None), (None, None))):
        p = layers._plan(eq, sa, sb, layout)
        assert [p.perm_a, p.perm_b, p.perm_out, p.shape_a3, p.shape_b3,
                p.mid_out] == want
        assert not p.crowded


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """The three cells' dry-run records, each traced in a subprocess."""
    d = tmp_path_factory.mktemp("cells")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    procs = {}
    for arch, shape in PARENT_CELLS:
        out = d / f"{arch}-{shape}.json"
        procs[arch, shape] = out, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--device-type",
             "cpu", "--out", str(out)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    got = {}
    for key, (out, p) in procs.items():
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stdout + stderr[-3000:]
        (got[key],) = json.load(open(out))
    return got


@pytest.mark.parametrize("cell", list(PARENT_CELLS),
                         ids=["-".join(c) for c in PARENT_CELLS])
def test_dryrun_cells_flatten_plainly_and_move_no_more(cells, cell):
    c = cells[cell]
    want_bytes, want_gemm = PARENT_CELLS[cell]
    assert c["status"] == "ok"
    assert c["strided_views"] == {} and c["replicated_ops"] == {}
    assert c["gemm_flops"] == want_gemm
    if torch.__version__.startswith(PARENT_TORCH):
        for kind, n in c["collectives"].items():
            if kind != "total":
                assert n <= want_bytes.get(kind, 0), (kind, n, want_bytes)
