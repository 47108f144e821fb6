"""The bf16 route's products on DTensors: `aten.mm.dtype` /
`aten.bmm.dtype` (bf16 operands, an f32 result), whose sharding
strategies `parallel.sharding.register_product_strategies` registers.

(a) On fake-process-group meshes (1-D of 4, and 2 x 2), for every pair of
    operand placements built from Replicate, Partial, and a Shard and a
    strided shard of each dimension, on meta bf16 DTensors (a pair DTensor
    refuses, a strided shard of a contracted dimension against a
    replicated operand, raises alike): `mm.dtype` / `bmm.dtype` give the
    output placements, local shapes and collectives (kinds, counts and
    bytes, so the operands move at bf16 size) that `mm.default` /
    `bmm.default` give on the same inputs, with an f32 result; under
    torch's strategy pricing and under the dry-run's
    (`launch.dryrun.mesh_dim_strategy_costs`); on the 2 x 2 mesh, where
    each pair takes tens of milliseconds, the pairs `CASES` lists.
(b) A reduced qwen2.5-3b cell (train and decode) traced by
    `launch.dryrun.measure_cell` in bf16 mode against exec-safe: every
    product on the bf16 route, none gathered, GEMM FLOPs equal, gathered
    ops and collective bytes no higher.
(c) The grouped MoE equations on an expert-sharded buffer (reduced
    olmoe-1b-7b) and the absorbed MLA decode product `bhqk,bkr->bqhr` on
    a sequence-sharded cache, on DTensors: the bf16 route, the exec-safe
    route's output placements and shapes, no op gathered.
(d) Under `torch.utils.checkpoint` the lowered product's recompute and
    backward run no product the exec-safe autograd's does not (its
    operands are saved before the product runs; an operand that needs no
    gradient gets none), so a remat train step's GEMM FLOPs are the same
    in both modes.
(e) `import repro_torch` imports no `torch.distributed.tensor`: the
    strategies are registered where the port first meets a DTensor.
"""
import contextlib
import itertools
import os
import subprocess
import sys

import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.placement_types import _StridedShard
from torch.utils.checkpoint import checkpoint

from repro_torch.analysis.collectives import (CollectiveCounter,
                                              collective_bytes,
                                              collective_counts)
from repro_torch.analysis.op_cost import FlopCounter
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import destroy_fake_world, init_fake_world
from repro_torch.models import layers
from repro_torch.parallel import sharding as shd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRODUCT_OPS = ("aten.mm.dtype", "aten.bmm.dtype")


def _shapes(op, pricing):
    """The operands' shapes; each pricing its own, as DTensor caches a
    propagation by the operands' specs, shapes included."""
    n = 12 if pricing == "torch" else 20
    return ((8, 16), (16, n)) if op == "mm" else ((4, 8, 16), (4, 16, n))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _mode():
    prev = layers._EXEC_SAFE
    yield
    layers.set_exec_safe(prev)


@pytest.fixture(scope="module")
def meshes():
    init_fake_world()
    shd.register_product_strategies()
    yield {"1d": DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("m",)),
           "2x2": DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                             mesh_dim_names=("data", "model"))}
    destroy_fake_world()


def _meta_dtensor(mesh, shape, pls, dtype=torch.bfloat16):
    local = list(shape)
    for size, p in zip(mesh.mesh.shape, pls):
        if isinstance(p, Shard):
            local[p.dim] //= int(size)
    return DTensor.from_local(
        torch.empty(local, dtype=dtype, device="meta"), mesh, list(pls),
        run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def _propagate(fn, a, b):
    """What DTensor makes of `fn(a, b)`, or the type of what it raises."""
    try:
        with CollectiveCounter() as cc:
            y = fn(a, b)
    except RuntimeError as e:
        return (type(e).__name__,) * 5
    return (tuple(y.placements), tuple(y.to_local().shape), y.dtype,
            collective_counts(cc.events), collective_bytes(cc.events))


# (mesh, op, pricing, whether an operand may be Partial or a strided
# shard): every pair on the 1-D mesh; on the 2 x 2 mesh, where a pair
# costs tens of milliseconds, the pairs of Replicate and Shard placements,
# under torch's pricing for `mm` alone.
CASES = [("1d", op, pricing, True) for op in ("mm", "bmm")
         for pricing in ("torch", "per mesh dimension")] + [
    ("2x2", "mm", "per mesh dimension", False),
    ("2x2", "bmm", "per mesh dimension", False),
    ("2x2", "mm", "torch", False)]


@pytest.mark.parametrize("mesh_name,op,pricing,partial", CASES)
def test_product_shards_as_the_default_op(meshes, mesh_name, op, pricing,
                                          partial):
    mesh = meshes[mesh_name]
    sa, sb = _shapes(op, pricing)
    fn = torch.mm if op == "mm" else torch.bmm
    one = [Replicate()] + [Shard(d) for d in range(len(sa))] \
        + ([Partial()] + [_StridedShard(d, split_factor=2)
                          for d in range(len(sa))]) * partial
    pls = list(itertools.product(one, repeat=mesh.ndim))
    moved = ran = 0
    with D.mesh_dim_strategy_costs() if pricing != "torch" \
            else contextlib.nullcontext():
        for pa, pb in itertools.product(pls, pls):
            a, b = _meta_dtensor(mesh, sa, pa), _meta_dtensor(mesh, sb, pb)
            want = _propagate(fn, a, b)
            got = _propagate(lambda x, y: fn(x, y, out_dtype=torch.float32),
                             a, b)
            assert got[:2] + got[3:] == want[:2] + want[3:], (pa, pb)
            if want[2] != "RuntimeError":
                assert want[2] == torch.bfloat16 and got[2] == torch.float32
                moved += got[4].get("total", 0) > 0
                ran += 1
    assert moved > 0 and ran >= 0.9 * len(pls) ** 2


def _cell(mesh, kind, safe):
    layers.set_exec_safe(safe)
    layers.PRODUCTS.update(bf16=0, f32=0, f32_lowered=0)
    cell = D.measure_cell(reduced(get_config("qwen2.5-3b")),
                          ShapeConfig("tiny", 32, 4, kind), mesh)
    return cell, dict(layers.PRODUCTS)


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_reduced_cell_in_bf16_mode_against_exec_safe(meshes, kind):
    bf16, routes = _cell(meshes["2x2"], kind, False)
    safe, safe_routes = _cell(meshes["2x2"], kind, True)
    assert routes["f32"] == routes["f32_lowered"] == 0
    assert routes["bf16"] == safe_routes["f32"] + safe_routes["f32_lowered"] \
        > 0
    assert not set(bf16["replicated_ops"]) & set(PRODUCT_OPS)
    assert bf16["gemm_flops"] == safe["gemm_flops"]
    assert sum(bf16["replicated_ops"].values()) \
        <= sum(safe["replicated_ops"].values())
    assert 0 < bf16["collectives"]["total"] <= safe["collectives"]["total"]
    for key in ("argument_size_in_bytes", "alias_size_in_bytes",
                "output_size_in_bytes"):
        assert bf16["memory"][key] == safe["memory"][key], key


def _product_on_dtensors(eq, a, b, safe):
    layers.set_exec_safe(safe)
    layers.PRODUCTS.update(bf16=0, f32=0, f32_lowered=0)
    with shd.GatherFallback() as fb, CollectiveCounter() as cc:
        out = layers.einsum32(eq, a, b)
    return (out, dict(layers.PRODUCTS), fb.counts,
            collective_counts(cc.events))


def _holds_both_routes(eq, a, b):
    out, routes, gathered, colls = _product_on_dtensors(eq, a, b, False)
    want, _, want_gathered, want_colls = _product_on_dtensors(eq, a, b, True)
    assert routes == {"bf16": 1, "f32": 0, "f32_lowered": 0}
    assert gathered == {} == want_gathered
    assert out.dtype == torch.float32 and out.shape == want.shape
    assert out.placements == want.placements
    assert colls == want_colls
    return out


@pytest.mark.parametrize("eq", ["...ecd,edf->...ecf", "...ecf,efd->...ecd"])
def test_moe_grouped_equations_on_an_expert_sharded_buffer(meshes, eq):
    """olmoe-1b-7b's expert einsums (`moe._experts`) on a (G, E, C, D)
    buffer and (E, D, F) weights sharded over the experts, as
    `Rules.expert_tokens` and `w_expert_in` lay them out."""
    cfg = reduced(get_config("olmoe-1b-7b"))
    mesh = meshes["2x2"]
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_expert
    x_dim, w_dims = (d, (e, d, f)) if eq.startswith("...ecd") \
        else (f, (e, f, d))
    buf = _meta_dtensor(mesh, (2, e, 8, x_dim), (Shard(0), Shard(1)))
    w = _meta_dtensor(mesh, w_dims, (Replicate(), Shard(0)))
    out = _holds_both_routes(eq, buf, w)
    assert out.placements == (Shard(0), Shard(1))


def test_mla_absorbed_decode_product_on_dtensors(meshes):
    """deepseek's absorbed decode `bhqk,bkr->bqhr` (`mla._decode_absorbed`)
    with the probabilities over a sequence-sharded cache: the contraction
    over the sharded cache sequence leaves a Partial sum."""
    mesh = meshes["2x2"]
    probs = _meta_dtensor(mesh, (4, 8, 1, 32), (Shard(0), Shard(3)),
                          dtype=torch.bfloat16)
    cache_c = _meta_dtensor(mesh, (4, 32, 16), (Shard(0), Shard(1)))
    out = _holds_both_routes("bhqk,bkr->bqhr", probs, cache_c)
    assert out.placements == (Shard(0), Partial())


def _remat_products(safe):
    layers.set_exec_safe(safe)
    x = torch.empty(2, 6, 16, dtype=torch.bfloat16, device="meta")
    w1, w2 = (torch.empty(16, 32, dtype=torch.bfloat16, device="meta",
                          requires_grad=True),
              torch.empty(4, 8, 16, dtype=torch.bfloat16, device="meta",
                          requires_grad=True))

    def block(x, w1, w2):
        h = layers.matmul32(x, w1).to(x.dtype).view(2, 6, 4, 8)
        return layers.einsum32("bshk,hkd->bsd", h, w2)

    with FlopCounter() as fc:
        out = checkpoint(block, x, w1, w2, use_reentrant=False)
        out.sum().backward()
    return fc.gemm


def test_checkpoint_recompute_runs_no_extra_product():
    assert _remat_products(False) == _remat_products(True)


def test_importing_the_port_imports_no_dtensor():
    code = ("import sys, repro_torch, repro_torch.models, "
            "repro_torch.parallel.sharding, repro_torch.train.trainer; "
            "print('torch.distributed.tensor' in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=dict(
                           os.environ, PYTHONPATH=os.path.join(REPO, "src")))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "False"
