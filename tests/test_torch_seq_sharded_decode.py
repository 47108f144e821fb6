"""Decode against a sequence-sharded KV cache emits the collectives GSPMD
gives the reference, not a gather of the cache.

The reference's `gqa_attend` (grouped and `repeat_kv`), a
`dynamic_update_slice` of one cache row and its absorbed-form
`decode_mla` are lowered on a (1, 4) ("data", "model") mesh of four XLA
CPU devices, in one subprocess (`XLA_FLAGS=--xla_force_host_platform_
device_count=4`, as tests/test_torch_shard_kernels.py runs its k = 4
launches), and their collectives read by `repro.analysis.hlo.
collective_bytes`. The port's `gqa_attend`, `write_row` and `decode_mla`
run on meta DTensors of the same shapes and layouts on a fake 4-rank group,
counted by `analysis.collectives.CollectiveCounter`. K/V (and the MLA
latent and rope caches) are sharded along their sequence over "model";
the query is one token. The port's decode emits no all-gather or
all-to-all where the reference emits none, at most twice its bytes in
all, and bytes that do not grow when the cache doubles (GSPMD's form:
all-reduces of B x H values and of the (B, 1, H, D) f32 output); a
prefill, whose query sequence is sharded too, keeps its K/V all-gather
as the reference does. Both product modes (the bf16 route's lowered
products on meta, the exec-safe einsum) take the split.
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
from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import destroy_fake_world, init_fake_world
from repro_torch.models import layers, lm, mla
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.specs import distribute

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, HQ, HKV, D = 8, 4096, 16, 2, 128      # decode: one query token
PB, PS = 2, 2048                            # prefill
POS = 17
GATHERS = ("all-gather", "all-to-all")

REFERENCE = r"""
import json, sys
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.analysis.hlo import collective_bytes
from repro.configs import get_config, reduced
from repro.models import layers, mla
B, S, HQ, HKV, D, PB, PS, POS = (int(a) for a in sys.argv[2:10])
mesh = Mesh(np.array(jax.devices()[:4]).reshape(1, 4), ("data", "model"))


def ns(*spec):
    return NamedSharding(mesh, P(*spec))


def sds(shape, dtype=jnp.bfloat16):
    return jax.ShapeDtypeStruct(shape, dtype)


def lower(fn, args, shardings):
    text = jax.jit(fn, in_shardings=shardings).lower(*args).compile().as_text()
    return collective_bytes(text)


KV = ns("data", "model", None, None)
out = {}
for s in (S, 2 * S):
    for mode in ("grouped", "repeat_kv"):
        layers.set_gqa_mode(mode)
        out[f"attend {mode} {s}"] = lower(
            layers.gqa_attend,
            (sds((B, 1, HQ, D)), sds((B, s, HKV, D)), sds((B, s, HKV, D)),
             sds((B, 1, s), jnp.bool_)),
            (ns("data", None, None, None), KV, KV, ns("data", None, "model")))
    layers.set_gqa_mode("grouped")
    out[f"write {s}"] = lower(
        lambda r, n: jax.lax.dynamic_update_slice(r, n, (0, POS, 0, 0)),
        (sds((B, s, HKV, D)), sds((B, 1, HKV, D))),
        (KV, ns("data", None, None, None)))
layers.set_gqa_mode("repeat_kv")
out["prefill"] = lower(
    layers.gqa_attend,
    (sds((PB, PS, HQ, D)), sds((PB, PS, HKV, D)), sds((PB, PS, HKV, D)),
     sds((PB, PS, PS), jnp.bool_)),
    (KV, KV, KV, ns("data", "model", None)))
layers.set_gqa_mode("grouped")
cfg = reduced(get_config("deepseek-v3-671b"))
params = jax.eval_shape(lambda: mla.init_mla(jax.random.PRNGKey(0), cfg))
rep = jax.tree_util.tree_map(lambda a: ns(), params)
lat = ns("data", "model", None)
for s in (S, 2 * S):
    def step(p, x, cc, cr, s=s):
        b = x.shape[0]
        q_pos = jnp.full((b, 1), POS, jnp.int32)
        kv_pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
        return mla.decode_mla(p, cfg, x, q_pos, cc, cr, kv_pos)
    out[f"mla {s}"] = lower(
        step, (params, sds((B, 1, cfg.d_model)),
               sds((B, s, cfg.mla.kv_lora_rank)),
               sds((B, s, cfg.mla.rope_head_dim))),
        (rep, ns("data", None, None), lat, lat))
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    pytest.importorskip("jax")  # the port half runs on the card's machine
    path = tmp_path_factory.mktemp("gspmd") / "bytes.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-c", REFERENCE, str(path)]
                   + [str(a) for a in (B, S, HQ, HKV, D, PB, PS, POS)],
                   check=True, env=env, cwd=ROOT, timeout=300)
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def mesh():
    init_fake_world(4)
    shd.register_product_strategies()
    yield DeviceMesh("cpu", torch.arange(4).reshape(1, 4),
                     mesh_dim_names=("data", "model"))
    destroy_fake_world()


@pytest.fixture(autouse=True)
def modes():
    yield
    layers.set_gqa_mode("grouped")
    layers.set_exec_safe(False)


def _meta(mesh, shape, pls, dtype=torch.bfloat16):
    local = list(shape)
    for size, p in zip(mesh.mesh.shape, pls):
        if isinstance(p, Shard):
            local[p.dim] //= int(size)
    return DTensor.from_local(
        torch.empty(local, dtype=dtype, device="meta"), mesh, list(pls),
        run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def _counted(fn, *args):
    """(fn's result, its collective bytes by kind), with nothing gathered
    by a `GatherFallback`."""
    shd.GATHERED.clear()
    with shd.GatherFallback(), CollectiveCounter() as cc:
        out = fn(*args)
    assert shd.GATHERED == {}
    return out, collective_bytes(cc.events)


def _attend(mesh, s, mode, safe):
    layers.set_gqa_mode(mode)
    layers.set_exec_safe(safe)
    kv = [Shard(0), Shard(1)]
    return _counted(layers.gqa_attend,
                    _meta(mesh, (B, 1, HQ, D), [Shard(0), Replicate()]),
                    _meta(mesh, (B, s, HKV, D), kv),
                    _meta(mesh, (B, s, HKV, D), kv),
                    _meta(mesh, (B, 1, s), [Shard(0), Shard(2)], torch.bool))


def _write(mesh, s):
    return _counted(lm.write_row,
                    _meta(mesh, (B, s, HKV, D), [Shard(0), Shard(1)]), POS,
                    _meta(mesh, (B, 1, HKV, D), [Shard(0), Replicate()]))


def _decode_mla(mesh, s):
    cfg = reduced(get_config("deepseek-v3-671b"))
    p = mla.MLA(cfg, torch.device("meta"))
    for name, t in list(p.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        setattr(p.get_submodule(owner) if owner else p, leaf,
                torch.nn.Parameter(distribute(t, (), mesh),
                                   requires_grad=False))
    lat = [Shard(0), Shard(1)]
    x = _meta(mesh, (B, 1, cfg.d_model), [Shard(0), Replicate()])
    cc = _meta(mesh, (B, s, cfg.mla.kv_lora_rank), lat)
    cr = _meta(mesh, (B, s, cfg.mla.rope_head_dim), lat)
    q_pos, kv_pos = lm._decode_positions(B, s, POS, "meta")
    with shd.dtensor_run(p):
        return _counted(mla.decode_mla, p, cfg, x, q_pos, cc, cr, kv_pos)


def _no_new_gathers(port, ref):
    for kind in GATHERS:
        if not ref.get(kind):
            assert not port.get(kind), (kind, port, ref)
    assert port["total"] <= 2 * ref["total"], (port, ref)


@pytest.mark.parametrize("safe", [False, True], ids=["bf16", "exec-safe"])
@pytest.mark.parametrize("mode", ["grouped", "repeat_kv"])
def test_decode_attention_emits_gspmd_collectives(reference, mesh, mode,
                                                  safe):
    out, port = _attend(mesh, S, mode, safe)
    _no_new_gathers(port, reference[f"attend {mode} {S}"])
    assert tuple(out.shape) == (B, 1, HQ, D)
    assert tuple(out.placements) == (Shard(0), Replicate())
    assert out.dtype == torch.bfloat16


def test_cache_write_emits_no_collective(reference, mesh):
    out, port = _write(mesh, S)
    _no_new_gathers(port, reference[f"write {S}"])
    assert port["total"] == 0 == reference[f"write {S}"]["total"]
    assert tuple(out.placements) == (Shard(0), Shard(1))
    assert tuple(out.shape) == (B, S, HKV, D)


def test_decode_mla_emits_gspmd_collectives(reference, mesh):
    _, port = _decode_mla(mesh, S)
    _no_new_gathers(port, reference[f"mla {S}"])


CASES = ["attend grouped", "attend repeat_kv", "write", "mla"]


@pytest.mark.parametrize("case", CASES)
def test_decode_bytes_do_not_grow_with_the_cache(mesh, case):
    run = {"attend grouped": lambda s: _attend(mesh, s, "grouped", False),
           "attend repeat_kv": lambda s: _attend(mesh, s, "repeat_kv",
                                                 False),
           "write": lambda s: _write(mesh, s),
           "mla": lambda s: _decode_mla(mesh, s)}[case]
    short, long = run(S)[1], run(2 * S)[1]
    for kind in ("all-gather", "all-reduce", "total"):
        assert short.get(kind, 0) == long.get(kind, 0), (kind, short, long)
    assert not any(short.get(k) for k in GATHERS), short


@pytest.mark.parametrize("case", CASES)
def test_gspmd_bytes_do_not_grow_with_the_cache(reference, case):
    """The invariant the port is held to is GSPMD's own."""
    assert reference[f"{case} {S}"] == reference[f"{case} {2 * S}"]


@pytest.mark.parametrize("mode", ["repeat_kv", "grouped"])
def test_prefill_keeps_the_kv_gather(reference, mesh, mode):
    """The port in either GQA mode against the reference's `repeat_kv`
    lowering: the K/V gather is the same in either mode. In grouped mode
    the lowering puts the sharded query sequence ahead of G in its (G, S)
    group (`layers._Plan`), so that no flatten gives a `_StridedShard`
    (torch 2.13) or is refused (torch 2.11, whose refusal the dry-run's
    `GatherFallback` would rerun gathered)."""
    layers.set_gqa_mode(mode)
    seq = [Shard(0), Shard(1)]
    views = shd.StridedViews()

    def attend(*args):
        with views:     # above the counter, which hides DTensor ops below
            return layers.gqa_attend(*args)
    _, port = _counted(attend,
                       _meta(mesh, (PB, PS, HQ, D), seq),
                       _meta(mesh, (PB, PS, HKV, D), seq),
                       _meta(mesh, (PB, PS, HKV, D), seq),
                       _meta(mesh, (PB, PS, PS), seq, torch.bool))
    assert views.count == 0, views.sites
    ref = reference["prefill"]
    assert ref["all-gather"] > 0
    # K and V gathered whole, bf16 (GSPMD's gather moves them in f32)
    assert port["all-gather"] == 2 * PB * PS * HKV * D * 2, (port, ref)
    assert port["total"] <= 2 * ref["total"]


def test_key_split_only_where_the_keys_span_devices(mesh):
    kv = [Shard(0), Shard(1)]
    q = _meta(mesh, (B, 1, HQ, D), [Shard(0), Replicate()])
    k = _meta(mesh, (B, S, HKV, D), kv)
    assert layers.key_split(q, k, 1, 2) == (1,)
    # a plain tensor, a gathered query sequence, a query as large as K/V
    assert layers.key_split(q, torch.empty(B, S, HKV, D), 1, 2) == ()
    assert layers.key_split(_meta(mesh, (B, S, HQ, D), kv), k, 1, 2) == ()
    assert layers.key_split(q, k, 2, 2) == ()
    one = DeviceMesh("cpu", torch.zeros(1, 1, dtype=torch.int64),
                     mesh_dim_names=("data", "model"))
    k1 = _meta(one, (B, S, HKV, D), kv)
    assert layers.key_split(q, k1, 1, 2) == ()


def test_sum_shards_reduces_in_f32_before_the_cast(mesh):
    """A product's Partial f32 sum is reduced in f32: all-reduced where the
    residual stream is not sequence-sharded (decode), reduce-scattered
    onto the residual's sequence shards where it is (training)."""
    from torch.distributed.tensor import Partial
    y = _meta(mesh, (B, 1, 64), [Shard(0), Partial()], torch.float32)
    with CollectiveCounter() as cc:
        out = layers.sum_shards(y, shd.DECODE_RULES)
    assert tuple(out.placements) == (Shard(0), Replicate())
    assert collective_bytes(cc.events)["all-reduce"] == B * 64 * 4
    y = _meta(mesh, (B, S, 64), [Shard(0), Partial()], torch.float32)
    with CollectiveCounter() as cc:
        out = layers.sum_shards(y, shd.for_mesh(shd.TRAIN_RULES, mesh))
    assert tuple(out.placements) == (Shard(0), Shard(1))
    assert out.dtype == torch.float32
    assert collective_bytes(cc.events) == {
        "reduce-scatter": B * S // 4 * 64 * 4, "total": B * S // 4 * 64 * 4}
    plain = torch.ones(2, 3)
    assert layers.sum_shards(plain) is plain
