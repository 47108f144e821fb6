"""Under a sequence-parallel residual (PREFILL_RULES, TRAIN_RULES) a
row-parallel product's Partial f32 sum is reduced in f32, as GSPMD reduces
the reference's.

The reference's `apply_attention` and `apply_mlp` are lowered on four XLA
CPU devices, in one subprocess (`XLA_FLAGS=--xla_force_host_platform_
device_count=4`, as tests/test_torch_seq_sharded_decode.py lowers its
decode): under `for_mesh(PREFILL_RULES)` on a (1, 4) ("data", "model")
mesh the block's forward, under `for_mesh(TRAIN_RULES)` on (2, 2) its
forward and `jax.grad`, each in both product modes, and their collectives
read by `repro.analysis.hlo` (by kind and element type). The port's same
blocks run on meta DTensors of the same shapes and layouts on a fake
4-rank group, counted by `analysis.collectives.CollectiveCounter` (by kind
and dtype) and `parallel.sharding.PartialCasts`. Every reduction is f32 on
both sides, no f32 Partial sum is cast to bf16, the port's reduction bytes
are no more than GSPMD's (an all-reduce on XLA:CPU, which forms no
reduce-scatter; the port's is a reduce-scatter onto the residual), and the
port gathers nothing where the reference gathers nothing. XLA:CPU upcasts
bf16 dot operands, so the reference's other collectives appear in f32:
only reductions are compared by element type.

Reduced qwen2.5-3b's attention block (one KV head: "model" moves off K/V's
head axis onto head_dim) runs the same way in both GQA modes, its
reference lowered once per mode in the same subprocess: K/V are gathered
over head_dim ahead of the score product, as GSPMD gathers them, so the
f32 scores are never reduced. Its reductions are f32 and no more than
GSPMD's, the prefill forward's no more than the residual's
reduce-scatter, and each case moves fewer collective bytes than before
the gather (PARENT_QWEN).
"""
import json
import os
import subprocess
import sys

import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Shard

from repro_torch.analysis.collectives import (CollectiveCounter,
                                              collective_bytes_by_dtype)
from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import destroy_fake_world, init_fake_world
from repro_torch.models import layers
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.specs import distribute

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 4, 256
ARCH = "gemma3-4b"    # reduced: D 128, F 256, 8 heads of 32, 4 KV heads
QWEN = "qwen2.5-3b"   # reduced: D 128, 8 heads of 32, 1 KV head
REDUCTIONS = ("all-reduce", "reduce-scatter")
GATHERS = ("all-gather", "all-to-all")
LAYOUTS = {"prefill": (1, 4), "train": (2, 2)}
CASES = [(block, kind, mode) for block in ("attention", "mlp")
         for kind in LAYOUTS for mode in ("bf16", "exec-safe")]
GQA_MODES = ("grouped", "repeat_kv")
QWEN_CASES = [(kind, mode, gqa) for kind in LAYOUTS
              for mode in ("bf16", "exec-safe") for gqa in GQA_MODES]
# GSPMD's reductions of the reference's block in a train step on (2, 2),
# in both GQA and product modes (chip_smoke.py holds the port's to it on
# the card's torch: GSPMD_QWEN_TRAIN_REDUCTION_BYTES).
GSPMD_QWEN_TRAIN_REDUCTIONS = 1065600
# The port's collective bytes by "kind dtype" for reduced qwen2.5-3b's
# attention block on the tree before K/V were gathered over head_dim
# (commit 4d74280, this file's `_run`): the f32 scores reduce-scattered
# (2,097,152 B in prefill), against GSPMD's 524,288 B all-reduce.
PARENT_QWEN = {
    ("prefill", "bf16", "grouped"): {
        "all-gather bf16": 2097152, "reduce-scatter f32": 2097152},
    ("prefill", "bf16", "repeat_kv"): {
        "all-gather bf16": 2031616, "reduce-scatter f32": 2097152},
    ("prefill", "exec-safe", "grouped"): {
        "all-gather f32": 2752512, "all-gather bf16": 720896,
        "reduce-scatter f32": 2097152},
    ("prefill", "exec-safe", "repeat_kv"): {
        "all-gather f32": 3670016, "all-gather bf16": 196608,
        "reduce-scatter f32": 2097152},
    ("train", "bf16", "grouped"): {
        "all-gather bf16": 3952640, "reduce-scatter f32": 4608000,
        "all-gather f32": 2441216},
    ("train", "bf16", "repeat_kv"): {
        "all-gather bf16": 3592192, "reduce-scatter f32": 4542464,
        "all-gather f32": 4079616},
    ("train", "exec-safe", "grouped"): {
        "all-gather bf16": 3133440, "all-gather f32": 3948544,
        "reduce-scatter f32": 4608000},
    ("train", "exec-safe", "repeat_kv"): {
        "all-gather bf16": 2478080, "all-gather f32": 6045696,
        "reduce-scatter f32": 4542464},
}

REFERENCE = r"""
import json, sys
from collections import defaultdict
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.analysis.hlo import _DTYPE_BYTES, _OP_RE, _SHAPE_RE
from repro.configs import get_config, reduced
from repro.models import layers
from repro.parallel import sharding as shd
B, S = int(sys.argv[2]), int(sys.argv[3])
# [arch, GQA mode, blocks, key prefix]
JOBS = json.loads(sys.argv[4])
RULES = {"prefill": ((1, 4), shd.PREFILL_RULES),
         "train": ((2, 2), shd.TRAIN_RULES)}


def typed(text):
    out = defaultdict(float)
    for m in _OP_RE.finditer(text):
        if "-done(" in m.group(0):
            continue
        for dt, dims in _SHAPE_RE.findall(m.group("shapes")):
            n = 1
            for d in dims.split(","):
                if d:
                    n *= int(d)
            out[f"{m.group('kind')} {dt}"] += n * _DTYPE_BYTES.get(dt, 0)
    return dict(out)


def lower(arch, gqa, names, prefix, out):
    cfg = reduced(get_config(arch))
    layers.set_gqa_mode(gqa)
    for kind, (shape, rules) in RULES.items():
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(shape),
                    ("data", "model"))
        rules = shd.for_mesh(rules, mesh)
        sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        shd.set_active_axis_sizes(sizes)
        key = jax.random.PRNGKey(0)
        blocks = {
            "attention": (layers.init_attention(key, cfg),
                          layers.attention_specs(rules),
                          lambda p, x: layers.apply_attention(
                              p, cfg, x, jnp.broadcast_to(
                                  jnp.arange(S, dtype=jnp.int32), (B, S)),
                              rules=rules)),
            "mlp": (layers.init_mlp(key, cfg.d_model, cfg.d_ff),
                    layers.mlp_specs(rules),
                    lambda p, x: layers.apply_mlp(p, x, rules=rules))}
        for block in names:
            params, specs, fn = blocks[block]
            pspec = {n: NamedSharding(mesh, shd.sanitize_spec(
                v.shape, specs[n], sizes)) for n, v in params.items()}
            xs = NamedSharding(mesh, P(*rules.resid))
            x = jax.ShapeDtypeStruct((B, S, cfg.d_model), jnp.bfloat16)
            p = jax.tree_util.tree_map(
                lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), params)
            if kind == "train":
                def step(p, x, fn=fn):
                    return jax.grad(lambda p, x: fn(p, x).astype(
                        jnp.float32).sum(), argnums=(0, 1))(p, x)
            else:
                step = fn
            for mode, safe in (("bf16", False), ("exec-safe", True)):
                layers.set_exec_safe(safe)
                with mesh:
                    text = jax.jit(step, in_shardings=(pspec, xs)).lower(
                        p, x).compile().as_text()
                out[f"{prefix}{block} {kind} {mode}"] = typed(text)
        shd.set_active_axis_sizes(None)


out = {}
for job in JOBS:
    lower(*job, out)
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def lowering(tmp_path_factory):
    """The reference's lowering, started in a subprocess while the port's
    half runs (None without JAX: the port half runs on the card's
    machine)."""
    try:
        import jax  # noqa: F401
    except ImportError:
        yield None
        return
    path = tmp_path_factory.mktemp("gspmd") / "bytes.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    jobs = [[ARCH, "grouped", ["attention", "mlp"], ""]] + [
        [QWEN, gqa, ["attention"], _qwen_key(gqa, "")] for gqa in GQA_MODES]
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE, str(path),
                             str(B), str(S), json.dumps(jobs)], env=env,
                            cwd=ROOT, stderr=subprocess.PIPE, text=True)
    yield proc, path
    proc.kill()


@pytest.fixture(scope="module")
def reference(lowering, port):
    if lowering is None:
        pytest.skip("the reference's lowering needs JAX")
    proc, path = lowering
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def port(lowering):
    """{case: (collective bytes by "kind dtype", f32 Partial casts, the
    output's placements and dtype)} of the port's blocks on meta DTensors
    (a sequence-sharded input of a column-parallel product is gathered
    over its sequence, `layers._resolved`: the gather GSPMD makes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    init_fake_world(4)
    shd.register_product_strategies()
    try:
        runs = {case: _run(*case) for case in CASES}
        runs.update({(QWEN, kind, mode, gqa): _run(
            "attention", kind, mode, QWEN, gqa)
            for kind, mode, gqa in QWEN_CASES})
        yield runs
    finally:
        layers.set_exec_safe(False)
        layers.set_gqa_mode("grouped")
        shd.set_active_axis_sizes(None)
        destroy_fake_world()
        torch.set_num_threads(threads)


def _qwen_key(gqa, case):
    return f"{QWEN} {gqa} {case}"


def _run(block, kind, mode, arch=ARCH, gqa="grouped"):
    cfg = reduced(get_config(arch))
    shape = LAYOUTS[kind]
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(shape),
                      mesh_dim_names=("data", "model"))
    rules = shd.for_mesh(shd.TRAIN_RULES if kind == "train"
                         else shd.PREFILL_RULES, mesh)
    shd.set_active_axis_sizes(dict(zip(("data", "model"), shape)))
    layers.set_exec_safe(mode == "exec-safe")
    layers.set_gqa_mode(gqa)
    train = kind == "train"
    if block == "attention":
        mod, specs = layers.Attention(cfg, "meta"), layers.attention_specs(
            rules)
        pos = torch.arange(S, device="meta")[None].expand(B, S)

        def fn(x):
            return mod(cfg, x, pos, rules=rules)
    else:
        mod = layers.MLP(cfg.d_model, cfg.d_ff, device="meta")
        specs = layers.mlp_specs(rules)

        def fn(x):
            return mod(x, rules)
    for n, p in list(mod.named_parameters()):
        setattr(mod, n, torch.nn.Parameter(distribute(p, specs[n], mesh),
                                           requires_grad=train))
    x = distribute(torch.empty(B, S, cfg.d_model, dtype=torch.bfloat16,
                               device="meta"), rules.resid, mesh)
    x.requires_grad_(train)
    shd.GATHERED.clear()
    # the gather fallback inside the counter, which hands DTensor ops on
    # past the modes below it
    with CollectiveCounter() as cc, shd.dtensor_run(mod), \
            shd.PartialCasts() as casts:
        out = fn(x)
        if train:
            out.float().sum().backward()
    return (collective_bytes_by_dtype(cc.typed), casts.count,
            tuple(out.placements), out.dtype)


def _bytes(typed, kinds, dtype=None):
    return sum(v for k, v in typed.items() if k.split()[0] in kinds
               and (dtype is None or k.split()[1] == dtype))


@pytest.mark.parametrize("block,kind,mode", CASES)
def test_every_reduction_is_f32(reference, port, block, kind, mode):
    case = f"{block} {kind} {mode}"
    ref, (got, casts, _, _) = reference[case], port[block, kind, mode]
    assert _bytes(ref, REDUCTIONS) > 0, ref
    assert _bytes(ref, REDUCTIONS) == _bytes(ref, REDUCTIONS, "f32"), ref
    assert _bytes(got, REDUCTIONS) > 0, got
    assert _bytes(got, REDUCTIONS) == _bytes(got, REDUCTIONS, "f32"), got
    assert casts == 0


@pytest.mark.parametrize("block,kind,mode", CASES)
def test_reduction_bytes_within_gspmd(reference, port, block, kind, mode):
    ref = reference[f"{block} {kind} {mode}"]
    got = port[block, kind, mode][0]
    assert _bytes(got, REDUCTIONS) <= _bytes(ref, REDUCTIONS), (got, ref)


@pytest.mark.parametrize("block,kind,mode", CASES)
def test_no_gather_where_gspmd_has_none(reference, port, block, kind, mode):
    ref = reference[f"{block} {kind} {mode}"]
    got = port[block, kind, mode][0]
    for g in GATHERS:
        if not _bytes(ref, (g,)):
            assert not _bytes(got, (g,)), (g, got, ref)


@pytest.mark.parametrize("block", ["attention", "mlp"])
@pytest.mark.parametrize("mode", ["bf16", "exec-safe"])
def test_prefill_reduce_scatters_f32_onto_the_residual(port, block, mode):
    """The forward's one reduction: the (B, S, D) f32 sum scattered over
    the sequence's four shards, left in the residual's layout."""
    typed, _, placements, dtype = port[block, "prefill", mode]
    d = reduced(get_config(ARCH)).d_model
    assert _bytes(typed, REDUCTIONS) == B * S // 4 * d * 4, typed
    assert typed.get("reduce-scatter f32") == B * S // 4 * d * 4, typed
    assert placements == (Shard(0), Shard(1)) and dtype == torch.bfloat16


@pytest.mark.parametrize("kind,mode,gqa", QWEN_CASES)
def test_qwen_every_reduction_is_f32(reference, port, kind, mode, gqa):
    """K/V gathered over head_dim: the scores are never a Partial sum.
    In the grouped prefill `_split_heads` moved q's heads onto the query
    sequence, so the scores and the value product stay split along the
    sequence, the residual's layout; the output projection's weight is
    then gathered (`layers._resolved`: it shards a summed label beside the
    sequence-sharded output) and nothing is reduced at all, on torch 2.13
    and on the card's 2.11 alike."""
    ref = reference[_qwen_key(gqa, f"attention {kind} {mode}")]
    got, casts, _, _ = port[QWEN, kind, mode, gqa]
    assert _bytes(ref, REDUCTIONS) > 0, ref
    assert _bytes(ref, REDUCTIONS) == _bytes(ref, REDUCTIONS, "f32"), ref
    if (kind, gqa) == ("prefill", "grouped"):
        assert _bytes(got, REDUCTIONS) == 0, got
    else:
        assert _bytes(got, REDUCTIONS) > 0, got
    assert _bytes(got, REDUCTIONS) == _bytes(got, REDUCTIONS, "f32"), got
    assert casts == 0


@pytest.mark.parametrize("kind,mode,gqa", QWEN_CASES)
def test_qwen_reduction_bytes_within_gspmd(reference, port, kind, mode,
                                           gqa):
    ref = reference[_qwen_key(gqa, f"attention {kind} {mode}")]
    got = port[QWEN, kind, mode, gqa][0]
    assert _bytes(got, REDUCTIONS) <= _bytes(ref, REDUCTIONS), (got, ref)
    if kind == "train":
        assert _bytes(ref, REDUCTIONS) == GSPMD_QWEN_TRAIN_REDUCTIONS, ref


@pytest.mark.parametrize("kind,mode,gqa", QWEN_CASES)
def test_qwen_collective_bytes_below_the_parent(port, kind, mode, gqa):
    """Fewer collective bytes in all than with K/V's head_dim left sharded
    (PARENT_QWEN), and no more f32 gathered: the attention output's
    gradient is held in its forward layout (`layers.held`)."""
    got = port[QWEN, kind, mode, gqa][0]
    parent = PARENT_QWEN[kind, mode, gqa]
    assert sum(got.values()) < sum(parent.values()), (got, parent)
    assert got.get("all-gather f32", 0) <= parent.get("all-gather f32", 0), \
        (got, parent)


@pytest.mark.parametrize("mode", ["bf16", "exec-safe"])
@pytest.mark.parametrize("gqa", GQA_MODES)
def test_qwen_prefill_reduces_at_most_the_residual(port, mode, gqa):
    """The forward reduces no more than the row-parallel sum onto the
    residual, (B, S, D) f32 over four shards, and leaves its output in
    the residual's layout."""
    typed, _, placements, dtype = port[QWEN, "prefill", mode, gqa]
    d = reduced(get_config(QWEN)).d_model
    assert _bytes(typed, REDUCTIONS) <= B * S // 4 * d * 4, typed
    assert not _bytes(typed, ("all-reduce",)), typed
    assert placements == (Shard(0), Shard(1)) and dtype == torch.bfloat16
