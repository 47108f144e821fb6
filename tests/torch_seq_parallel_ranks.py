"""Sequence-parallel prefill and one sharded train step of reduced models
with DTensor parameters on a real gloo group, against the plain run
(NULL_RULES) of the same model on the same inputs. Every rank runs it;
rank 0 prints one JSON line per (layout, arch): the largest difference of
the prefill's logits, or of the train step's loss and, leaf by leaf, of
its gradients over that leaf's largest magnitude; the ops
`GatherFallback` gathered; the views that flattened a sharded dimension
that does not lead its group by site (`parallel.sharding.StridedViews`);
and how many f32 DTensors holding a Partial sum
were cast to bf16 (`parallel.sharding.PartialCasts`). First, one line per
block (attention, MLP): how many elements of its bf16 output on the mesh
lie more than one bf16 ulp from the plain block's. Run by
tests/test_torch_seq_parallel_ranks.py, one process a rank:

    PYTHONPATH=src python tests/torch_seq_parallel_ranks.py STORE WORLD RANK \\
        [--blocks] [--torch-pricing]

With 2 ranks it runs PREFILL_RULES and TRAIN_RULES on a (1, 2) ("data",
"model") mesh; with 4, PREFILL_RULES on (1, 4) and TRAIN_RULES on (2, 2),
and the blocks under PREFILL_RULES on (1, 4). `--blocks` runs the blocks
alone (they need nothing newer than the models' `rules=`).

The models run with DTensor's candidate strategies priced mesh dimension
by mesh dimension (`launch.dryrun.mesh_dim_strategy_costs`), as the
dry-run prices them: torch 2.13's own pricing, through its redistribution
planner, takes about four times as long (`--torch-pricing` runs it). The
blocks run under torch's own pricing, which makes their row-parallel
products Partial sums (the per-dimension pricing gathers the MLP's hidden
units instead).
"""
import contextlib
import dataclasses
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

import repro_torch.models as M
from repro_torch.configs import get_config, reduced
from repro_torch.launch.dryrun import mesh_dim_strategy_costs
from repro_torch.models import layers
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.specs import (batch_specs, distribute,
                                        distribute_params, distribute_tensors,
                                        param_specs)
from repro_torch.train.trainer import make_train_step

ARCHS = ("qwen2.5-3b", "gemma3-4b", "deepseek-v3-671b", "zamba2-7b",
         "rwkv6-7b", "seamless-m4t-medium")
BATCH, SEQ, SRC_LEN = 2, 32, 8
SOFTCAP = 30.0  # gemma3-4b's reduced config takes one, to exercise it
LAYOUTS = {2: [("prefill (1, 2)", (1, 2), shd.PREFILL_RULES),
               ("train (1, 2)", (1, 2), shd.TRAIN_RULES)],
           4: [("prefill (1, 4)", (1, 4), shd.PREFILL_RULES),
               ("train (2, 2)", (2, 2), shd.TRAIN_RULES)]}
BLOCK_BATCH, BLOCK_SEQ = 2, 64
GRADS = {}


def mesh_of(world, shape):
    return DeviceMesh("cpu", torch.arange(world).reshape(shape),
                      mesh_dim_names=("data", "model"))


def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def config(arch):
    cfg = reduced(get_config(arch))
    if arch == "gemma3-4b":
        cfg = dataclasses.replace(cfg, attn_logit_softcap=SOFTCAP)
    return cfg


def inputs(cfg):
    rng = np.random.default_rng(11)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (BATCH, SEQ), dtype=np.int32))}
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.from_numpy(rng.standard_normal(
            (BATCH, SRC_LEN, cfg.d_model), dtype=np.float32))
    return batch


def _capture_grads():
    """Keep the gradients each train step hands AdamW, whole."""
    apply = adamw.apply

    def captured(opt_cfg, named, grads, state, **kw):
        GRADS.clear()
        GRADS.update({n: None if g is None else full(g).detach().clone()
                      for n, g in grads.items()})
        return apply(opt_cfg, named, grads, state, **kw)
    adamw.apply = captured


def prefill(cfg, mesh, rules, batch):
    model = M.init_params(cfg, device="cpu")
    if rules is not shd.NULL_RULES:
        distribute_params(model, param_specs(cfg, rules, model), mesh)
        batch = distribute_tensors(batch, batch_specs(cfg, rules), mesh)
    with torch.no_grad():
        logits, _ = M.prefill(model, cfg, batch, rules=rules)
    return {"logits": full(logits).float()}


def train_step(cfg, mesh, rules, batch):
    model = M.init_params(cfg, device="cpu")
    if rules is not shd.NULL_RULES:
        distribute_params(model, param_specs(cfg, rules, model), mesh)
        batch = distribute_tensors(batch, batch_specs(cfg, rules), mesh)
    opt_cfg = adamw.AdamWConfig(total_steps=4)
    opt = adamw.init(opt_cfg, dict(model.named_parameters()))
    _, _, metrics = make_train_step(cfg, opt_cfg, rules)(model, opt, batch)
    return {"loss": full(metrics["loss"]).float(), "grads": dict(GRADS)}


def compare(kind, want, got):
    if kind == "prefill":
        return {"max_abs_diff": float((got["logits"] - want["logits"])
                                      .abs().max()),
                "max_abs_logit": float(want["logits"].abs().max())}
    rel = {}
    for n, g0 in want["grads"].items():
        if g0 is None or got["grads"][n] is None:
            rel[n] = 0.0 if g0 is got["grads"][n] else float("inf")
            continue
        scale = float(g0.float().abs().max()) or 1.0
        rel[n] = float((got["grads"][n].float() - g0.float()).abs().max()
                       / scale)
    worst = max(rel, key=rel.get)
    return {"loss_diff": float((got["loss"] - want["loss"]).abs()),
            "grad_rel": rel[worst], "grad_worst": worst,
            "grad_leaves": len(rel),
            "same_leaves": sorted(want["grads"]) == sorted(got["grads"])}


def bf16_ulp(x):
    """The spacing of bf16 numbers at |x| (at the smallest normal for 0)."""
    a = x.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    _, e = torch.frexp(a)
    return torch.ldexp(torch.ones_like(a), e - 8)


def blocks(world):
    """{block: elements of its bf16 output on the (1, world) mesh more than
    one bf16 ulp from the plain block's} under PREFILL_RULES."""
    mesh = mesh_of(world, (1, world))
    rules = shd.for_mesh(shd.PREFILL_RULES, mesh)
    cfg = config("qwen2.5-3b")
    gen = torch.Generator().manual_seed(5)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(
        (BLOCK_BATCH, BLOCK_SEQ, cfg.d_model), dtype=np.float32)).to(
            torch.bfloat16)
    pos = torch.arange(BLOCK_SEQ)[None].expand(BLOCK_BATCH, BLOCK_SEQ)
    attn = layers.Attention(cfg)
    mlp = layers.MLP(cfg.d_model, cfg.d_ff)
    out = {}
    for name, mod, specs, run in (
            ("attention", attn, layers.attention_specs(rules),
             lambda m, t, r: m(cfg, t, pos, rules=r)),
            ("mlp", mlp, layers.mlp_specs(rules),
             lambda m, t, r: m(t, r))):
        mod.reset_parameters(gen)
        with torch.no_grad():
            want = run(mod, x, shd.NULL_RULES)
            for n, p in list(mod.named_parameters()):
                setattr(mod, n, torch.nn.Parameter(
                    distribute(p, specs[n], mesh), requires_grad=False))
            with shd.dtensor_run(mod):
                got = full(run(mod, distribute(x, rules.resid, mesh), rules))
        bad = (got.float() - want.float()).abs() > bf16_ulp(want)
        out[name] = {"beyond_one_ulp": int(bad.sum()),
                     "elements": want.numel(),
                     "max_abs_diff": float((got.float() - want.float())
                                           .abs().max())}
    return out


def main():
    store, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    if world == 4:
        for name, row in blocks(world).items():
            if rank == 0:
                print(json.dumps({"block": name, **row}), flush=True)
    if "--blocks" in sys.argv[4:]:
        dist.destroy_process_group()
        return
    _capture_grads()
    with (contextlib.nullcontext() if "--torch-pricing" in sys.argv[4:]
          else mesh_dim_strategy_costs()):
        models(world, rank)
    dist.destroy_process_group()


def models(world, rank):
    plain = {}
    for name, shape, rules in LAYOUTS[world]:
        mesh = mesh_of(world, shape)
        rules = shd.for_mesh(rules, mesh)
        kind = name.split()[0]
        run = prefill if kind == "prefill" else train_step
        for arch in ARCHS:
            cfg = config(arch)
            batch = inputs(cfg)
            if (kind, arch) not in plain:
                plain[kind, arch] = run(cfg, mesh, shd.NULL_RULES, batch)
            shd.GATHERED.clear()
            t0 = time.perf_counter()
            with shd.PartialCasts() as casts, \
                    shd.StridedViews() as views:
                got = run(cfg, mesh, rules, batch)
            row = {"layout": name, "arch": arch,
                   "seconds": round(time.perf_counter() - t0, 2),
                   **compare(kind, plain[kind, arch], got),
                   "gathered": dict(shd.GATHERED),
                   "strided_views": views.sites,
                   "partial_casts": casts.count, "cast_sites": casts.ops}
            if rank == 0:
                print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
