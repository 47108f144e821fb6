"""Decode steps of reduced models with DTensor parameters and a
sequence-sharded cache on a real gloo group, against the plain run
(NULL_RULES) of the same model on the same inputs. Every rank runs it;
rank 0 prints one JSON line per (layout, arch): whether every cache entry
is bit-equal to the plain run's, the logits' largest difference and
largest magnitude, the ops `GatherFallback` gathered, the views that
flattened a sharded dimension that does not lead its group by site
(`parallel.sharding.StridedViews`), and how many
softmaxes ran with their keys split and how many cache rows were written
on their shard. First, one line per cache layout: whether `write_row` at
every position of a DTensor laid out so (plain shards and a strided one
among them) equals the plain write, placements kept. Run by
tests/test_torch_seq_sharded_ranks.py, one process a rank:

    PYTHONPATH=src python tests/torch_seq_sharded_ranks.py STORE WORLD RANK

With 2 ranks it runs DECODE_RULES on a (1, 2) ("data", "model") mesh; with
4, DECODE_RULES on (2, 2) and LONG_DECODE_RULES on (1, 4).
"""
import dataclasses
import json
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

import repro_torch.models as M
from repro_torch.configs import get_config, reduced
from repro_torch.models import layers, lm, mla
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.specs import (cache_specs, distribute_params,
                                        distribute_tensors, param_specs)

ARCHS = ("qwen2.5-3b", "gemma3-4b", "deepseek-v3-671b", "zamba2-7b",
         "seamless-m4t-medium")
BATCH, PROMPT, MAX_LEN, SRC_LEN, STEPS = 2, 20, 32, 8, 2
SOFTCAP = 30.0  # gemma3-4b's reduced config takes one, to exercise it
LAYOUTS = {2: [("decode (1, 2)", (1, 2), shd.DECODE_RULES)],
           4: [("decode (2, 2)", (2, 2), shd.DECODE_RULES),
               ("long decode (1, 4)", (1, 4), shd.LONG_DECODE_RULES)]}
SEQ_ENTRIES = ("k", "v", "c", "rope")  # the entries of length MAX_LEN
# cache layouts of `write_row` by world size: (name, mesh shape,
# placements of a (B, T, H, D) cache)
WRITE_LAYOUTS = {
    2: [("T over model", (1, 2), ("R", "S1")),
        ("T over both", (1, 2), ("S1", "S1"))],
    4: [("T over data, model", (2, 2), ("S1", "S1")),
        ("T strided over data, model", (2, 2), ("SS1", "S1")),
        ("B over data, T over model", (2, 2), ("S0", "S1")),
        ("T over model alone", (2, 2), ("R", "S1")),
        ("T over data, heads over model", (2, 2), ("S1", "S2"))]}
CALLS = {"split_softmax": 0, "sharded_writes": 0}


def _counting():
    """Count the softmaxes that ran with their keys split and the rows
    written on their shard."""
    softmax, write = layers.softmax_keys, lm._write_row_sharded

    def softmax_keys(scores, split=()):
        CALLS["split_softmax"] += bool(split)
        return softmax(scores, split)

    def write_row_sharded(rows, pos, new):
        CALLS["sharded_writes"] += 1
        return write(rows, pos, new)
    layers.softmax_keys = mla.softmax_keys = softmax_keys
    lm._write_row_sharded = write_row_sharded


def placement(code):
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    if code == "R":
        return Replicate()
    if code.startswith("SS"):
        return _StridedShard(int(code[2:]), split_factor=2)
    return Shard(int(code[1:]))


def write_rows(world):
    """{layout: whether `write_row` at every position equals the plain
    write, placements kept}."""
    from torch.distributed.tensor import distribute_tensor
    out = {}
    rows = torch.arange(2 * 8 * 2 * 4, dtype=torch.float32).reshape(2, 8, 2,
                                                                     4)
    new = -1.0 - torch.arange(2 * 2 * 4, dtype=torch.float32).reshape(
        2, 1, 2, 4)
    for name, shape, codes in WRITE_LAYOUTS[world]:
        mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                          mesh_dim_names=("data", "model"))
        pl = [placement(c) for c in codes]
        ok = True
        for pos in range(rows.shape[1]):
            want = rows.clone()
            want[:, pos:pos + 1] = new
            got = lm.write_row(distribute_tensor(rows, mesh, pl), pos, new)
            ok &= tuple(got.placements) == tuple(pl) and torch.equal(
                got.full_tensor(), want)
        out[name] = bool(ok)
    return out


def config(arch):
    cfg = reduced(get_config(arch))
    if arch == "gemma3-4b":
        cfg = dataclasses.replace(cfg, attn_logit_softcap=SOFTCAP)
    return cfg


def inputs(cfg):
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (BATCH, PROMPT + STEPS),
                                         dtype=np.int32))
    batch = {"tokens": toks[:, :PROMPT]}
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.from_numpy(rng.standard_normal(
            (BATCH, SRC_LEN, cfg.d_model), dtype=np.float32))
    return batch, toks


def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def decode(cfg, mesh, rules, batch, toks):
    """(the logits of each step, the cache after the last) from the plain
    prefill's cache padded to MAX_LEN; DTensor parameters and cache laid
    out by `rules` unless it is NULL_RULES."""
    model = M.init_params(cfg, device="cpu")
    with torch.no_grad():
        _, cache = M.prefill(model, cfg, batch)
        cache = {k: torch.nn.functional.pad(
            v, (0, 0) * (v.ndim - 3) + (0, MAX_LEN - PROMPT))
            if k in SEQ_ENTRIES else v for k, v in cache.items()}
        if rules is not shd.NULL_RULES:
            distribute_params(model, param_specs(cfg, rules, model), mesh)
            cache = distribute_tensors(cache, cache_specs(cfg, rules), mesh)
        logits = []
        for t in range(STEPS):
            pos = PROMPT + t
            out, cache = M.decode_step(model, cfg, toks[:, pos:pos + 1], pos,
                                       cache, rules=rules)
            logits.append(full(out))
    return torch.stack(logits), {k: full(v) for k, v in cache.items()}


def main():
    store, world, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    for name, ok in write_rows(world).items():
        if rank == 0:
            print(json.dumps({"write_layout": name, "equal": ok}), flush=True)
    _counting()
    for name, shape, rules in LAYOUTS[world]:
        mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                          mesh_dim_names=("data", "model"))
        rules = shd.for_mesh(rules, mesh)
        for arch in ARCHS:
            cfg = config(arch)
            batch, toks = inputs(cfg)
            want_logits, want_cache = decode(cfg, mesh, shd.NULL_RULES,
                                             batch, toks)
            shd.GATHERED.clear()
            CALLS.update(dict.fromkeys(CALLS, 0))
            with shd.StridedViews() as views:
                got_logits, got_cache = decode(cfg, mesh, rules, batch, toks)
            row = {"layout": name, "arch": arch,
                   "cache_bit_equal": sorted(want_cache) == sorted(got_cache)
                   and all(torch.equal(want_cache[k], got_cache[k])
                           for k in want_cache),
                   "max_abs_diff": float((got_logits - want_logits)
                                         .abs().max()),
                   "max_abs_logit": float(want_logits.abs().max()),
                   "gathered": dict(shd.GATHERED),
                   "strided_views": views.sites, **CALLS}
            if rank == 0:
                print(json.dumps(row), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
