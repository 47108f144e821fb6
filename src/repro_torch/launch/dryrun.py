"""Multi-pod dry-run (the port of `repro/launch/dryrun.py`): trace every
(architecture x input shape x mesh) cell against the production meshes of
256 or 512 placeholder H100s and extract memory, FLOP and collective
figures for the roofline analysis.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --out results/dryrun.json

Nothing is allocated: parameters, optimizer state, caches and batches are
meta tensors wrapped as DTensors on a fake process group's mesh
(`launch.mesh.make_production_mesh`), each laid out by its spec
(`parallel.specs`) sanitized against its shape, as the reference's
`_sds` lays out its inputs. A cell's step (the train step, prefill or one
decode step) runs once under `analysis.op_cost.Tracer`, which counts its
FLOPs at global shapes, the collectives DTensor issues and the peak of
live local bytes. Meshes are "cuda" (the placeholders are H100s) unless
`--device-type cpu` is given, which runs without a card (there DTensor
replaces an all-to-all by an all-gather, so the collectives differ). The
products take the mode `models.layers.set_exec_safe` says, on the meta
shards as on a card: by default, as in the reference's dry-run, bf16
operands into the f32-result product, which DTensor shards as it shards
`mm` / `bmm` (`parallel.sharding.register_product_strategies`).

The port's layer stacks are Python loops, not scans, so a full-depth trace
costs a few milliseconds an op for every op of every layer. A cell is
therefore traced at a few cut depths (one more layer of each kind than a
base cut: local or global attention, dense or MoE, hybrid group or Mamba
tail, encoder or decoder) and every count is extrapolated to the full
depth, each count being linear in the number of layers of each kind; a
token loop (`models.layers.scan`, the WKV recurrence) is traced once and
charged times its trip count. `tests/test_torch_flops.py` holds the
extrapolated counts equal to full-depth traces on reduced configs.

A cell's record has the reference's keys, `xla_cost` aside: `memory`
holds `argument_size_in_bytes`, `output_size_in_bytes` and
`alias_size_in_bytes` (the donated state: parameters and optimizer state
in train, the cache in decode), exact from the local shard shapes, and
`temp_size_in_bytes`, the peak live local bytes of the deepest traced cut
(a lower bound); `compile_s` is the trace's seconds. Cell failures are
data, as in the reference.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from fractions import Fraction
from typing import Dict, List, Sequence, Tuple

import torch

from .. import models
from ..analysis.collectives import collective_bytes, collective_counts
from ..analysis.op_cost import Tracer
from ..analysis.roofline import Roofline, model_flops
from ..configs import SHAPES_BY_NAME, get_config, list_archs
from ..configs.base import ModelConfig, ShapeConfig
from ..models import encdec, layers, lm
from ..models import moe as moe_mod
from ..models import rwkv as rwkv_mod
from ..optim import adamw
from ..parallel import sharding as shd
from ..parallel.specs import (batch_specs, cache_specs, distribute,
                              distribute_params, param_specs)
from ..train.trainer import make_train_step
from .mesh import make_production_mesh

# long_500k eligibility: sub-quadratic or bounded-KV archs only.
LONG_OK = {"zamba2-7b", "rwkv6-7b", "gemma3-4b", "h2o-danube-1.8b"}

_CONTEXT_PARALLEL = False  # set by apply_perf_flags (hillclimb)


def rules_for(cfg: ModelConfig, shape: ShapeConfig, mesh) -> shd.Rules:
    """The reference's `rules_for` on a DeviceMesh, with its perf knobs
    (`_CONTEXT_PARALLEL`, `moe.DISPATCH_MODE`, `rwkv.WKV_MODE`, set by
    `apply_perf_flags`; the models read the last two themselves)."""
    if shape.kind == "train":
        rules = shd.TRAIN_RULES
    elif shape.kind == "prefill":
        rules = shd.PREFILL_RULES
    elif shape.name.startswith("long"):
        rules = shd.LONG_DECODE_RULES
    else:
        rules = shd.DECODE_RULES
    rules = shd.for_mesh(rules, mesh)
    names = rules.all_axes
    # Huge-expert MoE decode: EP across the whole non-pod mesh.
    if cfg.moe and cfg.moe.n_experts >= 64 and shape.kind == "decode":
        ep = tuple(a for a in ("data", "model") if a in names)
        rules = dataclasses.replace(rules, expert_axes=ep)
    sizes = shd.axis_sizes(mesh)
    groups = 1
    if not rules.expert_axes:  # full-mesh EP owns the data axis: one group
        for a in rules.data_axes:
            groups *= sizes.get(a, 1)
    rules = dataclasses.replace(rules, moe_groups=groups)
    if _CONTEXT_PARALLEL and shape.kind in ("prefill", "train"):
        rules = dataclasses.replace(rules, context_parallel=True)
    return rules


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                rules) -> Dict[str, torch.Tensor]:
    """DTensor stand-ins (meta shards) for every model input of a cell."""
    b, s = shape.global_batch, shape.seq_len
    bspec = batch_specs(cfg, rules)
    out = {}
    if shape.kind == "decode":
        out["tokens"] = distribute(_meta((b, 1), torch.int32),
                                   (rules._d(), None), mesh)
        return out
    n_text = s
    if cfg.family == "vlm":
        p = cfg.n_prefix_embeds
        n_text = s - p
        out["embeds"] = distribute(_meta((b, p, cfg.d_model)),
                                   bspec["embeds"], mesh)
    if cfg.family == "encdec":
        n_text = s // 2
        out["src_embeds"] = distribute(_meta((b, s - n_text, cfg.d_model)),
                                       bspec["src_embeds"], mesh)
    out["tokens"] = distribute(_meta((b, n_text), torch.int32),
                               bspec["tokens"], mesh)
    return out


def _meta_model(cfg: ModelConfig):
    return (encdec.EncDec if cfg.family == "encdec"
            else lm.DecoderLM)(cfg, torch.device("meta"))


def opt_config(cfg: ModelConfig) -> adamw.AdamWConfig:
    """bf16 moments for the 671B config (f32 ones do not fit a pod)."""
    mdt = torch.bfloat16 if cfg.param_count() > 1e11 else torch.float32
    return adamw.AdamWConfig(moment_dtype=mdt)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, rules=None):
    """Returns (step_fn, abstract args tuple, donated arg indices)."""
    rules = rules or rules_for(cfg, shape, mesh)
    params = _meta_model(cfg)
    distribute_params(params, param_specs(cfg, rules, params), mesh)
    batch = input_specs(cfg, shape, mesh, rules)

    if shape.kind == "train":
        opt_cfg = opt_config(cfg)
        opt = adamw.init(opt_cfg, dict(params.named_parameters()))
        return make_train_step(cfg, opt_cfg, rules), (params, opt, batch), \
            (0, 1)

    if shape.kind == "prefill":
        def fn(p, b):
            return models.prefill(p, cfg, b, rules=rules)
        return fn, (params, batch), ()

    cache = models.init_cache(cfg, shape.global_batch, shape.seq_len,
                              src_len=shape.seq_len // 2, device="meta")
    cspecs = cache_specs(cfg, rules)
    cache = {k: distribute(v, cspecs[k], mesh) for k, v in cache.items()}

    def fn(p, t, pos_, c):
        return models.decode_step(p, cfg, t, pos_, c, rules=rules)
    return fn, (params, batch["tokens"], shape.seq_len - 1, cache), (3,)


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.nn.Module):
        return [p for _, p in tree.named_parameters()]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    n = 0
    for t in _tensors(tree):
        loc = t.to_local() if isinstance(t, DTensor) else t
        n += loc.numel() * loc.element_size()
    return n


def argument_bytes(args, shape: ShapeConfig) -> int:
    """Per-device bytes of a cell's arguments; a decode step's write
    position, a Python int here, counts as the int32 scalar the
    reference passes."""
    return _local_bytes(args) + (4 if shape.kind == "decode" else 0)


def _bytes_of(tree) -> int:
    """Global bytes of every tensor in a tree (a model's parameters)."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _state_traffic_bytes(cfg, shape, in_bytes, out_bytes) -> float:
    """Per-step whole-program HBM traffic (analytic lower bound): every
    input read once + every output written once + the activation stream
    (layers x tokens x d_model, forward write/read and — for training —
    remat recompute)."""
    tokens = shape.global_batch * shape.seq_len
    layers = (cfg.enc_layers + cfg.dec_layers) or cfg.n_layers
    passes = {"train": 4.0, "prefill": 2.0, "decode": 0.0}[shape.kind]
    act = passes * layers * tokens * cfg.d_model * 2.0
    return in_bytes + out_bytes + act


@contextlib.contextmanager
def mesh_dim_strategy_costs():
    """While open, DTensor prices a candidate sharding strategy mesh
    dimension by mesh dimension (its per-dimension transition costs, a
    strided shard priced as a plain one), as torch did before its
    graph-based redistribution planner; the planner still plans every
    redistribution that runs. On a 3-D mesh the planner's search for every
    candidate of every op takes minutes an op (torch 2.13). Where torch has
    no such hooks, nothing changes. Yields whether the pricing engaged."""
    import torch.distributed.tensor._ops.utils as ops_utils
    from torch.distributed.tensor import _collective_utils as cu
    from torch.distributed.tensor.placement_types import Replicate, Shard

    orig = getattr(ops_utils, "redistribute_cost", None)
    if orig is None or not all(hasattr(cu, n) for n in (
            "_compute_placement_transition_cost", "MeshTopoInfo",
            "spec_to_bytes")):
        yield False
        return

    def cost(current, target):
        if current.mesh != target.mesh:
            return float("inf")
        if current.is_replicated() or current.placements == target.placements:
            return 0.0
        if getattr(current, "shard_order", ()) is None or \
                getattr(target, "shard_order", ()) is None:
            return float("inf")     # torch's own rule: no such transform
        topo = cu.MeshTopoInfo.build_from_mesh(current.mesh)
        gb = cu.spec_to_bytes(current) / current.num_shards / 1024 ** 3
        total = 0.0
        for i, (c, t) in enumerate(zip(current.placements,
                                       target.placements)):
            if c == t:
                continue
            # a strided shard leaves by a gather, and none is made
            steps = [(c, t)]
            if shd.is_strided(c):
                steps = [(Shard(c.dim), Replicate()), (Replicate(), t)]
            if shd.is_strided(t):
                return float("inf")
            for a, b in steps:
                step, gb = cu._compute_placement_transition_cost(
                    a, b, topo, i, gb)
                if step == float("inf"):
                    return step
                total += step
        return total

    ops_utils.redistribute_cost = cost
    try:
        yield True
    finally:
        ops_utils.redistribute_cost = orig


# ---------------------------------------------------------------------------
# Depth cuts and extrapolation
# ---------------------------------------------------------------------------

def _units(cfg: ModelConfig) -> Dict[str, int]:
    """How many layers of each kind `cfg` has."""
    fam = cfg.family
    if fam == "mla_moe":
        nd = cfg.moe.first_dense_layers
        return {"dense": nd, "moe": cfg.n_layers - nd}
    if fam == "hybrid_ssm":
        g, _, tail = lm._hybrid_dims(cfg)
        return {"group": g, "tail": tail}
    if fam == "encdec":
        return {"enc": cfg.enc_layers, "dec": cfg.dec_layers}
    flags = lm._layer_flags(cfg)
    return {k: sum(1 for f in flags if str(f) == k)
            for k in sorted({str(f) for f in flags})}


def _cut(cfg: ModelConfig, counts: Dict[str, int]) -> ModelConfig:
    fam = cfg.family
    if fam == "mla_moe":
        return dataclasses.replace(
            cfg, n_layers=counts["dense"] + counts["moe"],
            moe=dataclasses.replace(cfg.moe,
                                    first_dense_layers=counts["dense"]))
    if fam == "hybrid_ssm":
        a = cfg.ssm.attn_every
        return dataclasses.replace(
            cfg, n_layers=counts["group"] * a + counts.get("tail", 0))
    if fam == "encdec":
        return dataclasses.replace(cfg, enc_layers=counts["enc"],
                                   dec_layers=counts["dec"],
                                   n_layers=counts["enc"] + counts["dec"])
    return dataclasses.replace(cfg, n_layers=sum(counts.values()))


def _candidates(cfg: ModelConfig):
    """Cut configs' unit counts, smallest first."""
    full = _units(cfg)
    fam = cfg.family
    if fam in ("mla_moe", "hybrid_ssm", "encdec"):
        keys = list(full)
        out = []
        for i in range(3):
            for j in range(3):
                c = dict(zip(keys, (i, j)))
                if 0 < i + j and all(c[k] <= full[k] for k in keys) and (
                        fam != "hybrid_ssm" or (i > 0 and
                                                j < cfg.ssm.attn_every)):
                    out.append(c)
        # cuts that drop a kind the config has come last (an enc-dec with
        # no decoder layer has no cache to stack)
        return sorted(out, key=lambda c: (
            sum(1 for k in keys if full[k] and not c[k]), sum(c.values()),
            list(c.values())))
    flags = [str(f) for f in lm._layer_flags(cfg)]
    return [{k: flags[:n].count(k) for k in full}
            for n in range(1, len(flags) + 1)]


def _rank(rows) -> int:
    m = [[Fraction(x) for x in r] for r in rows]
    rank, cols = 0, len(m[0]) if m else 0
    for c in range(cols):
        piv = next((i for i in range(rank, len(m)) if m[i][c] != 0), None)
        if piv is None:
            continue
        m[rank], m[piv] = m[piv], m[rank]
        for i in range(len(m)):
            if i != rank and m[i][c] != 0:
                f = m[i][c] / m[rank][c]
                m[i] = [a - f * b for a, b in zip(m[i], m[rank])]
        rank += 1
    return rank


def depth_cuts(cfg: ModelConfig) -> Tuple[List[Dict[str, int]], List[str]]:
    """The fewest, smallest cuts whose unit counts (with a constant term)
    determine a count linear in the layers of each kind; (cuts, kinds)."""
    full = _units(cfg)
    kinds = [k for k in full if full[k] > 0]
    cuts, rows = [], []
    for c in _candidates(cfg):
        row = [1] + [c.get(k, 0) for k in kinds]
        if _rank(rows + [row]) > len(rows):
            cuts.append(c)
            rows.append(row)
        if len(rows) == len(kinds) + 1:
            return cuts, kinds
    raise ValueError(f"{cfg.name}: no depth cuts determine {kinds}")


def extrapolate(cuts: Sequence[Dict[str, int]], kinds: Sequence[str],
                values: Sequence[int], full: Dict[str, int]):
    """The value at `full` of the count linear in the unit counts that takes
    `values` at `cuts` (exact rational solve; an int when it is one)."""
    n = len(kinds) + 1
    m = [[Fraction(1)] + [Fraction(c.get(k, 0)) for k in kinds]
         + [Fraction(v)] for c, v in zip(cuts, values)]
    for col in range(n):
        piv = next(i for i in range(col, n) if m[i][col] != 0)
        m[col], m[piv] = m[piv], m[col]
        for i in range(n):
            if i != col and m[i][col] != 0:
                f = m[i][col] / m[col][col]
                m[i] = [a - f * b for a, b in zip(m[i], m[col])]
    coef = [m[i][n] / m[i][i] for i in range(n)]
    v = coef[0] + sum(c * full[k] for c, k in zip(coef[1:], kinds))
    return int(v) if v.denominator == 1 else float(v)


def trace_step(fn, args) -> Dict:
    """Run one cell step under the tracer; its counts, exact ints."""
    # the models' cached f32 constants are made anew in every trace, so a
    # trace's count does not depend on what ran before it
    layers._f32.cache_clear()
    with Tracer() as tr:
        out = fn(*args)
    rec = {"flops": tr.flops.total, "gemm_flops": tr.flops.gemm,
           "out_local": _local_bytes(out), "out_global": _bytes_of(out),
           "peak": tr.local.peak_bytes}
    for k, v in collective_bytes(tr.local.events).items():
        rec["coll:" + k] = int(v)
    for k, v in collective_counts(tr.local.events).items():
        rec["count:" + k] = v
    for k, v in tr.fallbacks.items():
        rec["replicated:" + k] = v
    for k, v in tr.strided_views.items():
        rec["strided:" + k] = v
    return rec


def traced_counts(cfg: ModelConfig, shape: ShapeConfig, mesh, rules,
                  full_depth: bool = False) -> Dict:
    """The cell's counts at full depth: traced at the depth cuts and
    extrapolated (or traced whole with `full_depth`); `peak` is the
    deepest trace's, and `cuts` the unit counts traced."""
    if full_depth:
        fn, args, _ = build_cell(cfg, shape, mesh, rules)
        rec = trace_step(fn, args)
        rec["cuts"] = [_units(cfg)]
        return rec
    cuts, kinds = depth_cuts(cfg)
    recs = []
    for c in cuts:
        fn, args, _ = build_cell(_cut(cfg, c), shape, mesh, rules)
        recs.append(trace_step(fn, args))
        del fn, args
    keys = sorted({k for r in recs for k in r} - {"peak"})
    full = _units(cfg)
    out = {k: extrapolate(cuts, kinds, [r.get(k, 0) for r in recs], full)
           for k in keys}
    out["peak"] = max(r["peak"] for r in recs)
    out["cuts"] = cuts
    return out


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def measure_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, rules=None,
                 full_depth: bool = False) -> Dict:
    """status "ok" with memory, collectives, roofline, or raises."""
    rules = rules or rules_for(cfg, shape, mesh)
    shd.set_active_axis_sizes(shd.axis_sizes(mesh))
    try:
        _, args, donate = build_cell(cfg, shape, mesh, rules)
        arg_bytes = argument_bytes(args, shape)
        alias = sum(_local_bytes(args[i]) for i in donate)
        in_global = _bytes_of(args)
        del args
        with mesh_dim_strategy_costs() as per_dim:
            rec = traced_counts(cfg, shape, mesh, rules, full_depth)
    finally:
        shd.set_active_axis_sizes(None)
    coll = {k[5:]: v for k, v in rec.items() if k.startswith("coll:")}
    coll.setdefault("total", 0)
    counts = {k[6:]: v for k, v in rec.items() if k.startswith("count:")}
    fallbacks = {k[11:]: v for k, v in rec.items()
                 if k.startswith("replicated:")}
    strided = {k[8:]: v for k, v in rec.items() if k.startswith("strided:")}
    hbm = _state_traffic_bytes(cfg, shape, in_global, rec["out_global"])
    rl = Roofline(flops=rec["flops"], hbm_bytes=hbm,
                  collective_bytes_per_chip=coll["total"],
                  chips=mesh.size(), model_flops=model_flops(cfg, shape))
    return {"status": "ok",
            "memory": {"argument_size_in_bytes": arg_bytes,
                       "output_size_in_bytes": rec["out_local"],
                       "temp_size_in_bytes": rec["peak"],
                       "alias_size_in_bytes": alias},
            "collectives": coll, "collective_counts": counts,
            "roofline": rl.as_dict(), "gemm_flops": rec["gemm_flops"],
            "replicated_ops": fallbacks, "strided_views": strided,
            "strategy_costs": "per mesh dimension" if per_dim else "torch",
            "traced_cuts": rec["cuts"]}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             verbose: bool = True, device_type: str = "cuda") -> Dict:
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=device_type)
    cell = {"arch": arch, "shape": shape_name,
            "mesh": "multi" if multi_pod else "single",
            "chips": mesh.size()}
    if shape_name == "long_500k" and arch not in LONG_OK:
        cell.update(status="skipped",
                    reason="pure full-attention arch: no sub-quadratic path")
        return cell
    t0 = time.perf_counter()
    try:
        rules = rules_for(cfg, shape, mesh)
        res = measure_cell(cfg, shape, mesh, rules)
        cell.update(status="ok", compile_s=time.perf_counter() - t0)
        cell.update({k: v for k, v in res.items() if k != "status"})
        if verbose:
            rl = cell["roofline"]
            print(f"[ok] {arch} x {shape_name} x {cell['mesh']}  "
                  f"trace={cell['compile_s']:.1f}s  bottleneck="
                  f"{rl['bottleneck']}  frac={rl['roofline_fraction']}",
                  flush=True)
    except Exception as e:  # noqa: BLE001 — cell failures are data
        cell.update(status="error", error=f"{type(e).__name__}: {e}",
                    traceback=traceback.format_exc(limit=-12),
                    compile_s=time.perf_counter() - t0)
        if verbose:
            print(f"[FAIL] {arch} x {shape_name} x {cell['mesh']}: "
                  f"{cell['error']}", flush=True)
    return cell


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=sorted(SHAPES_BY_NAME))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device-type", choices=["cuda", "cpu"], default="cuda",
                    help="what the placeholder devices are (cpu: no card "
                         "needed)")
    ap.add_argument("--moe-dispatch", choices=["sort", "cumsum"],
                    default=None)
    ap.add_argument("--wkv-mode", choices=["scan", "chunked"], default=None)
    ap.add_argument("--context-parallel", action="store_true")
    ap.add_argument("--gqa-mode", choices=["grouped", "repeat_kv"],
                    default=None)
    ap.add_argument("--xent-mode", choices=["gather", "onehot"],
                    default=None)
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    apply_perf_flags(args.moe_dispatch, args.wkv_mode,
                     args.context_parallel, args.gqa_mode, args.xent_mode)
    if args.device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the production meshes are 'cuda' "
                           "meshes; pass --device-type cpu to run without "
                           "a card")

    cells = []
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        targets = [(a, s) for a in list_archs() for s in SHAPES_BY_NAME]
    elif args.arch and args.shape:
        targets = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")

    def save():
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(cells, fh, indent=1)

    for arch, shape in targets:
        for mp in meshes:
            cells.append(run_cell(arch, shape, mp,
                                  device_type=args.device_type))
            if args.out:        # incremental save: long sweeps are resumable
                save()
    if args.out:
        save()
        print(f"wrote {len(cells)} cells -> {args.out}")
    ok = sum(c["status"] == "ok" for c in cells)
    skip = sum(c["status"] == "skipped" for c in cells)
    err = sum(c["status"] == "error" for c in cells)
    print(f"cells: {ok} ok, {skip} skipped, {err} failed")
    return 1 if err else 0


# ---------------------------------------------------------------------------
# Hillclimb knobs (the reference's): every layout variant is a CLI flag, set
# as module state before the cells trace.
# ---------------------------------------------------------------------------

def apply_perf_flags(moe_dispatch=None, wkv_mode=None,
                     context_parallel=False, gqa_mode=None, xent_mode=None):
    """Set the reference's layout knobs: the MoE dispatch and WKV mode
    defaults, GQA and cross-entropy modes (each when given) and context
    parallelism (always)."""
    global _CONTEXT_PARALLEL
    if moe_dispatch:
        moe_mod.DISPATCH_MODE = moe_dispatch
    if wkv_mode:
        rwkv_mod.WKV_MODE = wkv_mode
    if gqa_mode:
        layers.set_gqa_mode(gqa_mode)
    if xent_mode:
        layers.set_xent_mode(xent_mode)
    _CONTEXT_PARALLEL = context_parallel


if __name__ == "__main__":
    raise SystemExit(main())
