"""A reduced model's prefill, decode step and train step with DTensor
parameters on a one-device mesh (a gloo group of one rank) against the
plain NULL_RULES run, and two checkpointed `Trainer` steps with
`shardings=` against plain ones; prints "<step> bit-equal" for each whose
every output is equal bit for bit, and whether `shard_batch` kept the
batch's values. Run by tests/test_torch_dryrun.py:

    PYTHONPATH=src python tests/torch_one_device_rules.py STORE_PATH ARCH
"""
import sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

import repro_torch.models as M
from repro_torch.configs import get_config, reduced
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.specs import (cache_specs, distribute_params,
                                        distribute_tensors, param_specs)
from repro_torch.train.trainer import make_train_step

dist.init_process_group("gloo", store=dist.FileStore(sys.argv[1], 1),
                        rank=0, world_size=1)
mesh = DeviceMesh("cpu", torch.zeros(1, 1, dtype=torch.int64),
                  mesh_dim_names=("data", "model"))
cfg = reduced(get_config(sys.argv[2]))
gen = torch.Generator().manual_seed(0)
toks = torch.randint(0, cfg.vocab, (2, 12), generator=gen, dtype=torch.int32)
batch = {"tokens": toks}


def full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def run(kind, rules):
    model = M.init_params(cfg, device="cpu")
    if rules is not shd.NULL_RULES:
        distribute_params(model, param_specs(cfg, rules, model), mesh)
    if kind == "prefill":
        with torch.no_grad():
            return [full(M.prefill(model, cfg, batch, rules=rules)[0])]
    if kind == "decode":
        with torch.no_grad():
            _, cache = M.prefill(model, cfg, batch)  # plain cache
            cache = {k: torch.nn.functional.pad(
                v, (0, 0) * (v.ndim - 3) + (0, 4)) for k, v in cache.items()}
            if rules is not shd.NULL_RULES:
                cache = distribute_tensors(cache, cache_specs(cfg, rules),
                                           mesh)
            logits, cache = M.decode_step(model, cfg, toks[:, :1], 12, cache,
                                          rules=rules)
            return [full(logits)] + [full(cache[k]) for k in sorted(cache)]
    opt_cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1)
    named = dict(model.named_parameters())
    state = adamw.init(opt_cfg, named)
    _, _, m = make_train_step(cfg, opt_cfg, rules)(model, state, batch)
    return [full(m["loss"]), full(m["grad_norm"])] + [
        full(p).detach() for _, p in model.named_parameters()]


def trainer_run(rules, shardings, ckpt_dir):
    """Two `Trainer` steps (checkpointed) on the pipeline's batches."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    t = Trainer(cfg, ShapeConfig("tiny", 12, 2, "train"),
                tcfg=TrainerConfig(total_steps=2, ckpt_every=1,
                                   ckpt_dir=ckpt_dir),
                rules=rules, shardings=shardings, device="cpu")
    out = t.run()
    return [torch.tensor(out["losses"])] + [
        full(p).detach() for _, p in t.state["params"].named_parameters()]


def sharded_batch_equal():
    """`shard_batch` lays a pipeline batch out by its specs, values kept."""
    from repro_torch.data.pipeline import SyntheticTokenSource, shard_batch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.parallel.specs import batch_specs
    rules = shd.for_mesh(shd.TRAIN_RULES, mesh)
    host = SyntheticTokenSource(cfg, ShapeConfig("tiny", 12, 2, "train"),
                                seed=0).batch_at(0)
    pl = {k: shd.placements(v, mesh)
          for k, v in batch_specs(cfg, rules).items()}
    got = shard_batch(host, pl, mesh)
    return all(isinstance(got[k], DTensor) and torch.equal(
        got[k].full_tensor(), torch.from_numpy(host[k])) for k in host)


for kind, rs in (("prefill", shd.PREFILL_RULES), ("decode", shd.DECODE_RULES),
                 ("train", shd.TRAIN_RULES)):
    want = run(kind, shd.NULL_RULES)
    got = run(kind, shd.for_mesh(rs, mesh))
    assert len(want) == len(got)
    same = all(torch.equal(a, b) for a, b in zip(want, got))
    print(kind, "bit-equal" if same else "DIFFERENT")
rules = shd.for_mesh(shd.TRAIN_RULES, mesh)
want = trainer_run(shd.NULL_RULES, None, sys.argv[1] + "-plain")
got = trainer_run(rules, (mesh, param_specs(cfg, rules)), sys.argv[1] + "-dt")
same = len(want) == len(got) and all(torch.equal(a, b)
                                     for a, b in zip(want, got))
print("trainer", "bit-equal" if same else "DIFFERENT")
print("shard_batch", "equal" if sharded_batch_equal() else "DIFFERENT")
dist.destroy_process_group()
