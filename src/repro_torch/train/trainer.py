"""Training loop with fault tolerance (the port of `repro/train/trainer.py`):
checkpoint/auto-resume, preemption handling, step-deterministic data,
straggler accounting.

A train step is `models.lm_loss` (layer bodies rematerialised), its
backward pass, and `optim.adamw.apply` over the model's parameters in
place. Checkpoints hold the reference's layout — `{"params": <the
reference's parameter pytree>, "opt": OptState(step, mu, nu)}` with the
layer stacks restacked (`interop.params_to_reference`,
`interop.opt_state_to_reference`) and the same `extra` (`pipeline`,
`arch`) — so either package resumes the other's run. `rules` constrains
the step's layouts (`parallel.sharding`; `NULL_RULES` changes nothing) and
`shardings` lays the parameters and moments out as DTensors on a mesh
(`parallel.specs.distribute_params`).
"""
from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import models
from .._device import resolve_device
from ..checkpoint.checkpointing import CheckpointManager
from ..configs.base import ModelConfig, ShapeConfig
from ..data.pipeline import SyntheticTokenSource
from ..interop import (load_reference_, opt_state_from_reference,
                       opt_state_to_reference, params_to_reference,
                       reference_order)
from ..optim import adamw
from ..parallel.sharding import NULL_RULES, dtensor_run
from ..parallel.specs import distribute_params, distribute_tensors


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    rules=NULL_RULES, remat: bool = True):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics {"loss", "grad_norm", "lr"}, 0-d tensors). `params` is the
    port's model, whose parameters it turns gradients on for and updates
    in place; `batch` holds tensors on the model's device. A parameter
    the loss does not reach gets a zero gradient, as in the reference."""

    def train_step(params, opt_state, batch):
        params.requires_grad_(True)
        named = dict(params.named_parameters())
        for p in named.values():
            p.grad = None
        with dtensor_run(params, batch):
            loss, _ = models.lm_loss(params, cfg, batch, rules=rules,
                                     remat=remat)
            loss.backward()
            grads = {n: p.grad for n, p in named.items()}
            _, opt_state, om = adamw.apply(opt_cfg, named, grads, opt_state,
                                           model_cfg=cfg)
        for p in named.values():
            p.grad = None
        return params, opt_state, {"loss": loss.detach(), **om}

    return train_step


def make_eval_step(cfg: ModelConfig, rules=NULL_RULES):
    def eval_step(params, batch):
        with torch.no_grad():
            loss, _ = models.lm_loss(params, cfg, batch, rules=rules,
                                     remat=False)
        return {"loss": loss}
    return eval_step


def batch_to(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A pipeline batch (numpy) as tensors on `device`."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep_last: int = 3
    log_every: int = 10
    straggler_grace: float = 5.0   # x median step time -> flagged


def _skeleton(model, cfg):
    """A tree of the reference parameter pytree's paths (placeholder
    leaves): the restore target of a checkpoint's params and moments."""
    tree = {}
    for path, _ in reference_order(
            [n for n, _ in model.named_parameters()], cfg):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = 0
    return tree


class Trainer:
    """Single-controller training loop on one device ("cuda" unless the
    caller names another; it raises without a card).

    Fault-tolerance behaviour, as the reference's:
      * auto-resume: on construction, restores the latest committed
        checkpoint if one exists (params, optimizer, data-pipeline step);
      * preemption: SIGTERM/SIGINT triggers a synchronous checkpoint before
        the run stops;
      * stragglers: per-step wall times (each step ends in a device sync)
        are tracked; steps slower than `straggler_grace` x running median
        are counted and surfaced in the result.

    The initial weights come from a `torch.Generator` on the device seeded
    with `seed` (not `jax.random`'s draws); a run continued from a
    reference checkpoint takes the reference's weights. `rules` goes to the
    train step; `shardings`, a `(mesh, {parameter name: spec})` pair
    (`parallel.specs.param_specs`), makes the parameters and moments
    DTensors on that mesh once they are built or restored (checkpoints stay
    mesh-agnostic: they hold the full tensors).
    """

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 opt_cfg: Optional[adamw.AdamWConfig] = None,
                 tcfg: TrainerConfig = TrainerConfig(), rules=NULL_RULES,
                 shardings=None, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.shape = shape
        self.tcfg = tcfg
        self.opt_cfg = opt_cfg or adamw.AdamWConfig(
            total_steps=tcfg.total_steps)
        self.data = SyntheticTokenSource(cfg, shape, seed=seed)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, tcfg.keep_last)
        self.step_times = []
        self.straggler_steps = 0
        self._preempted = False

        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        params = models.init_params(cfg, gen, self.device)
        opt_state = adamw.init(self.opt_cfg, dict(params.named_parameters()))
        self.start_step = 0

        if self.ckpt.latest_step() is not None:
            skel = _skeleton(params, cfg)
            target = {"params": skel,
                      "opt": adamw.OptState(0, skel, skel)}
            tree, extra, step = self.ckpt.restore(target)
            load_reference_(params, tree["params"], cfg)
            opt_state = opt_state_from_reference(tree["opt"], params, cfg)
            self.data.load_state_dict(extra["pipeline"])
            self.start_step = step
        if shardings is not None:
            mesh, specs = shardings
            distribute_params(params, specs, mesh)
            opt_state = adamw.OptState(
                opt_state.step, distribute_tensors(opt_state.mu, specs, mesh),
                distribute_tensors(opt_state.nu, specs, mesh))
        params.requires_grad_(True)
        self.state = {"params": params, "opt": opt_state}
        self._train_step = make_train_step(cfg, self.opt_cfg, rules)

    def _install_preemption_handler(self):
        def handler(signum, frame):
            self._preempted = True
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, handler)
            except ValueError:
                pass  # not in the main thread (tests)

    def _checkpoint(self, step: int, blocking: bool = True):
        state = {"params": params_to_reference(self.state["params"], self.cfg,
                                               numpy=False),
                 "opt": opt_state_to_reference(self.state["opt"], self.cfg,
                                               numpy=False)}
        self.ckpt.save(step, state,
                       extra={"pipeline": self.data.state_dict(),
                              "arch": self.cfg.name},
                       blocking=blocking)

    def run(self, num_steps: Optional[int] = None) -> Dict[str, Any]:
        self._install_preemption_handler()
        end = self.start_step + (num_steps or self.tcfg.total_steps)
        metrics = {}
        step = self.start_step
        losses = []
        while step < end:
            batch = batch_to(self.data.batch_at(step), self.device)
            t0 = time.perf_counter()
            params, opt, metrics = self._train_step(
                self.state["params"], self.state["opt"], batch)
            metrics = {k: float(v) for k, v in metrics.items()}  # syncs
            self.state = {"params": params, "opt": opt}
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            med = sorted(self.step_times)[len(self.step_times) // 2]
            if dt > self.tcfg.straggler_grace * med and len(
                    self.step_times) > 5:
                self.straggler_steps += 1
            step += 1
            self.data.state.step = step
            losses.append(metrics["loss"])
            if step % self.tcfg.ckpt_every == 0 or step == end:
                self._checkpoint(step, blocking=(step == end))
            if self._preempted:
                self._checkpoint(step, blocking=True)
                break
        self.ckpt.wait()
        return {"final_step": step, "last_metrics": metrics,
                "losses": losses, "straggler_steps": self.straggler_steps}
