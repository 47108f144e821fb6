"""Fault-tolerance policy (the port of `repro/train/fault_tolerance.py`;
the reference imports no JAX here, and the port keeps its own copy).

The control-plane logic; the mechanisms it relies on live elsewhere
(step-atomic checkpoints in `repro_torch.checkpoint`, the counter-based
data pipeline, the preemption hooks in `Trainer`). Policies:

  * Node failure: on restart `Trainer.__init__` restores the latest
    COMMITTED checkpoint and re-derives each batch from the step index —
    at most `ckpt_every` steps of work are repeated, no data is skipped or
    counted twice.
  * Preemption notice: SIGTERM -> synchronous checkpoint -> clean exit
    (`Trainer.run`).
  * Stragglers: per-step wall time against the running median; a worker
    over `grace x median` for `patience` consecutive steps is flagged
    (`HealthMonitor.stragglers`).
  * Elastic rescale: `recovery_plan` gives the largest mesh of the same
    axis names that the surviving chips hold, shrinking the data axes
    only. Checkpoints hold whole logical arrays, so a restore fits any
    mesh.
  * Silent data corruption: sha256 per array on save, verified on
    restore; gradient-norm spike detection (`HealthMonitor.check_step`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional


@dataclasses.dataclass
class HealthConfig:
    straggler_grace: float = 3.0      # x median step time
    straggler_patience: int = 5       # consecutive slow steps before action
    gradnorm_spike: float = 50.0      # x running mean -> suspect step
    heartbeat_timeout_s: float = 60.0


class HealthMonitor:
    """Tracks per-worker step timings + gradient norms, flags stragglers and
    suspect steps. On a real fleet, `report` is fed from each worker's
    heartbeat; here the Trainer feeds it locally."""

    def __init__(self, cfg: HealthConfig = HealthConfig()):
        self.cfg = cfg
        self.step_times: Dict[str, List[float]] = {}
        self.slow_streak: Dict[str, int] = {}
        self.last_heartbeat: Dict[str, float] = {}
        self.grad_norms: List[float] = []

    def report(self, worker: str, step_time: float,
               now: Optional[float] = None) -> None:
        self.step_times.setdefault(worker, []).append(step_time)
        self.last_heartbeat[worker] = now if now is not None else time.time()

    def _median_all(self) -> float:
        allt = sorted(t for ts in self.step_times.values() for t in ts)
        return allt[len(allt) // 2] if allt else 0.0

    def stragglers(self) -> List[str]:
        med = self._median_all()
        if med <= 0:
            return []
        out = []
        for w, ts in self.step_times.items():
            recent = ts[-self.cfg.straggler_patience:]
            slow = [t for t in recent if t > self.cfg.straggler_grace * med]
            if len(slow) >= self.cfg.straggler_patience:
                out.append(w)
        return out

    def dead_workers(self, now: Optional[float] = None) -> List[str]:
        now = now if now is not None else time.time()
        return [w for w, t in self.last_heartbeat.items()
                if now - t > self.cfg.heartbeat_timeout_s]

    def check_step(self, grad_norm: float) -> bool:
        """True if the step looks healthy (no gradient spike / NaN)."""
        import math
        if not math.isfinite(grad_norm):
            return False
        if self.grad_norms:
            mean = sum(self.grad_norms[-50:]) / len(self.grad_norms[-50:])
            if mean > 0 and grad_norm > self.cfg.gradnorm_spike * mean:
                return False
        self.grad_norms.append(grad_norm)
        return True


def recovery_plan(n_healthy: int, mesh_shape: Dict[str, int]
                  ) -> Dict[str, int]:
    """Largest mesh (same axis names) that fits the surviving chips:
    shrink the outermost data axis first (pure DP -> cheapest to resize),
    never the model axis (weights are laid out for it)."""
    plan = dict(mesh_shape)
    order = [a for a in ("pod", "data") if a in plan]
    while _size(plan) > n_healthy:
        for axis in order:
            if plan[axis] > 1:
                plan[axis] //= 2
                break
        else:
            raise RuntimeError("cannot shrink mesh below model axis")
    return plan


def _size(plan: Dict[str, int]) -> int:
    n = 1
    for v in plan.values():
        n *= v
    return n
