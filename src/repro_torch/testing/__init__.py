"""Deterministic test instrumentation (fault injection for the resilient
search runtime). Kept out of repro_torch.core so production imports never pay
for it."""
from .faults import FaultInjector, FaultSpec, inject, kill_schedule

__all__ = ["FaultInjector", "FaultSpec", "inject", "kill_schedule"]
