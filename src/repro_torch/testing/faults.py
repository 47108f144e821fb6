"""Deterministic fault injection for the resilient search runtime (the port
of `repro.testing.faults`).

The runtime (core.runtime.SearchRuntime) consults its injector at named
sites:

  * ``"launch"``     — before every unit-evaluation *attempt* (so a retry
                       consults again and a one-shot fault is naturally
                       absorbed by the retry loop);
  * ``"checkpoint"`` — immediately after every COMMITTED snapshot (the
                       kill-at-every-boundary tests hook here).

The reference's parallel slab scheduler consults four more sites from
inside its worker threads, each passing its worker id (the port's
scheduler is ROADMAP Queue 1 item 13; the sites and the per-worker
counters are kept so schedules mean the same in both packages):

  * ``"lease"``     — right after a worker acquires a slab lease;
  * ``"heartbeat"`` — at every lease heartbeat;
  * ``"merge"``     — before a completed slab's result is merged;
  * ``"report"``    — after evaluating but before reporting a slab (the
                      duplicate-completion boundary).

A `FaultSpec` names a site, a fault kind and the 0-based invocation index
at which it fires (``at=-1`` fires on *every* invocation — persistent
failure, used to exhaust a unit's retries). A spec may additionally pin a
``worker`` id: it then matches against that worker's own per-site
invocation counter, so "kill worker 2 at its first lease" is expressible
regardless of how the pool interleaves. Kinds:

  * ``"raise"``   — raises LaunchError (transient launch failure);
  * ``"timeout"`` — raises LaunchTimeout (watchdog expiry, without the
                    wall-clock wait; the scheduler interprets it as a
                    missed heartbeat and force-expires the lease);
  * ``"nan"``     — poisons the attempt's result with NaN (the runtime
                    quarantines and re-evaluates on the host);
  * ``"kill"``    — raises KillSearch (BaseException: simulated process
                    death; propagates through every guard — the scheduler
                    lets it kill exactly the one worker thread).

Everything is a pure function of the spec list — no RNG at fire time — so
a schedule replays identically across runs, which is what lets the
kill/resume tests assert byte-identity. `kill_schedule(seed, ...)` derives
a seeded random schedule for the hypothesis-style matrix tests.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..core.runtime import KillSearch, LaunchError, LaunchTimeout

SITES = ("launch", "checkpoint", "lease", "heartbeat", "merge", "report")
KINDS = ("raise", "timeout", "nan", "kill")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: fire `kind` at invocation `at` of `site`
    (0-based; -1 = every invocation). `worker` pins the spec to one
    worker's own per-site counter (None matches the global counter)."""
    site: str
    kind: str
    at: int = 0
    worker: Optional[int] = None

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown site {self.site!r}; one of {SITES}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown kind {self.kind!r}; one of {KINDS}")


class FaultInjector:
    """Replays a FaultSpec schedule against per-site invocation counters.

    `fire(site, worker=None)` is called by the runtime (and, with a
    worker id, by the slab scheduler's worker threads); it returns True
    when the current invocation is scheduled to produce a NaN-poisoned
    result, and raises for the failure kinds. `hits` records every fault
    actually fired (site, kind, invocation) for assertions. Counters are
    lock-guarded: scheduler workers fire concurrently.
    """

    def __init__(self, specs: Iterable[FaultSpec] = ()):
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        # Counts only sites actually consulted — an injector that never
        # saw a "lease" call reports no "lease" key at all.
        self.calls: Dict[str, int] = {}
        self.worker_calls: Dict[Tuple[str, int], int] = {}
        self.hits: List[Tuple[str, str, int]] = []
        self._lock = threading.Lock()

    def fire(self, site: str, worker: Optional[int] = None) -> bool:
        with self._lock:
            idx = self.calls.get(site, 0)
            self.calls[site] = idx + 1
            widx = None
            if worker is not None:
                widx = self.worker_calls.get((site, worker), 0)
                self.worker_calls[(site, worker)] = widx + 1
            poison = False
            matched = None
            for spec in self.specs:
                if spec.site != site:
                    continue
                if spec.worker is None:
                    at_idx = idx
                elif spec.worker == worker:
                    at_idx = widx
                else:
                    continue
                if spec.at != -1 and spec.at != at_idx:
                    continue
                self.hits.append((site, spec.kind, at_idx))
                if spec.kind == "nan":
                    poison = True
                else:
                    matched = (spec.kind, at_idx)
                    break  # first failure spec wins, as before the lock
        if matched is not None:
            kind, at_idx = matched
            if kind == "raise":
                raise LaunchError(f"injected launch failure "
                                  f"({site}#{at_idx})")
            if kind == "timeout":
                raise LaunchTimeout(f"injected watchdog expiry "
                                    f"({site}#{at_idx})")
            raise KillSearch(f"injected process death ({site}#{at_idx})")
        return poison


def kill_schedule(seed: int, n_boundaries: int, n_launches: int,
                  max_faults: int = 3) -> List[FaultSpec]:
    """Seeded schedule for the fault matrix: a few transient faults at
    random launch attempts, ending in a kill at a random site/index.
    Deterministic in `seed` — the same seed always produces the same
    schedule (the byte-identity tests rely on replaying it)."""
    rng = np.random.default_rng(seed)
    specs: List[FaultSpec] = []
    for _ in range(int(rng.integers(0, max_faults))):
        kind = ("raise", "timeout", "nan")[int(rng.integers(0, 3))]
        specs.append(FaultSpec("launch", kind,
                               int(rng.integers(0, max(1, n_launches)))))
    if rng.integers(0, 2) and n_boundaries > 0:
        specs.append(FaultSpec("checkpoint", "kill",
                               int(rng.integers(0, n_boundaries))))
    else:
        specs.append(FaultSpec("launch", "kill",
                               int(rng.integers(0, max(1, n_launches)))))
    return specs


@contextlib.contextmanager
def inject(runtime, specs: Sequence[FaultSpec]):
    """Install a fresh FaultInjector on `runtime` for the duration of the
    block; yields the injector (inspect `.hits` afterwards)."""
    inj = FaultInjector(specs)
    prev = runtime.fault_injector
    runtime.fault_injector = inj
    try:
        yield inj
    finally:
        runtime.fault_injector = prev
