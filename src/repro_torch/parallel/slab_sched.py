"""Fault-tolerant parallel slab scheduler for the bound-guided BnB search (the
port of `repro.parallel.slab_sched`).

`core.search`'s `prune="bound"` drivers process the factorized space as a
best-first queue of mixed-radix slab batches. That queue is an
embarrassingly shardable work list (ROADMAP: "best-first order makes stale
incumbents merely suboptimal pruning, never incorrectness"), and this
module fans it out across a pool of worker executors — host threads that
launch the kernels on the search's device (every launch on the thread's
current stream, the device's default stream), but the queue/lease protocol
below is transport-agnostic, so a multi-host backend can slot in behind the
same `SlabScheduler` surface.

**Leases.** Every slab batch is taken under a lease with a heartbeat
deadline. A worker that misses its heartbeat — crash, hang, or injected
fault — has its lease expired and the batch *requeued*, so no part of the
space is ever silently dropped. Completion is idempotent and
first-wins-per-batch: a worker that dies *after* evaluating but *before*
reporting simply leaves the redo to win, while a worker whose lease was
force-expired (a simulated hang) may report *late* — whichever completion
lands first is applied, every other one is dropped and counted
(`SchedStats.n_late` / `n_dup`). Either way each batch's points are
accounted exactly once, and the run ends with an explicit
`LedgerRecorder`-style tiling assertion:
pruned ∪ evaluated (∪ requeued-and-redone) == the whole space.

**Merges.** Workers share the incumbent/frontier through a versioned,
monotone merge under one lock: the EDP incumbent merges
(EDP, flat-index)-lexicographically (`_merge_best_indexed` — strictly
lower EDP wins, exact ties to the lower index), the frontier through the
float64-exact `_merge_running_front`. Both are order-insensitive and
idempotent, which is what makes late/duplicate reports harmless. The
incumbent only ever *tightens*, and workers prune with the same
strict-dominance tests as the sequential driver, so a stale incumbent can
only under-prune — never kill the winner's (or a frontier member's) slab.

**Two modes.**

  * ``deterministic=True`` (default): the *existing* sequential drivers
    run unchanged, and the scheduler only fans each evaluation batch's
    leaves across the leased workers (`eval_edp` / `eval_pareto`),
    merging the per-part results on a fixed schedule. Because the
    per-point engine values are identical, per-part argmins resolve ties
    to the lowest flat index, and the cross-part merge is
    (EDP, index)-lexicographic, the fan-out is **byte-identical** to
    `workers=1` — winners, frontiers and the canonical counter set (see
    `canonical_counters`) — even when an injected fault forces a batch
    to be requeued and redone.
  * ``deterministic=False``: the probe/refine phases stay on the
    coordinator (they are what seeds a sound incumbent), then the
    refined survivor batches go into the queue at once and workers
    *steal* them best-first, re-pricing each batch against the live
    shared incumbent/frontier before evaluating. Merge order is
    schedule-dependent, so this mode pins "same winner/frontier after
    float64 exact verification, coverage-complete" instead of
    byte-identical counters.

**Faults & recovery.** Worker threads consult the campaign's
`repro_torch.testing.faults` injector at four sites — "lease", "heartbeat",
"merge", "report" — passing their worker id. "kill" kills exactly that
worker thread (its leases expire and requeue); "timeout" force-expires
the current lease (a simulated hang, exercising the late-completion
path); "raise" is a transient worker error (the lease is abandoned and
the batch requeued immediately). A pool whose workers have all died is
respawned up to `max_respawns` replacements; past that the coordinator
evaluates the remaining batches inline (the same engine on the same device),
so the search always terminates.

**Kernel failures are not worker faults.** A kernel launch that fails
(`kernels.dse_eval.KernelLaunchError`), a NaN block (`KernelNaN`), the card
out of memory, or the runtime's verdict on them (`LaunchExhausted`,
`NanDetected`, `QueryTimeout`) is handed to the coordinator, which raises it
where the sequential driver would have: a wave's failure reaches the
runtime's unit guard around the driver's batch evaluation (retries, and on
the CPU degradation and quarantine; on a card the search fails), and a
work-stealing batch is evaluated under that same guard inside the worker.
Only the scheduler's own injected faults requeue or kill.

**Runtime composition.** With `runtime=`, the deterministic mode
checkpoints through the unchanged sequential drivers (same fingerprints,
so a `workers=1` checkpoint resumes under `workers=4` and vice versa);
the async drivers snapshot {incumbent/frontier, the done-batch id set —
i.e. the queue + lease table, since not-done == requeued-on-resume —
and the counters} after every merge, through the same step-atomic layer.
`keep_ledger=True` and the serve warm-start path compose with both modes.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import threading
import time
from typing import Dict, Optional

import numpy as np

import torch

from ..core.runtime import (KillSearch, LaunchError, LaunchExhausted,
                            LaunchTimeout, NanDetected, QueryTimeout)
from ..kernels.dse_eval import KernelLaunchError, KernelNaN

# Default lease validity. In-process worker *crashes* are detected by
# thread-aliveness (immediate requeue); the wall-clock deadline only backs
# up real hangs, so it can be generous.
DEFAULT_LEASE_S = 30.0
# Coordinator wait-loop tick (lease reaping / deadline checks / respawn).
_TICK_S = 0.02

# Counters a deterministic parallel run must reproduce byte-identically.
# n_overflow is excluded: the pallas bounded-frontier overflow count
# depends on launch block boundaries, which legitimately shift when a
# batch is split across workers (the refined frontier is exact either
# way — the same reason n_overflow may differ across chunk_size).
CANONICAL_COUNTER_KEYS = ("n_evaluated", "n_feasible", "n_workload_evals",
                          "n_pruned", "n_bounds")

# What a worker hands to the coordinator instead of dying or requeueing: a
# kernel that failed or returned NaN, the card out of memory, and the
# runtime's verdicts on them (see "Kernel failures" above).
_QUERY_FAILURES = (KernelLaunchError, KernelNaN, torch.cuda.OutOfMemoryError,
                   LaunchExhausted, NanDetected, QueryTimeout)


def canonical_counters(result) -> Dict[str, int]:
    """The counter subset `deterministic=True` pins against `workers=1`."""
    return {k: int(getattr(result, k)) for k in CANONICAL_COUNTER_KEYS}


@dataclasses.dataclass
class SchedStats:
    """One parallel run's scheduler-level telemetry (on `result.sched`)."""

    workers: int
    deterministic: bool
    n_batches: int = 0      # work batches enqueued (incl. requeues)
    n_leases: int = 0       # leases granted
    n_requeued: int = 0     # lease expiries that requeued a batch
    n_late: int = 0         # completions whose lease had already expired
    n_dup: int = 0          # completions for an already-done batch
    n_deaths: int = 0       # worker threads lost to (injected) kills
    n_respawns: int = 0     # replacement workers started
    n_inline: int = 0       # batches the coordinator evaluated itself
    n_merges: int = 0       # first-completion merges applied
    merge_version: int = 0  # monotone shared-state version


class _Batch:
    """One leased unit of work: a (B, 5, 2) block of leaf slabs."""

    __slots__ = ("bid", "engine", "mode", "ranges", "lbs", "sizes",
                 "n_points", "run_rows", "requeues")

    def __init__(self, bid, engine, mode, ranges, lbs=None, run_rows=None):
        self.bid = bid
        self.engine = engine
        self.mode = mode  # "wave" (deterministic fan-out) | "sweep" (async)
        self.ranges = np.asarray(ranges, np.int64).reshape(-1, 5, 2)
        self.lbs = lbs
        widths = self.ranges[:, :, 1] - self.ranges[:, :, 0]
        self.sizes = widths.prod(axis=1)
        self.n_points = int(self.sizes.sum())
        self.run_rows = run_rows
        self.requeues = 0


class _Lease:
    """A worker's claim on one batch, valid until `deadline`."""

    __slots__ = ("lease_id", "bid", "worker", "deadline", "expired")

    def __init__(self, lease_id, bid, worker, deadline):
        self.lease_id = lease_id
        self.bid = bid
        self.worker = worker
        self.deadline = deadline
        self.expired = False


class SlabScheduler:
    """Leased work-queue + worker pool over one search's slab batches.

    The deterministic drivers use it as a drop-in batch evaluator
    (`eval_edp` / `eval_pareto`); the async drivers additionally seed the
    shared incumbent/frontier (`init_shared`) and hand it the whole
    refined survivor list (`run_sweep`). One instance serves one search.

    Batch ids: sweep batches use their best-first slice index (0, 1, …) —
    stable across runs, which is what lets a checkpoint's done-set skip
    them on resume — while wave batches allocate from `WAVE_BID_BASE`, a
    disjoint range, so a probe wave's completed bids can never shadow a
    sweep batch.
    """

    WAVE_BID_BASE = 1 << 40

    def __init__(self, fspace, wl, constraints, c, device, shard, chunk_size,
                 workers, *, objective="edp", objectives=None,
                 deterministic=True, rt=None, led=None):
        self.fspace = fspace
        self.wl = wl
        self.constraints = constraints
        self.c = c
        self.device = torch.device(device)
        self.shard = shard
        self.chunk_size = chunk_size
        self.workers = max(1, int(workers))
        self.objective = objective
        self.objectives = objectives
        self.rt = rt
        self.led = led
        # A pool may be replaced once over before the coordinator drains
        # the queue itself.
        self.max_respawns = self.workers
        self.stats = SchedStats(workers=self.workers,
                                deterministic=bool(deterministic))
        self.shared: dict = {}
        self._lock = threading.Lock()
        self._work_cv = threading.Condition(self._lock)
        self._done_cv = threading.Condition(self._lock)
        self._pending: collections.deque = collections.deque()
        self._batches: Dict[int, _Batch] = {}
        self._done: set = set()
        self._results: Dict[int, tuple] = {}
        self._leases: Dict[int, _Lease] = {}
        self._failure: Optional[BaseException] = None  # first query failure
        self._cancelled: set = set()
        self._threads: Dict[int, threading.Thread] = {}
        self._next_bid = self.WAVE_BID_BASE
        self._next_lease = 0
        self._next_wid = 0
        self._closed = False

    # ---- lifecycle ----

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self):
        """Stop the pool: wake every idle worker and let it exit."""
        with self._lock:
            self._closed = True
            self._work_cv.notify_all()
        for t in self._threads.values():
            t.join(timeout=1.0)

    def _spawn(self, replacement=False):
        wid = self._next_wid
        self._next_wid += 1
        t = threading.Thread(target=self._worker_loop, args=(wid,),
                             name=f"slab-worker-{wid}", daemon=True)
        self._threads[wid] = t
        if replacement:
            self.stats.n_respawns += 1
        t.start()

    def _ensure_pool(self):
        if not self._threads:
            for _ in range(self.workers):
                self._spawn()

    # ---- fault injection (worker sites) ----

    def _consult(self, site, wid, lease_id):
        """Fire the campaign injector at a worker site. "timeout" is
        interpreted as a missed heartbeat: the lease is force-expired
        (batch requeued) but the worker keeps going, so its completion
        arrives late — the duplicate-completion path. "raise"/"kill"
        propagate to the worker loop (transient abandon / worker death).
        """
        inj = self.rt.fault_injector if self.rt is not None else None
        if inj is None:
            return
        try:
            inj.fire(site, wid)
        except LaunchTimeout:
            self._force_expire(lease_id)

    # ---- queue / lease protocol ----

    def _enqueue(self, batches):
        with self._lock:
            for b in batches:
                self._batches[b.bid] = b
                self._pending.append(b.bid)
                self.stats.n_batches += 1
            self._work_cv.notify_all()
        self._ensure_pool()

    def _acquire(self, wid) -> Optional[tuple]:
        """Next pending batch under a fresh lease; None once closed."""
        with self._lock:
            while True:
                while self._pending and (self._pending[0] in self._done
                                         or self._pending[0]
                                         in self._cancelled):
                    self._pending.popleft()  # redo obsoleted by a late win
                if self._pending:
                    bid = self._pending.popleft()
                    lease = _Lease(self._next_lease, bid, wid,
                                   time.monotonic() + DEFAULT_LEASE_S)
                    self._next_lease += 1
                    self._leases[lease.lease_id] = lease
                    self.stats.n_leases += 1
                    return lease.lease_id, self._batches[bid]
                if self._closed:
                    return None
                self._work_cv.wait(timeout=_TICK_S)

    def _heartbeat(self, lease_id):
        with self._lock:
            lease = self._leases.get(lease_id)
            if lease is not None and not lease.expired:
                lease.deadline = time.monotonic() + DEFAULT_LEASE_S

    def _force_expire(self, lease_id):
        """Simulated missed heartbeat: requeue now, mark the lease dead."""
        with self._lock:
            self._expire_locked(lease_id)

    def _expire_locked(self, lease_id):
        lease = self._leases.pop(lease_id, None)
        if lease is None or lease.expired:
            return
        lease.expired = True
        if lease.bid not in self._done:
            self._batches[lease.bid].requeues += 1
            self._pending.appendleft(lease.bid)  # stolen work stays hot
            self.stats.n_requeued += 1
            self._work_cv.notify_all()

    def _abandon(self, lease_id):
        """Transient worker error: give the batch back immediately."""
        self._force_expire(lease_id)

    def _complete(self, lease_id, batch, report) -> bool:
        """First completion per batch wins — regardless of lease state, so
        a late report from a force-expired lease still counts if the redo
        has not landed yet. Everything else is dropped (idempotence)."""
        with self._lock:
            lease = self._leases.pop(lease_id, None)
            if lease is None or lease.expired:
                self.stats.n_late += 1
            if batch.bid in self._done or batch.bid in self._cancelled:
                self.stats.n_dup += 1
                self._done_cv.notify_all()
                return False
            self._apply_locked(batch, report)
            return True

    def _fail(self, lease_id, exc):
        """A query failure inside a worker (see "Kernel failures" in the
        module docstring): drop the lease without requeueing and hand the
        first such failure to the coordinator, which raises it."""
        with self._lock:
            self._leases.pop(lease_id, None)
            if self._failure is None:
                self._failure = exc
            self._done_cv.notify_all()

    def _raise_failure_locked(self, bids):
        """Re-raise a worker's query failure on the coordinator, cancelling
        the rest of the batches it was waiting for (in-flight completions
        of those are dropped as duplicates)."""
        exc, self._failure = self._failure, None
        for b in bids:
            if b not in self._done:
                self._cancelled.add(b)
            self._results.pop(b, None)
        raise exc

    def _apply_locked(self, batch, report):
        self._done.add(batch.bid)
        if batch.mode == "wave":
            self._results[batch.bid] = report
        else:
            self._merge_sweep_locked(batch, report)
        self.stats.n_merges += 1
        self.stats.merge_version += 1
        self._done_cv.notify_all()

    # ---- worker side ----

    def _worker_loop(self, wid):
        while True:
            job = self._acquire(wid)
            if job is None:
                return
            lease_id, batch = job
            try:
                self._consult("lease", wid, lease_id)
                self._process(wid, lease_id, batch)
            except LaunchError:
                self._abandon(lease_id)
            except _QUERY_FAILURES as e:
                self._fail(lease_id, e)
            except (KillSearch, BaseException):
                with self._lock:
                    self.stats.n_deaths += 1
                    self._expire_locked(lease_id)
                return

    def _process(self, wid, lease_id, batch):
        self._heartbeat(lease_id)
        self._consult("heartbeat", wid, lease_id)
        report = self._evaluate(batch)
        self._consult("report", wid, lease_id)
        self._consult("merge", wid, lease_id)
        self._complete(lease_id, batch, report)

    def _run_eval(self, engine, ranges, run_rows):
        """The sequential driver's batch evaluation of `ranges` on one
        engine (`_bnb_eval_edp` / `_bnb_eval_pareto`)."""
        from ..core.search import _bnb_eval_edp, _bnb_eval_pareto
        if self.objective == "edp":
            return _bnb_eval_edp(engine, self.fspace, self.wl,
                                 self.constraints, self.c, self.device,
                                 ranges, self.shard, self.chunk_size)
        return _bnb_eval_pareto(engine, self.fspace, self.wl,
                                self.constraints, self.c, self.device,
                                ranges, self.shard, self.chunk_size,
                                self.objectives, run_rows)

    def _evaluate(self, batch):
        if batch.mode == "wave":
            return self._run_eval(batch.engine, batch.ranges,
                                  batch.run_rows)
        return self._evaluate_sweep(batch)

    def _evaluate_sweep(self, batch):
        """Re-price one stolen batch against the live shared state, then
        evaluate whatever survives. The snapshot may be stale — the
        incumbent/frontier only tightens, so staleness means evaluating
        slabs a fresher view would have pruned, never pruning a slab
        that could hold the winner (a frontier member's slab corner is
        never strictly dominated)."""
        from ..core.search import _bnb_dominated_vs, _bnb_thunks
        run_rows = None
        with self._lock:
            if self.objective == "edp":
                inc = self.shared["inc"]
            else:
                pts = self.shared["pts"]
                run_rows = self.shared["rows"]
        if self.objective == "edp":
            live = np.asarray(batch.lbs["edp"]) <= inc
        else:
            live = ~_bnb_dominated_vs(pts, batch.lbs, self.objectives)
        if not live.any():
            return {"live": live, "eval": None}

        def run(eng):
            return self._run_eval(eng, batch.ranges[live], run_rows)

        # Under a runtime the stolen batch takes the unit guard the
        # sequential driver puts around each batch it evaluates.
        out = (run(batch.engine) if self.rt is None
               else self.rt.eval_unit(batch.engine, _bnb_thunks(run),
                                      self.device))
        return {"live": live, "eval": out}

    def _merge_sweep_locked(self, batch, report):
        """Apply one first-completion sweep report: ledger, counters, and
        the versioned monotone incumbent/frontier merge."""
        from ..core.search import (PTAConfig, _merge_best_indexed,
                                   _merge_running_front, calc_edp, eval_full)
        live = report["live"]
        dead_points = int(batch.sizes[~live].sum())
        live_points = batch.n_points - dead_points
        sh = self.shared
        sh["n_pruned"] += dead_points
        sh["n_eval"] += live_points
        if self.led is not None:
            if dead_points:
                self.led.prune(batch.ranges[~live],
                               {k: np.asarray(v)[~live]
                                for k, v in batch.lbs.items()})
            if live.any():
                self.led.evaluate(batch.ranges[live])
        if report["eval"] is None:
            return
        if self.objective == "edp":
            gi, e, f = report["eval"]
            sh["nf"] += f
            merged = _merge_best_indexed(sh["best"], (gi, e))
            if merged is not sh["best"]:
                sh["best"] = merged
                # The shared pruning incumbent is the winner's float64
                # reference EDP — same rule as the sequential driver, so
                # the final winner is exactly verified by construction.
                cfg = PTAConfig.from_array(
                    self.fspace.decode([merged[0]])[0])
                _, _, energy, latency = eval_full(cfg, self.wl, self.c)[:4]
                sh["inc"] = calc_edp(energy, latency)
        else:
            idx, f, o = report["eval"]
            sh["nf"] += f
            sh["n_over"] += o
            if len(idx):
                sh["rows"], sh["met"] = _merge_running_front(
                    sh["rows"], sh["met"], self.fspace.decode(idx),
                    self.wl, self.constraints, self.c, self.objectives)
                d = len(self.objectives)
                sh["pts"] = (np.stack([sh["met"][k]
                                       for k in self.objectives], axis=1)
                             if len(sh["rows"]) else np.zeros((0, d)))

    # ---- coordinator side ----

    def _live_workers_locked(self):
        return sum(t.is_alive() for t in self._threads.values())

    def _reap_locked(self):
        """Expire leases of dead workers and overdue heartbeats."""
        now = time.monotonic()
        for lease in list(self._leases.values()):
            t = self._threads.get(lease.worker)
            if (t is not None and not t.is_alive()) or now > lease.deadline:
                self._expire_locked(lease.lease_id)

    def _cutoff_locked(self):
        """Bulk-prune the pending tail once its best bound is dominated —
        the async analogue of the sequential sweep's sorted early-exit.
        Pending batches are in best-first bid order, so only the head
        needs checking each tick."""
        from ..core.search import _bnb_dominated_vs
        while self._pending:
            bid = self._pending[0]
            if bid in self._done or bid in self._cancelled:
                self._pending.popleft()
                continue
            batch = self._batches[bid]
            if batch.mode != "sweep":
                return
            if self.objective == "edp":
                if float(np.min(batch.lbs["edp"])) <= self.shared["inc"]:
                    return
                live = np.zeros(len(batch.ranges), dtype=bool)
            else:
                die = _bnb_dominated_vs(self.shared["pts"], batch.lbs,
                                        self.objectives)
                if not die.all():
                    return
                live = ~die
            self._pending.popleft()
            self._apply_locked(batch, {"live": live, "eval": None})

    def _wait(self, bids, on_progress=None):
        """Block until every bid in `bids` is done, reaping expired
        leases, bulk-pruning the dominated tail, respawning a fully-dead
        pool (up to `max_respawns`, then evaluating inline), checking the
        runtime deadline, and reporting progress after each new merge. A
        worker's query failure is raised here."""
        reported = -1
        inline = []
        while True:
            with self._lock:
                if self._failure is not None:
                    self._raise_failure_locked(bids)
                self._reap_locked()
                if self.shared:
                    self._cutoff_locked()
                n_done = len(self._done)
                remaining = [b for b in bids if b not in self._done]
                if not remaining:
                    return
                if (self._live_workers_locked() == 0 and self._pending):
                    if self._next_wid - self.workers < self.max_respawns:
                        self._spawn(replacement=True)
                    else:
                        inline = [self._pending.popleft()
                                  for _ in range(len(self._pending))]
                self._done_cv.wait(timeout=_TICK_S)
            if self.rt is not None:
                self.rt.check_deadline()
            if on_progress is not None and n_done != reported:
                reported = n_done
                on_progress()
            for bid in inline:
                self._run_inline(bid)
            inline = []

    def _run_inline(self, bid):
        """Last-resort forward progress: the coordinator evaluates a
        batch itself when the whole pool is gone and the respawn budget
        is spent. No lease — the coordinator cannot outlive itself."""
        with self._lock:
            if bid in self._done:
                return
            batch = self._batches[bid]
        report = self._evaluate(batch)
        with self._lock:
            if bid not in self._done:
                self.stats.n_inline += 1
                self._apply_locked(batch, report)

    # ---- deterministic fan-out (the drivers' executor surface) ----

    def _split(self, ranges):
        ranges = np.asarray(ranges, np.int64).reshape(-1, 5, 2)
        k = min(self.workers, len(ranges))
        return [p for p in np.array_split(ranges, max(k, 1)) if len(p)]

    def _run_wave(self, parts, engine, run_rows=None):
        batches = []
        with self._lock:
            for p in parts:
                batches.append(_Batch(self._next_bid, engine, "wave", p,
                                      run_rows=run_rows))
                self._next_bid += 1
        self._enqueue(batches)
        self._wait([b.bid for b in batches])
        with self._lock:
            return [self._results.pop(b.bid) for b in batches]

    def eval_edp(self, engine, ranges_list):
        """Drop-in for `_bnb_eval_edp`: split one batch across the leased
        workers, lex-merge the per-part argmins. Byte-identical to the
        sequential call — per-point values are equal, each part's argmin
        resolves ties to its lowest flat index (ascending index order
        inside `slab_indices_batch`), and `_merge_best_indexed` picks the
        globally lowest-index tie across parts, exactly like one big
        ascending sweep."""
        from ..core.search import _merge_best_indexed
        ranges = np.asarray(ranges_list, np.int64).reshape(-1, 5, 2)
        if len(ranges) == 0:
            return -1, float("inf"), 0
        best, nf = (-1, float("inf")), 0
        for gi, e, f in self._run_wave(self._split(ranges), engine):
            nf += f
            best = _merge_best_indexed(best, (gi, e))
        return best[0], best[1], nf

    def eval_pareto(self, engine, ranges_list, run_rows):
        """Drop-in for `_bnb_eval_pareto`: the per-part candidate sets
        are concatenated in part order (their union equals the
        sequential candidate set — disjoint index blocks), and the
        driver's float64 `_merge_running_front` refinement is
        order-insensitive, so the frontier is byte-identical."""
        ranges = np.asarray(ranges_list, np.int64).reshape(-1, 5, 2)
        if len(ranges) == 0:
            return np.zeros(0, np.int64), 0, 0
        outs = self._run_wave(self._split(ranges), engine,
                              run_rows=run_rows)
        idx = np.concatenate([np.asarray(o[0], np.int64) for o in outs]) \
            if outs else np.zeros(0, np.int64)
        nf = sum(o[1] for o in outs)
        n_over = sum(o[2] for o in outs)
        return idx, nf, n_over

    # ---- async sweep ----

    def init_shared(self, **state):
        """Seed the shared incumbent/frontier + counters before a sweep."""
        with self._lock:
            self.shared = dict(state)

    def shared_snapshot(self):
        """A consistent copy of the shared state (for checkpoints). The
        `done` set carries sweep bids only — wave bids are ephemeral
        (their results are consumed synchronously), sweep bids are the
        resumable queue + lease table: done == merged, everything else
        is requeued on resume."""
        with self._lock:
            snap = dict(self.shared)
            done = sorted(b for b in self._done if b < self.WAVE_BID_BASE)
            snap["done"] = np.asarray(done, np.int64)
        return snap

    def run_sweep(self, engine, ready, rlbs, done_bids=(),
                  on_progress=None):
        """Queue every refined survivor batch (best-first bid order) and
        block until the whole survivor set is accounted. `done_bids`
        skips batches a resumed checkpoint already merged."""
        from ..core.search import _bnb_batch_slices, _slab_sizes
        sizes = _slab_sizes(ready)
        done = set(int(b) for b in done_bids)
        batches = []
        for j, (s, e) in enumerate(_bnb_batch_slices(sizes)):
            if j in done:
                continue
            batches.append(_Batch(j, engine, "sweep", ready[s:e],
                                  lbs={k: np.asarray(v)[s:e]
                                       for k, v in rlbs.items()}))
        with self._lock:
            self._done.update(done)
        if batches:
            self._enqueue(batches)
            self._wait([b.bid for b in batches], on_progress=on_progress)


# ---------------------------------------------------------------------------
# Async drivers: sequential probe/refine, work-stealing sweep
# ---------------------------------------------------------------------------

def _async_probe(sched, rt, engine, evaluate_batch):
    """Run one probe batch through the wave fan-out, under the runtime's
    retry guard when attached (and, on the CPU only, its fallback and
    quarantine)."""
    if rt is None:
        return evaluate_batch(engine)
    return rt.eval_unit(engine, {
        eng: functools.partial(evaluate_batch, eng)
        for eng in ("numpy", "torch", "cuda")}, sched.device)


def _finish_accounting(fspace, stats, shared):
    """The tiling assertion: pruned ∪ evaluated covers the space exactly
    (requeued batches were redone, never dropped and never
    double-counted)."""
    total = stats["n_pruned"] + shared["n_eval"]
    assert total == fspace.size, (
        f"slab scheduler lost coverage: pruned + evaluated = {total} "
        f"!= |space| = {fspace.size}")


def _async_search_edp(fspace, wl, constraints, engine, c, device, shard,
                      chunk_size, workers, rt=None, led=None):
    """Async work-stealing min-EDP driver (see the module docstring for
    the soundness argument; structure mirrors
    `core.search._search_factorized_bnb`)."""
    from ..core.factorized import cached_bound_evaluator
    from ..core.search import (BNB_BATCH, BNB_FINE, BNB_LEAF,
                               PTAConfig, _bnb_batch_slices,
                               _bnb_descend, _bnb_frontier,
                               _bnb_infeasible_mask, _bnb_order,
                               _make_result, _merge_best_indexed,
                               _rt_fp, _slab_sizes, calc_edp,
                               eval_full)
    from ..core.runtime import decode_best_indexed, encode_best_indexed
    t0 = time.perf_counter()
    ev = cached_bound_evaluator(fspace, wl, c)
    stats = {"n_pruned": 0, "n_bounds": 0}
    state = {"inc": float("inf"), "best": (-1, float("inf")),
             "nf": 0, "n_eval": 0}
    fp = rec = None
    if rt is not None:
        fp = _rt_fp("edp_bnb_async", wl, constraints, engine, c, device,
                    shard, chunk_size, axes=fspace.axes, leaf=BNB_LEAF,
                    batch=BNB_BATCH, fine=BNB_FINE)
        rec = rt.resume(fp)
    unit = 0
    phase, probe_end = "probe", 0
    inc_refine = float("inf")
    done_bids = np.zeros(0, np.int64)
    if rec is not None:
        led = None  # the resumed process never sees the full partition
        unit, st, extra = rec
        leaves, lbs = _bnb_frontier(fspace, ev, constraints, c,
                                    {"n_pruned": 0, "n_bounds": 0})
        state["best"] = decode_best_indexed(st)
        state["inc"] = float(st["inc"][0])
        inc_refine = float(st["inc_refine"][0])
        done_bids = np.asarray(st.get("done", np.zeros(0)), np.int64)
        state["nf"] = int(extra["nf"])
        state["n_eval"] = int(extra["n_eval"])
        stats["n_pruned"] = int(extra["n_pruned"])
        stats["n_bounds"] = int(extra["n_bounds"])
        phase, probe_end = extra["phase"], int(extra["probe_end"])
    else:
        leaves, lbs = _bnb_frontier(fspace, ev, constraints, c, stats, led)
    resumed_sweep = phase == "sweep"

    sched = SlabScheduler(fspace, wl, constraints, c, device, shard,
                          chunk_size, workers, objective="edp",
                          deterministic=False, rt=rt, led=led)
    try:
        def snapshot(done=()):
            st = encode_best_indexed(state["best"])
            st["inc"] = np.asarray([state["inc"]], np.float64)
            st["inc_refine"] = np.asarray([inc_refine], np.float64)
            st["done"] = np.asarray(done, np.int64)
            rt.unit_done(fp, unit, st, {
                "nf": state["nf"], "n_eval": state["n_eval"],
                "n_pruned": stats["n_pruned"],
                "n_bounds": stats["n_bounds"], "phase": phase,
                "probe_end": probe_end})

        def probe_batch(ranges_list, n_points):
            if led is not None:
                led.evaluate(np.asarray(ranges_list,
                                        np.int64).reshape(-1, 5, 2))
            gi, e, f = _async_probe(
                sched, rt, engine,
                lambda eng: sched.eval_edp(eng, ranges_list))
            state["nf"] += f
            state["n_eval"] += n_points
            merged = _merge_best_indexed(state["best"], (gi, e))
            if merged is not state["best"]:
                state["best"] = merged
                cfg = PTAConfig.from_array(fspace.decode([merged[0]])[0])
                _, _, energy, latency = eval_full(cfg, wl, c)[:4]
                state["inc"] = calc_edp(energy, latency)

        order = _bnb_order(fspace, leaves, lbs)
        leaves = leaves[order]
        lbs = {k: v[order] for k, v in lbs.items()}
        sizes = _slab_sizes(leaves)
        slices = _bnb_batch_slices(sizes)
        bi = probe_end
        while (not resumed_sweep and bi < len(slices)
               and state["inc"] == float("inf")):
            s, e = slices[bi]
            probe_batch(leaves[s:e], int(sizes[s:e].sum()))
            bi += 1
            if rt is not None:
                probe_end = bi
                snapshot()
                unit += 1
        rs = slices[bi][0] if bi < len(slices) else len(leaves)

        if not resumed_sweep:
            inc_refine = state["inc"]
            refine_stats = stats
        else:
            refine_stats = {"n_pruned": 0, "n_bounds": 0}
        ready, rlbs = _bnb_descend(
            ev,
            lambda b: (_bnb_infeasible_mask(b, constraints)
                       | (np.asarray(b["edp"]) > inc_refine)),
            leaves[rs:], {k: v[rs:] for k, v in lbs.items()}, BNB_FINE,
            refine_stats, c, led)
        phase, probe_end = "sweep", bi
        order = _bnb_order(fspace, ready, rlbs)
        ready = ready[order]
        rlbs = {k: v[order] for k, v in rlbs.items()}

        sched.init_shared(best=state["best"], inc=state["inc"],
                          nf=state["nf"], n_eval=state["n_eval"],
                          n_pruned=0)

        def on_progress():
            if rt is None:
                return
            nonlocal unit
            snap = sched.shared_snapshot()
            state["best"] = snap["best"]
            state["inc"] = snap["inc"]
            state["nf"] = snap["nf"]
            state["n_eval"] = snap["n_eval"]
            stats["n_pruned"] = base_pruned + snap["n_pruned"]
            snapshot(done=snap["done"])
            unit += 1

        base_pruned = stats["n_pruned"]
        sched.run_sweep(engine, ready, rlbs, done_bids=done_bids,
                        on_progress=on_progress)
        snap = sched.shared_snapshot()
        state["best"] = snap["best"]
        state["nf"] = snap["nf"]
        state["n_eval"] = snap["n_eval"]
        stats["n_pruned"] = base_pruned + snap["n_pruned"]
        if rt is not None:
            phase = "done"
            snapshot(done=snap["done"])
            unit += 1
    finally:
        sched.close()

    if rec is None:
        _finish_accounting(fspace, stats, {"n_eval": state["n_eval"]})
    best = state["best"]
    row = fspace.decode([best[0]])[0] if best[0] >= 0 else None
    r = _make_result(row, state["nf"], wl, c, fspace.size, state["n_eval"],
                     time.perf_counter() - t0)
    r.n_pruned = stats["n_pruned"]
    r.n_bounds = stats["n_bounds"]
    if led is not None:
        r.ledger = led.build(fspace)
    r.sched = sched.stats
    return rt.annotate(r) if rt is not None else r


def _async_search_pareto(fspace, wl, constraints, engine, c, device,
                         objectives, shard, chunk_size, workers, rt=None,
                         led=None):
    """Async work-stealing frontier driver (mirrors
    `core.search._pareto_factorized_bnb`; slabs die only when their
    lower-bound corner is strictly dominated by a shared-frontier point,
    which stays sound under stale snapshots — see `_evaluate_sweep`)."""
    from ..core.factorized import cached_bound_evaluator
    from ..core.search import (BNB_BATCH, BNB_FINE, BNB_LEAF,
                               ParetoResult, REPORT_METRICS,
                               _bnb_batch_slices, _bnb_descend,
                               _bnb_dominated_vs, _bnb_frontier,
                               _bnb_infeasible_mask, _bnb_order,
                               _empty_run_state, _merge_running_front,
                               _pareto_from_rows, _rt_fp, _slab_sizes)
    from ..core.runtime import decode_front, encode_front
    t0 = time.perf_counter()
    d = len(objectives)
    ev = cached_bound_evaluator(fspace, wl, c)
    stats = {"n_pruned": 0, "n_bounds": 0}
    state = {"rows": _empty_run_state()[0], "met": _empty_run_state()[1],
             "pts": np.zeros((0, d)), "nf": 0, "n_eval": 0, "n_over": 0}
    fp = rec = None
    if rt is not None:
        fp = _rt_fp("pareto_bnb_async", wl, constraints, engine, c,
                    device, shard, chunk_size, axes=fspace.axes,
                    objectives=tuple(objectives), leaf=BNB_LEAF,
                    batch=BNB_BATCH, fine=BNB_FINE)
        rec = rt.resume(fp)
    unit = 0
    phase, probe_end = "probe", 0
    pts_refine = np.zeros((0, d))
    done_bids = np.zeros(0, np.int64)
    if rec is not None:
        led = None
        unit, st, extra = rec
        leaves, lbs = _bnb_frontier(fspace, ev, constraints, c,
                                    {"n_pruned": 0, "n_bounds": 0})
        state["rows"], state["met"] = decode_front(st, REPORT_METRICS)
        state["pts"] = (np.stack([state["met"][k] for k in objectives],
                                 axis=1) if len(state["rows"])
                        else np.zeros((0, d)))
        pts_refine = np.asarray(st["pts_refine"],
                                np.float64).reshape(-1, d)
        done_bids = np.asarray(st.get("done", np.zeros(0)), np.int64)
        state["nf"] = int(extra["nf"])
        state["n_eval"] = int(extra["n_eval"])
        state["n_over"] = int(extra["n_over"])
        stats["n_pruned"] = int(extra["n_pruned"])
        stats["n_bounds"] = int(extra["n_bounds"])
        phase, probe_end = extra["phase"], int(extra["probe_end"])
    else:
        leaves, lbs = _bnb_frontier(fspace, ev, constraints, c, stats, led)
    resumed_sweep = phase == "sweep"

    sched = SlabScheduler(fspace, wl, constraints, c, device, shard,
                          chunk_size, workers, objective="pareto",
                          objectives=objectives, deterministic=False,
                          rt=rt, led=led)
    try:
        def snapshot(done=()):
            st = encode_front(state["rows"], state["met"], REPORT_METRICS)
            st["pts_refine"] = np.asarray(pts_refine,
                                          np.float64).reshape(-1, d)
            st["done"] = np.asarray(done, np.int64)
            rt.unit_done(fp, unit, st, {
                "nf": state["nf"], "n_eval": state["n_eval"],
                "n_over": state["n_over"],
                "n_pruned": stats["n_pruned"],
                "n_bounds": stats["n_bounds"], "phase": phase,
                "probe_end": probe_end})

        def probe_batch(ranges_list, n_points):
            if led is not None:
                led.evaluate(np.asarray(ranges_list,
                                        np.int64).reshape(-1, 5, 2))
            idx, f, o = _async_probe(
                sched, rt, engine,
                lambda eng: sched.eval_pareto(eng, ranges_list,
                                              state["rows"]))
            state["nf"] += f
            state["n_eval"] += n_points
            state["n_over"] += o
            if len(idx):
                state["rows"], state["met"] = _merge_running_front(
                    state["rows"], state["met"], fspace.decode(idx), wl,
                    constraints, c, objectives)
                state["pts"] = (np.stack([state["met"][k]
                                          for k in objectives], axis=1)
                                if len(state["rows"])
                                else np.zeros((0, d)))

        order = _bnb_order(fspace, leaves, lbs, objectives)
        leaves = leaves[order]
        lbs = {k: v[order] for k, v in lbs.items()}
        sizes = _slab_sizes(leaves)
        slices = _bnb_batch_slices(sizes)
        bi = probe_end
        while (not resumed_sweep and bi < len(slices)
               and not len(state["pts"])):
            s, e = slices[bi]
            probe_batch(leaves[s:e], int(sizes[s:e].sum()))
            bi += 1
            if rt is not None:
                probe_end = bi
                snapshot()
                unit += 1
        rs = slices[bi][0] if bi < len(slices) else len(leaves)

        if not resumed_sweep:
            pts_refine = state["pts"]
            refine_stats = stats
        else:
            refine_stats = {"n_pruned": 0, "n_bounds": 0}
        ready, rlbs = _bnb_descend(
            ev,
            lambda b: (_bnb_infeasible_mask(b, constraints)
                       | _bnb_dominated_vs(pts_refine, b, objectives)),
            leaves[rs:], {k: v[rs:] for k, v in lbs.items()}, BNB_FINE,
            refine_stats, c, led)
        phase, probe_end = "sweep", bi
        order = _bnb_order(fspace, ready, rlbs, objectives)
        ready = ready[order]
        rlbs = {k: v[order] for k, v in rlbs.items()}

        sched.init_shared(rows=state["rows"], met=state["met"],
                          pts=state["pts"], nf=state["nf"],
                          n_eval=state["n_eval"], n_over=state["n_over"],
                          n_pruned=0)

        def on_progress():
            if rt is None:
                return
            nonlocal unit
            snap = sched.shared_snapshot()
            state["rows"], state["met"] = snap["rows"], snap["met"]
            state["nf"] = snap["nf"]
            state["n_eval"] = snap["n_eval"]
            state["n_over"] = snap["n_over"]
            stats["n_pruned"] = base_pruned + snap["n_pruned"]
            snapshot(done=snap["done"])
            unit += 1

        base_pruned = stats["n_pruned"]
        sched.run_sweep(engine, ready, rlbs, done_bids=done_bids,
                        on_progress=on_progress)
        snap = sched.shared_snapshot()
        state["rows"], state["met"] = snap["rows"], snap["met"]
        state["nf"] = snap["nf"]
        state["n_eval"] = snap["n_eval"]
        state["n_over"] = snap["n_over"]
        stats["n_pruned"] = base_pruned + snap["n_pruned"]
        if rt is not None:
            phase = "done"
            snapshot(done=snap["done"])
            unit += 1
    finally:
        sched.close()

    if rec is None:
        _finish_accounting(fspace, stats, {"n_eval": state["n_eval"]})
    front, met, _ = _pareto_from_rows(state["rows"], wl, constraints, c,
                                      objectives, m=state["met"])
    res = ParetoResult(front=front, metrics=met, objectives=objectives,
                       n_evaluated=fspace.size, n_feasible=state["nf"],
                       n_workload_evals=state["n_eval"],
                       wall_time_s=time.perf_counter() - t0,
                       n_pruned=stats["n_pruned"],
                       n_bounds=stats["n_bounds"],
                       n_overflow=state["n_over"])
    if led is not None:
        res.ledger = led.build(fspace)
    res.sched = sched.stats
    return rt.annotate(res) if rt is not None else res


# ---------------------------------------------------------------------------
# Entry point used by core.search._search_impl
# ---------------------------------------------------------------------------

def parallel_bnb(fspace, wl, constraints, engine, c, device, shard,
                 chunk_size, *, objective, metrics, workers, deterministic,
                 rt=None, led=None):
    """Run one bound-guided search across `workers` leased executors.

    deterministic=True fans the unchanged sequential drivers' batches out
    (byte-identical to workers=1); deterministic=False runs the
    work-stealing sweep (same winner/frontier after float64 exact
    verification, coverage-complete).
    """
    from ..core.search import (_pareto_factorized_bnb,
                               _search_factorized_bnb)
    if deterministic:
        sched = SlabScheduler(fspace, wl, constraints, c, device, shard,
                              chunk_size, workers, objective=objective,
                              objectives=metrics, deterministic=True,
                              rt=rt, led=led)
        with sched:
            if objective == "edp":
                res = _search_factorized_bnb(fspace, wl, constraints,
                                             engine, c, device, shard,
                                             chunk_size, rt, led,
                                             executor=sched)
            else:
                res = _pareto_factorized_bnb(fspace, wl, constraints,
                                             engine, c, device, metrics,
                                             shard, chunk_size, rt, led,
                                             executor=sched)
        res.sched = sched.stats
        return res
    if objective == "edp":
        return _async_search_edp(fspace, wl, constraints, engine, c,
                                 device, shard, chunk_size, workers,
                                 rt=rt, led=led)
    return _async_search_pareto(fspace, wl, constraints, engine, c,
                                device, metrics, shard, chunk_size, workers,
                                rt=rt, led=led)
