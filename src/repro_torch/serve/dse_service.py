"""The resident co-search service (the port of `repro.serve.dse_service`).

A `SearchService` is one long-lived process answering many (workload,
constraint-box) questions. It is built on three observations about the
engine layer:

  1. **Everything expensive is reusable.** The CUDA kernels are built
     once per process; `FactorizedSpace` factor tables and
     `SlabBoundEvaluator` dyadic-interval tables key on frozen dataclasses
     (`core.factorized.cached_bound_evaluator`); the decode kernels' axis
     operand stays resident on the card per space. A standing service
     pays each of these once.
  2. **Answers are canonical.** Every engine x (shard, chunk_size)
     combination returns byte-identical winners/frontiers, so a memo
     keyed on the canonicalized (workload fingerprint, constraint box,
     space, objective) — `serve.cache` — can return the stored result
     object for any respelling of the same question.
  3. **Tightened boxes are incremental.** A bound-guided search that kept
     its `SlabLedger` has already priced every slab it pruned. Under a
     tightened box C' of the original box B, constraint-pruned slabs stay
     dead (their lower bound beat B's limit, and C' only lowers limits)
     and the evaluated region's feasible-under-C' points are exactly the
     stored points inside C'. Only objective-pruned slabs whose stored
     lower bounds *straddle* the new incumbent/frontier can hide a better
     answer — the service re-prices the ledger in one vectorized compare,
     seeds the BnB driver with the best stored points (`WarmStart`), and
     descends only the revived slabs. The result is byte-identical to a
     cold `search()` under C' because the stored bounds are admissible
     and the seeds are true achievable values.

Queries run synchronously: `query()` answers one question,
`submit()`/`drain()` queue several and coalesce the cold ones into
multi-workload batched calls (`serve.batching`).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import time
from typing import Dict, List, Mapping, Optional, Union

import numpy as np

from .._device import resolve_device
from ..core.arch_params import Constraints
from ..core.factorized import (FactorizedSpace, SlabLedger,
                               factorized_evaluate_grid)
from ..core.photonic_model import CONSTANTS, DeviceConstants
from ..core.runtime import (QueryTimeout, RuntimePolicy, SearchRuntime,
                            fingerprint, query_policy)
from ..core.search import (DEFAULT_OBJECTIVES, ParetoResult, SearchResult,
                           WarmStart, _bnb_dominated_vs,
                           _bnb_infeasible_mask, _check_engine,
                           _check_pareto_metrics, _measure_band,
                           _pareto_factorized_bnb, _pareto_from_rows,
                           _resolve_robust, _search_factorized_bnb, search,
                           search_workloads)
from ..core.workload import Workload

from .batching import QueryBatcher, ServeQuery
from .cache import (Box, base_key, box_constraints, box_contains,
                    canonical_box, query_key, workload_key)

log = logging.getLogger("repro_torch.serve")

Result = Union[SearchResult, ParetoResult]


@dataclasses.dataclass
class _BaseEntry:
    """The box-independent warm-start substrate of one (workload,
    objective) pair: the cold search's slab ledger plus the float64
    reference metrics of every point it evaluated. Any later box inside
    `box` is answerable by re-pricing this entry."""

    box: Box                         # the box the ledger was priced under
    ledger: SlabLedger
    idx: np.ndarray                  # (E,) flat indices of evaluated points
    rows: np.ndarray                 # (E, 5) their decoded config rows
    met: Dict[str, np.ndarray]       # {metric: (E,) float64} reference vals
    nbytes: int = 0                  # ledger npz size (the LRU budget unit)


class SearchService:
    """Persistent DSE server: memoized, batched, warm-started searches.

    Construction fixes the *space side* of every query — the factorized
    product space, the engine, the device, the device constants and the
    sharding/streaming shape — because those are what the resident caches
    key on.
    The *question side* (workload, constraint box, objective) arrives per
    query.

    Args:
      space: candidate sets of the product space (anything
        `FactorizedSpace.from_space` accepts); defaults to the full
        `1..n_z` space.
      n_z: per-axis candidate count of the default space.
      engine: cuda (default) | torch | numpy — all byte-identical; the
        engine only decides where evaluation runs.
      device: "cuda" (default; raises at construction without a card,
        whatever the engine — the service never carries on without the
        card unless asked) or "cpu" (the kernels' plain PyTorch versions).
      shard / chunk_size: forwarded to every cold, warm, batched and worker
        search (see `search`): `shard=N` fans each evaluation out over up
        to N cards of the candidate mesh.
      checkpoint_root: when set, every cold search runs under a
        `core.runtime` policy checkpointing into a service-owned
        per-query-fingerprint directory (`runtime.query_checkpoint_dir`),
        so a restarted service resumes in-flight queries. A query that
        actually resumed returns no ledger, so it seeds no warm-start
        entry — correctness never depends on the checkpoint history.
      c: device constants of the photonic model.
      calibration: a `core.calibration.CalibratedConstants` (or a
        `{field: interval}` mapping, or a preset name) — the service's
        calibration uncertainty. Mutually exclusive with a non-default
        `c=`. Without `robust=`, searches run at `calibration.nominal()`;
        every answer carries its uncertainty band on ``result.band``.
      robust: "worst_case" makes the whole service robust: every cold
        search, warm constraint-delta, and memoized answer is priced at
        the calibration's certified worst corner (see `core.search` —
        the warm ledger re-pricing stays sound because the stored bounds
        were built at the same corner the deltas re-price at).
        Calibrations with uncertified varying fields are rejected here:
        the service's warm path needs the worst-corner reduction.
      max_bases / max_ledger_bytes: bound the resident warm-start memory
        — the number of `_BaseEntry` substrates and their total ledger
        byte size (each accounted at its exact `SlabLedger.nbytes()` npz
        round-trip). When either budget is exceeded the least recently
        *used* base entries are evicted (`stats["evicted_bases"]`); an
        evicted base only downgrades its successors from warm to cold —
        answers never change, because the memo of exact results is
        separate and every cold search is self-contained.
      workers / deterministic: fan every cold search's slab queue out
        across the leased parallel scheduler
        (`repro_torch.parallel.slab_sched`, worker threads launching on
        `device`), and run warm constraint-deltas through the same worker
        fan-out. Answers stay byte-identical (deterministic mode) or
        exactly-verified-identical (async) to a single-executor service,
        per `core.search.search(workers=)`.

    The constants fingerprint (`constants_fingerprint`) joins every memo
    / base key and therefore the per-query checkpoint directories —
    services over different constants, calibrations, or robust modes
    never share answers, ledgers, or snapshots.

    Every returned result is byte-identical (winners/frontiers) to the
    equivalent cold `core.search.search` call; only wall-time and
    delta-work counters differ on warm paths. `stats` counts how each
    query was served (memo / warm / cold / batched).
    """

    def __init__(self, *, space=None, n_z: int = 12, engine: str = "cuda",
                 device=None, shard: Optional[int] = None,
                 chunk_size: Optional[int] = None,
                 checkpoint_root: Optional[str] = None,
                 c: DeviceConstants = CONSTANTS,
                 calibration=None, robust: Optional[str] = None,
                 max_bases: Optional[int] = None,
                 max_ledger_bytes: Optional[int] = None,
                 workers: Optional[int] = None,
                 deterministic: bool = True):
        self.device = resolve_device(device)
        _check_engine(engine)
        self.space = (FactorizedSpace.full(n_z) if space is None
                      else FactorizedSpace.from_space(space))
        self.engine = engine
        self.shard = shard
        self.chunk_size = chunk_size
        self.checkpoint_root = checkpoint_root
        c, cal, fallback = _resolve_robust(calibration, robust, c, engine)
        if fallback:
            raise ValueError(
                "this calibration has uncertified varying fields "
                f"({cal.unresolved()}): SearchService's warm-start path "
                "requires the certified worst-corner reduction — certify "
                "the field directions (core.calibration.MONOTONE)")
        self.c = c
        self.calibration = cal
        self.robust = robust
        if max_bases is not None and max_bases < 0:
            raise ValueError("max_bases= must be >= 0")
        if max_ledger_bytes is not None and max_ledger_bytes < 0:
            raise ValueError("max_ledger_bytes= must be >= 0")
        self.max_bases = max_bases
        self.max_ledger_bytes = max_ledger_bytes
        self.workers = workers
        self.deterministic = deterministic
        self._memo: Dict[str, Result] = {}
        self._base: "collections.OrderedDict[str, _BaseEntry]" = \
            collections.OrderedDict()
        self._base_bytes = 0
        self._queue = QueryBatcher()
        self.stats = {"queries": 0, "memo_hits": 0, "warm": 0, "cold": 0,
                      "batched_calls": 0, "slabs_repriced": 0,
                      "slabs_revived": 0, "evicted_bases": 0,
                      "timeouts": 0}
        # Frozen-dataclass reprs are deterministic and carry every field,
        # so this digest changes whenever the priced cost model does —
        # including the exact constants corner `robust=` resolved to.
        self._cfp = fingerprint(c=repr(self.c),
                                calibration=repr(self.calibration),
                                robust=self.robust or "")

    @property
    def constants_fingerprint(self) -> str:
        """Digest of the cost model this service prices — the resolved
        `DeviceConstants` (post calibration/robust resolution) plus the
        calibration and robust mode. Joins every memo/base key and the
        per-query checkpoint directories."""
        return self._cfp

    # -- public surface ----------------------------------------------------

    def query(self, wl: Workload,
              constraints: Union[Constraints, Mapping] = Constraints(), *,
              objective: str = "edp",
              pareto_metrics: Optional[tuple] = None) -> Result:
        """Answer one question, via memo, warm delta, or cold search.

        Identical questions return the *identical* result object (memo
        hit). A question whose box tightens a previously answered one is
        served by re-pricing that answer's slab ledger (warm). Everything
        else is a cold bound-guided `search` that seeds the memo and the
        warm-start substrate for its successors.
        """
        q = ServeQuery(wl=wl, constraints=box_constraints(
            canonical_box(constraints)), objective=objective,
            pareto_metrics=pareto_metrics)
        self.stats["queries"] += 1
        res = self._serve_memo_or_warm(q)
        if res is None:
            res = self._serve_cold_one(q)
        return res

    def submit(self, wl: Workload,
               constraints: Union[Constraints, Mapping] = Constraints(), *,
               objective: str = "edp",
               pareto_metrics: Optional[tuple] = None,
               deadline_s: Optional[float] = None) -> None:
        """Queue a question for the next `drain()` (FIFO).

        `deadline_s` gives the query a wall-clock budget: a cold search
        that outlives it is cancelled cooperatively (at a unit/merge
        boundary — the in-flight wave unwinds cleanly, worker pools and
        checkpoints included) and surfaces as a typed
        `core.runtime.QueryTimeout` in that query's `drain()` slot
        instead of hanging the batch. Memo/warm answers ignore the
        deadline (they cost microseconds), and deadline queries are
        never coalesced into a shared batched launch.
        """
        if deadline_s is not None and deadline_s < 0:
            raise ValueError("deadline_s= must be >= 0")
        self._queue.put(ServeQuery(wl=wl, constraints=box_constraints(
            canonical_box(constraints)), objective=objective,
            pareto_metrics=pareto_metrics, deadline_s=deadline_s))

    def drain(self) -> List[Union[Result, QueryTimeout]]:
        """Answer every queued question, in arrival order.

        Memo hits and warm deltas are peeled off individually (they cost
        microseconds); the remaining cold queries are coalesced by
        `QueryBatcher.group` into as few multi-workload
        `search_workloads` calls as their (objective, metrics, name)
        signatures allow — under the bound-guided driver each workload
        still runs its own search, sharing every resident table and the
        built kernels.

        A query submitted with `deadline_s=` that exceeds its budget
        returns the raised `QueryTimeout` (carrying ``query_name``) in
        its slot — the rest of the batch completes normally, so the
        caller gets every completed result plus the timed-out names.
        """
        queries = self._queue.take()
        out: Dict[int, Union[Result, QueryTimeout]] = {}
        cold: List[tuple] = []  # (position, query)
        seen: Dict[str, int] = {}  # mkey -> first cold position
        for pos, q in enumerate(queries):
            self.stats["queries"] += 1
            res = self._serve_memo_or_warm(q)
            if res is not None:
                out[pos] = res
                continue
            if q.deadline_s is not None:
                # Deadline queries run their own cancellable campaign
                # immediately — a shared wave has no per-member abort.
                try:
                    out[pos] = self._serve_cold_one(q)
                except QueryTimeout as e:
                    self.stats["timeouts"] += 1
                    out[pos] = e
                continue
            mkey = self._keys(q)[1]
            if mkey in seen:  # duplicate within this drain: one search
                self.stats["memo_hits"] += 1
            else:
                seen[mkey] = pos
                cold.append((pos, q))
        if self.checkpoint_root is not None:
            # Checkpointed colds run one campaign per query fingerprint;
            # batching would fold them into per-name directories instead.
            for pos, q in cold:
                out[pos] = self._serve_cold_one(q)
        else:
            for sig, wave in QueryBatcher.group([q for _, q in cold]):
                self._serve_cold_wave(sig, wave)
                self.stats["batched_calls"] += 1
        for pos, q in enumerate(queries):
            if pos not in out:
                out[pos] = self._memo[self._keys(q)[1]]
        return [out[i] for i in range(len(queries))]

    @staticmethod
    def timed_out(results) -> List[str]:
        """The timed-out query names in a `drain()` return value."""
        return [r.query_name for r in results
                if isinstance(r, QueryTimeout)]

    def stats_delta(self, before: Mapping[str, int]) -> Dict[str, int]:
        """Counter increments since a ``dict(service.stats)`` snapshot —
        how a span of queries (e.g. one scenario sweep) was
        served, independent of the service's earlier history."""
        return {k: v - int(before.get(k, 0)) for k, v in self.stats.items()}

    # -- internals ---------------------------------------------------------

    def _metrics(self, q: ServeQuery) -> Optional[tuple]:
        if q.objective != "pareto":
            return None
        return _check_pareto_metrics(self.engine,
                                     q.pareto_metrics or DEFAULT_OBJECTIVES)

    def _keys(self, q: ServeQuery):
        wkey = workload_key(q.wl)
        metrics = self._metrics(q)
        return (wkey,
                query_key(wkey, q.box, self.space.axes, q.objective,
                          metrics, constants=self._cfp),
                base_key(wkey, self.space.axes, q.objective, metrics,
                         constants=self._cfp))

    def _serve_memo_or_warm(self, q: ServeQuery) -> Optional[Result]:
        _, mkey, bkey = self._keys(q)
        if mkey in self._memo:
            self.stats["memo_hits"] += 1
            return self._memo[mkey]
        base = self._base.get(bkey)
        if base is not None and box_contains(base.box, q.box):
            self._base.move_to_end(bkey)  # LRU touch: this base just served
            res = self._delta(base, q)
            self.stats["warm"] += 1
            self._memo[mkey] = res
            return res
        return None

    def _cold_kwargs(self, mkey: str) -> dict:
        kw = dict(engine=self.engine, c=self.c, device=self.device,
                  objective="edp", shard=self.shard,
                  chunk_size=self.chunk_size,
                  factorized=True, space=self.space, prune="bound",
                  keep_ledger=True)
        if self.workers is not None:
            kw["workers"] = self.workers
            kw["deterministic"] = self.deterministic
        if self.checkpoint_root is not None:
            kw["runtime"] = query_policy(self.checkpoint_root, mkey)
        return kw

    def _serve_cold_one(self, q: ServeQuery) -> Result:
        _, mkey, bkey = self._keys(q)
        kw = self._cold_kwargs(mkey)
        kw["objective"] = q.objective
        if q.objective == "pareto":
            kw["pareto_metrics"] = self._metrics(q)
        if q.deadline_s is not None:
            pol = kw.pop("runtime", None)
            pol = (dataclasses.replace(pol, deadline_s=q.deadline_s)
                   if pol is not None
                   else RuntimePolicy(deadline_s=q.deadline_s))
            rt = SearchRuntime(pol)
            rt.query_name = q.wl.name
            kw["runtime"] = rt
        res = search(q.wl, q.constraints, **kw)
        self._finish_cold(q, bkey, mkey, res)
        return res

    def _serve_cold_wave(self, sig, wave: List[ServeQuery]) -> None:
        objective, metrics = sig
        kw = self._cold_kwargs("")
        kw.pop("runtime", None)
        kw["objective"] = objective
        if objective == "pareto":
            # The wave signature carries the metrics as *submitted*; a
            # None (defaulted) tuple still needs the same normalization
            # `query()` applies, or the batched call would crash where
            # the one-at-a-time path succeeds.
            kw["pareto_metrics"] = metrics or self._metrics(wave[0])
        wls = {q.wl.name: q.wl for q in wave}
        cons = {q.wl.name: q.constraints for q in wave}
        results = search_workloads(wls, cons, **kw)
        for q in wave:
            _, mkey, bkey = self._keys(q)
            self._finish_cold(q, bkey, mkey, results[q.wl.name])

    def _finish_cold(self, q: ServeQuery, bkey: str, mkey: str,
                     res: Result) -> None:
        self.stats["cold"] += 1
        if self.calibration is not None:
            res.band = _measure_band(res, self.calibration, q.wl)
        self._memo[mkey] = res
        ledger = res.ledger
        if ledger is None:
            return  # resumed-from-checkpoint run: no complete partition
        prior = self._base.get(bkey)
        if prior is not None and not box_contains(q.box, prior.box):
            # The standing entry covers boxes this one would not; keep it.
            return
        idx = ledger.evaluated_indices()
        met = factorized_evaluate_grid(self.space, q.wl, self.c, idx=idx)
        prior = self._base.pop(bkey, None)
        if prior is not None:
            self._base_bytes -= prior.nbytes
        entry = _BaseEntry(
            box=q.box, ledger=ledger, idx=idx,
            rows=self.space.decode(idx),
            met={k: np.asarray(v, np.float64) for k, v in met.items()},
            nbytes=ledger.nbytes())
        self._base[bkey] = entry
        self._base_bytes += entry.nbytes
        self._evict_bases()

    def _evict_bases(self) -> None:
        """Evict least-recently-used base entries until both budgets hold.

        Eviction is availability, not correctness: a dropped base only
        means the next tightened-box query runs cold (and re-seeds the
        entry) instead of warm — the memo of exact results is untouched.
        """
        while self._base and (
                (self.max_bases is not None
                 and len(self._base) > self.max_bases)
                or (self.max_ledger_bytes is not None
                    and self._base_bytes > self.max_ledger_bytes)):
            bkey, entry = self._base.popitem(last=False)
            self._base_bytes -= entry.nbytes
            self.stats["evicted_bases"] += 1
            log.debug("evicted base %s (%d bytes; %d bases / %d bytes "
                      "resident)", bkey[:12], entry.nbytes,
                      len(self._base), self._base_bytes)

    def _maybe_executor(self, wl, cons, objective, metrics):
        """A leased worker fan-out for one warm delta, or a None context.

        Warm deltas always use the *deterministic* wave fan-out even on
        an async-configured service: the async drivers own their whole
        probe/refine/sweep schedule and have no warm-start entry point,
        and a delta's revived-slab descent is small enough that the
        byte-identical wave split is the right tool anyway.
        """
        if self.workers is None:
            return contextlib.nullcontext(None)
        from ..parallel.slab_sched import SlabScheduler
        return SlabScheduler(self.space, wl, cons, self.c, self.device,
                             self.shard, self.chunk_size, self.workers,
                             objective=objective, objectives=metrics,
                             deterministic=True)

    def _delta(self, base: _BaseEntry, q: ServeQuery) -> Result:
        """Warm constraint-delta answer: filter the point store, re-price
        the pruned slabs, descend only the revived ones."""
        t0 = time.perf_counter()
        cons = q.constraints
        dead = _bnb_infeasible_mask(base.ledger.bounds, cons)
        if q.objective == "edp":
            m = base.met
            ok = np.asarray(cons.satisfied(m["area"], m["power"],
                                           m["energy"], m["latency"]))
            gidx, edp = base.idx[ok], m["edp"][ok]
            if len(gidx):
                k = np.lexsort((gidx, edp))[0]
                best = (int(gidx[k]), float(edp[k]))
                dead |= np.asarray(base.ledger.bounds["edp"]) > best[1]
            else:
                best = (-1, float("inf"))
            warm = WarmStart(
                start=base.ledger.pruned[~dead],
                lbs={k2: v[~dead]
                     for k2, v in base.ledger.bounds.items()},
                best=best, nf=int(ok.sum()))
            with self._maybe_executor(q.wl, cons, "edp", None) as ex:
                res = _search_factorized_bnb(
                    self.space, q.wl, cons, self.engine, self.c,
                    self.device, self.shard, self.chunk_size, warm=warm,
                    executor=ex)
        else:
            metrics = self._metrics(q)
            front, met, nf = _pareto_from_rows(base.rows, q.wl, cons,
                                               self.c, metrics, m=base.met)
            pts = (np.stack([met[k] for k in metrics], axis=1)
                   if len(front) else np.zeros((0, len(metrics))))
            dead |= _bnb_dominated_vs(pts, base.ledger.bounds, metrics)
            warm = WarmStart(
                start=base.ledger.pruned[~dead],
                lbs={k2: v[~dead]
                     for k2, v in base.ledger.bounds.items()},
                rows=front, met=met, nf=nf)
            with self._maybe_executor(q.wl, cons, "pareto", metrics) as ex:
                res = _pareto_factorized_bnb(
                    self.space, q.wl, cons, self.engine, self.c,
                    self.device, metrics, self.shard, self.chunk_size,
                    warm=warm, executor=ex)
        if self.calibration is not None:
            res.band = _measure_band(res, self.calibration, q.wl)
        self.stats["slabs_repriced"] += len(base.ledger.pruned)
        self.stats["slabs_revived"] += int((~dead).sum())
        log.debug("delta query served warm in %.3fms: %d/%d slabs revived",
                  (time.perf_counter() - t0) * 1e3, int((~dead).sum()),
                  len(base.ledger.pruned))
        return res
