"""Resilient search runtime: checkpoint/resume, retry, degradation (the
port of `repro.core.runtime`).

Long searches — a 24^5 branch-and-bound run, a streamed scenario sweep —
outlive single processes: they get preempted, a kernel launch fails, a
metric block comes back NaN. This module is the control plane that makes
every engine-layer search mode (`core.search.search` / `search_workloads`)
survivable without ever changing its answer:

  * **checkpoint/resume** — the streamed / factorized / bound-guided
    drivers process their grid as a deterministic sequence of evaluation
    *units* (chunks, index spans, leaf-slab batches). After each unit the
    driver hands the runtime its cross-unit state (running argmin /
    frontier / BnB incumbent and counters); the runtime snapshots it
    through the step-atomic checkpoint layer (repro_torch.checkpoint: manifest +
    COMMITTED marker written last, sha256 per array, keep_last GC). A
    killed search re-run against the same checkpoint directory restores
    the last COMMITTED unit cursor and replays only the tail — and because
    every unit is deterministic and the cross-unit merges are exact, the
    resumed search returns **byte-identical** winners, frontiers and
    counters to the uninterrupted run, on every engine x objective x
    chunk_size combination (tests/test_torch_resilience.py pins this).
    At most `checkpoint_every` units of work are repeated; nothing is
    skipped or double-counted.
  * **retry, and degradation on the CPU only** — each unit evaluation is
    guarded: transient launch failures retry with bounded exponential
    backoff (`max_retries`, `backoff_base_s`); an optional per-launch
    watchdog (`timeout_s`) turns a hung launch into a retryable
    `LaunchTimeout`. Every retry is counted and surfaced on `SearchResult`
    / `ParetoResult`. Where the search runs on the CPU (`device="cpu"`), a
    unit that exhausts its retries falls down the reference's engine chain
    cuda -> torch -> numpy (the engines are byte-identical, so degradation
    never changes the result), counted as `n_fallbacks`. On a card there
    is no chain: a unit that exhausts its retries raises `LaunchExhausted`,
    so a query never completes on another engine than the one it asked
    for (the reference degrades there too; the port does not).
  * **numerical integrity** — unit results are scanned for NaN (injected
    or real; the kernel wrappers raise `kernels.dse_eval.KernelNaN` on a
    NaN block of kernel output). On the CPU a poisoned unit is quarantined
    and re-evaluated through the host float64 numpy path — the same
    "superset, then exact refine" soundness argument as the kernels'
    MAX_FRONT overflow fallback, except here the refinement *is* the
    reference model, so the answer is again unchanged. On a card a
    poisoned unit raises `NanDetected`: the query fails rather than being
    re-priced on the host.
  * **fault injection** — `repro_torch.testing.faults` installs a seeded,
    deterministic `FaultInjector` on a runtime; the guard consults it at
    named sites ("launch" before each evaluation attempt, "checkpoint"
    after each committed snapshot), so CI can kill, fail, hang or poison a
    search at exact, reproducible points.

The runtime holds no search semantics: drivers own their state encoding
(core.search), kernels their launch surfaces (kernels.ops); this module
only sequences, guards and persists.

On the card every unit thunk of the cuda and torch engines ends in a copy
of its result to the host, so an attempt returns only once its launches
have finished: the watchdog (`timeout_s`) times the launch itself, not its
enqueueing, and a launch that fails asynchronously fails its own attempt.
"""
from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
import time
from concurrent import futures
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

log = logging.getLogger("repro_torch.runtime")

# Engine degradation order of a search on the CPU: every entry is
# byte-identical to the engine it replaces (the engine-layer contract), so
# falling down the chain trades speed for survival, never correctness. On
# a card no engine has a fallback (`eval_unit`).
FALLBACK_CHAIN: Dict[str, Tuple[str, ...]] = {
    "cuda": ("torch", "numpy"),
    "torch": ("numpy",),
}


class SearchFault(Exception):
    """Base of the runtime's fault taxonomy."""


class LaunchError(SearchFault):
    """A unit evaluation failed (kernel launch error, injected failure)."""


class LaunchTimeout(SearchFault):
    """A unit evaluation exceeded the watchdog timeout."""


class LaunchExhausted(SearchFault):
    """A unit evaluation failed every retry on one engine."""


class NanDetected(SearchFault):
    """A unit result contained NaN — quarantine and re-evaluate."""


class CheckpointMismatch(SearchFault):
    """A checkpoint directory holds state for a *different* search."""


class QueryTimeout(SearchFault):
    """A search exceeded its `RuntimePolicy.deadline_s` budget.

    Raised at a unit (or scheduler merge) boundary, so the campaign stops
    cleanly: no thread is interrupted mid-launch, checkpoints already
    committed stay durable, and a service can keep answering other
    queries. `query_name` carries the originating query's workload name
    when the serve layer set one."""

    def __init__(self, message: str, query_name: Optional[str] = None):
        super().__init__(message)
        self.query_name = query_name


class KillSearch(BaseException):
    """Injected process death. Derives from BaseException so no guard in
    the retry/fallback machinery can swallow it — it must propagate out of
    search() exactly like a real SIGKILL ends the process."""


def _retryable_exceptions() -> tuple:
    """Exception types the per-launch retry treats as transient: the
    runtime's own, a hand-written kernel's failed launch
    (`kernels.dse_eval.KernelLaunchError`) and the card running out of
    memory. A bare RuntimeError is never retried — it is how programming
    errors surface.

    A sticky CUDA error (an illegal address, say) poisons the process's
    CUDA context: every later launch fails too, so the unit's retries fail
    in turn and it raises `LaunchExhausted` — on a card there is no engine
    to fall back to. (The reference ends such a unit on numpy.)"""
    import torch

    from ..kernels.dse_eval import KernelLaunchError
    return (LaunchError, LaunchTimeout, KernelLaunchError,
            torch.cuda.OutOfMemoryError)


@dataclasses.dataclass(frozen=True)
class RuntimePolicy:
    """Resilience knobs for one search campaign.

    checkpoint_dir: step-atomic snapshot directory (None disables
      checkpointing — retries/fallback/quarantine still apply).
    checkpoint_every: snapshot every N completed evaluation units. At most
      this many units are re-executed after a kill.
    keep_last: committed snapshots retained (older ones are GC'd).
    max_retries: retries per engine per unit after the first attempt.
    backoff_base_s / backoff_cap_s: bounded exponential backoff between
      retries (base * 2^attempt, capped).
    timeout_s: per-launch watchdog; None disables it (a process's first
      cuda launch builds the kernels with nvcc, which takes seconds to
      minutes — only set a timeout when launch times are known).
    deadline_s: whole-campaign budget measured from the runtime's
      construction; checked cooperatively at every unit boundary (and at
      every scheduler merge boundary), raising `QueryTimeout` once
      exceeded. None disables it. Unlike `timeout_s` this bounds the
      *search*, not one launch — it is how `SearchService.submit(...,
      deadline_s=)` cancels a runaway query without hanging the batch.
    sleep: injectable sleep (tests pass a recorder to keep backoff
      deterministic and instant).
    """

    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1
    keep_last: int = 3
    max_retries: int = 2
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    timeout_s: Optional[float] = None
    deadline_s: Optional[float] = None
    sleep: Callable[[float], None] = time.sleep

    def __post_init__(self):
        if self.checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got "
                             f"{self.checkpoint_every}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got "
                             f"{self.max_retries}")
        if self.deadline_s is not None and self.deadline_s < 0:
            raise ValueError(f"deadline_s must be >= 0, got "
                             f"{self.deadline_s}")


COUNTER_KEYS = ("n_retries", "n_fallbacks", "n_quarantined", "n_checkpoints")


def _has_nan(out) -> bool:
    """True if any float leaf of a (possibly nested) unit result is NaN.

    +/-inf is *legitimate* unit output (an infeasible chunk's best EDP), so
    only NaN counts as poison. Integer arrays can't be poisoned. Takes
    numpy arrays and scalars and torch tensors (on any device).
    """
    if out is None:
        return False
    if isinstance(out, (tuple, list)):
        return any(_has_nan(x) for x in out)
    if isinstance(out, dict):
        return any(_has_nan(v) for v in out.values())
    if isinstance(out, float):
        return out != out
    if isinstance(out, np.ndarray):
        return out.dtype.kind == "f" and bool(np.isnan(out).any())
    if isinstance(out, np.floating):
        return bool(np.isnan(out))
    if isinstance(out, torch.Tensor):
        return out.is_floating_point() and bool(torch.isnan(out).any())
    return False


def _poisoned(out):
    """Replace every float leaf with NaN (the injected-NaN-block shape):
    the result still has the structure the driver expects, but the
    integrity scan must catch it."""
    if isinstance(out, tuple):
        return tuple(_poisoned(x) for x in out)
    if isinstance(out, list):
        return [_poisoned(x) for x in out]
    if isinstance(out, dict):
        return {k: _poisoned(v) for k, v in out.items()}
    if isinstance(out, float) or isinstance(out, np.floating):
        return float("nan")
    if isinstance(out, np.ndarray) and out.dtype.kind == "f":
        return np.full_like(out, np.nan)
    if isinstance(out, torch.Tensor) and out.is_floating_point():
        return torch.full_like(out, float("nan"))
    return out


def fingerprint(**fields) -> str:
    """Order-independent digest of a search signature. A checkpoint
    directory is bound to one exact search (workload, grid/space,
    constraints, engine, objective, streaming shape, constants); resuming
    anything else raises CheckpointMismatch instead of silently merging
    incompatible state."""
    h = hashlib.sha256()
    for k in sorted(fields):
        v = fields[k]
        h.update(k.encode())
        if isinstance(v, np.ndarray):
            h.update(str(v.dtype).encode())
            h.update(str(v.shape).encode())
            h.update(np.ascontiguousarray(v).tobytes())
        else:
            h.update(repr(v).encode())
        h.update(b";")
    return h.hexdigest()


def query_checkpoint_dir(root: str, query_fp: str, create: bool = True
                         ) -> str:
    """Service-owned checkpoint directory for one query fingerprint.

    A standing `repro_torch.serve.SearchService` runs many long searches under
    one `checkpoint_root`; each query gets its own subdirectory named by
    (a prefix of) its canonical fingerprint, so a restarted service
    resumes exactly the queries that were in flight — the checkpoint
    layer's manifest binding then re-verifies the full fingerprint, so a
    prefix collision degrades to `CheckpointMismatch`, never to silently
    merged state."""
    path = os.path.join(root, query_fp[:24])
    if create:
        os.makedirs(path, exist_ok=True)
    return path


def query_policy(root: str, query_fp: str, **overrides) -> RuntimePolicy:
    """A `RuntimePolicy` whose checkpoints live in the service-owned
    per-query directory (`query_checkpoint_dir`); `overrides` pass through
    to the policy (retries, watchdog, deadline, ...)."""
    return RuntimePolicy(
        checkpoint_dir=query_checkpoint_dir(root, query_fp), **overrides)


def _query_dir_fingerprint(path: str) -> Optional[str]:
    """The full search fingerprint a per-query checkpoint dir is bound to
    (from its latest COMMITTED manifest), '' when the dir has no committed
    step yet (an orphaned cold start), or None when the dir is not a
    checkpoint directory of ours at all (unreadable / foreign layout)."""
    import json
    try:
        steps = sorted(
            int(n[len("step_"):-len(".COMMITTED")])
            for n in os.listdir(path)
            if n.startswith("step_") and n.endswith(".COMMITTED"))
    except OSError:
        return None
    if not steps:
        # No committed step: ours only if it is empty or holds nothing
        # but step debris (an interrupted first snapshot).
        try:
            entries = os.listdir(path)
        except OSError:
            return None
        if all(e.startswith(("step_", "tmp_", ".")) for e in entries):
            return ""
        return None
    try:
        with open(os.path.join(path, f"step_{steps[-1]:06d}",
                               "manifest.json")) as fh:
            manifest = json.load(fh)
    except (OSError, ValueError):
        return None
    fp = manifest.get("extra", {}).get("fingerprint")
    return fp if isinstance(fp, str) else None


def gc_checkpoints(root: str, keep: int = 0,
                   known: Sequence[str] = ()) -> list:
    """Prune stale per-query checkpoint directories under `root`.

    A long-lived service accretes one `query_checkpoint_dir` per distinct
    query signature; completed queries never clean up after themselves
    (their snapshots are what make a restarted service resume). This
    reclaims that space: every direct subdirectory of `root` whose name
    is a fingerprint prefix *and* whose latest committed manifest carries
    a search-fingerprint binding is GC-eligible. (The dir is named by the
    *query* fingerprint while the manifest records the *search*
    fingerprint — two different digests, so the check is layout-shaped,
    not a prefix match: a directory without our committed-manifest
    structure belongs to someone else and is skipped, never deleted.)
    Directories with no committed step (orphaned cold starts) are
    eligible too, and rank oldest.

    The `keep` most recently modified eligible directories survive, as
    does any whose name is in `known` (a service passes the fingerprints
    of queries still in flight). Returns the removed paths.
    """
    import shutil
    if keep < 0:
        raise ValueError(f"keep must be >= 0, got {keep}")
    known = {k[:24] for k in known}
    eligible = []
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return []
    for name in names:
        path = os.path.join(root, name)
        if not os.path.isdir(path) or name in known:
            continue
        if len(name) != 24 or not all(ch in "0123456789abcdef"
                                      for ch in name):
            continue  # not a query_checkpoint_dir name: foreign, skip
        fp = _query_dir_fingerprint(path)
        if fp is None:
            log.warning("gc_checkpoints: %r does not verify as a "
                        "per-query checkpoint dir; skipping", path)
            continue
        eligible.append((os.path.getmtime(path), path))
    eligible.sort(reverse=True)  # newest first
    removed = []
    for _, path in eligible[keep:]:
        shutil.rmtree(path)
        removed.append(path)
    return removed


class SearchRuntime:
    """One resilient search campaign: counters, guard, checkpoint cursor.

    Pass an instance (or a bare RuntimePolicy) as `search(..., runtime=)`.
    Counters accumulate across everything the runtime guards and are
    copied onto the returned result.
    """

    def __init__(self, policy: Optional[RuntimePolicy] = None):
        self.policy = policy or RuntimePolicy()
        self.counters = {k: 0 for k in COUNTER_KEYS}
        self.resumed_step = 0
        self.fault_injector = None  # set by repro_torch.testing.faults.inject
        self.query_name = None  # set by the serve layer for QueryTimeout
        self.started = time.monotonic()
        self._ckpt = None
        self._retryable = _retryable_exceptions()
        self._pool = None

    @staticmethod
    def of(runtime) -> "SearchRuntime":
        """Coerce a user-facing runtime= argument (policy or runtime)."""
        if isinstance(runtime, SearchRuntime):
            return runtime
        if isinstance(runtime, RuntimePolicy):
            return SearchRuntime(runtime)
        raise TypeError(f"runtime= expects a RuntimePolicy or "
                        f"SearchRuntime, got {type(runtime).__name__}")

    # ---- fault injection ----

    def _consult(self, site: str) -> bool:
        """Fire the fault injector at a named site. Returns True when the
        injector asks for a poisoned (NaN) result; raises for injected
        failures/timeouts/kills."""
        inj = self.fault_injector
        if inj is None:
            return False
        return bool(inj.fire(site))

    # ---- deadline ----

    def check_deadline(self):
        """Raise `QueryTimeout` once the campaign has outlived
        `policy.deadline_s` (measured from runtime construction). Called
        at every unit boundary and at every scheduler merge boundary —
        cooperative cancellation, so the abort always lands between
        units, never inside one."""
        d = self.policy.deadline_s
        if d is None:
            return
        elapsed = time.monotonic() - self.started
        if elapsed >= d:
            raise QueryTimeout(
                f"search exceeded its {d:g}s deadline "
                f"({elapsed:.3f}s elapsed)", query_name=self.query_name)

    # ---- guarded evaluation ----

    def _call(self, thunk):
        """One attempt, under the watchdog when configured. The worker
        thread of a timed-out launch cannot be killed — it is abandoned
        (documented limitation of in-process watchdogs); the retry runs
        alongside it."""
        t = self.policy.timeout_s
        if t is None:
            return thunk()
        if self._pool is None:
            self._pool = futures.ThreadPoolExecutor(max_workers=2)
        fut = self._pool.submit(thunk)
        try:
            return fut.result(timeout=t)
        except futures.TimeoutError:
            raise LaunchTimeout(f"launch exceeded {t}s watchdog") from None

    def _attempts(self, thunk):
        """Retry one engine's unit evaluation with bounded exponential
        backoff. Returns (result, poisoned); raises LaunchExhausted when
        every attempt failed."""
        from ..kernels.dse_eval import KernelNaN
        p = self.policy
        last = None
        for attempt in range(p.max_retries + 1):
            try:
                poison = self._consult("launch")
                out = self._call(thunk)
                return (_poisoned(out), True) if poison else (out, False)
            except KernelNaN:
                # A kernel's output block held NaN: not a transient failure
                # (retrying replays the same numerics) — hand the unit
                # straight to quarantine.
                return None, True
            except self._retryable as e:
                last = e
                self.counters["n_retries"] += 1
                if attempt < p.max_retries:
                    p.sleep(min(p.backoff_base_s * (2 ** attempt),
                                p.backoff_cap_s))
        raise LaunchExhausted(
            f"unit failed after {p.max_retries + 1} attempts") from last

    def eval_unit(self, engine: str, thunks: Mapping[str, Callable],
                  device: torch.device):
        """Evaluate one unit resiliently.

        thunks: byte-identical evaluation alternatives keyed by engine
        name; `engine` is tried first. On the CPU its `FALLBACK_CHAIN`
        follows, and a NaN-poisoned result quarantines to thunks["numpy"],
        the host float64 re-evaluation. On a card (`device` not the CPU)
        only `engine` runs: exhausted retries raise `LaunchExhausted` and a
        poisoned result raises `NanDetected`.
        """
        self.check_deadline()
        on_card = torch.device(device).type != "cpu"
        chain = [engine] + ([] if on_card else
                            [e for e in FALLBACK_CHAIN.get(engine, ())
                             if e in thunks])
        last = None
        for pos, eng in enumerate(chain):
            try:
                out, poisoned = self._attempts(thunks[eng])
            except LaunchExhausted as e:
                last = e
                if pos + 1 < len(chain):
                    self.counters["n_fallbacks"] += 1
                    log.warning("engine %r exhausted retries; degrading "
                                "to %r", eng, chain[pos + 1])
                continue
            if poisoned or _has_nan(out):
                if on_card:
                    raise NanDetected(f"NaN in a unit result of the {eng!r} "
                                      f"engine on {device}")
                self.counters["n_quarantined"] += 1
                log.warning("NaN in unit result (engine %r); quarantining "
                            "to host float64 re-evaluation", eng)
                if "numpy" not in thunks:
                    raise NanDetected("poisoned unit and no host float64 "
                                      "refinement available")
                return thunks["numpy"]()
            return out
        raise last

    # ---- checkpoint cursor ----

    def _manager(self):
        if self._ckpt is None and self.policy.checkpoint_dir:
            from ..checkpoint.checkpointing import CheckpointManager
            self._ckpt = CheckpointManager(self.policy.checkpoint_dir,
                                           keep_last=self.policy.keep_last)
        return self._ckpt

    def resume(self, fp: str):
        """Latest committed (unit_count, state, extra) for fingerprint
        `fp`, or None on a cold start. state arrays come back as host
        numpy arrays; the runtime's counters are restored from the
        snapshot (work before the cursor is never re-counted)."""
        mgr = self._manager()
        if mgr is None:
            return None
        step = mgr.latest_step()
        if step is None:
            return None
        # The state tree's key set is search-mode-specific; recover it
        # from the manifest so restore() can rebuild any driver's state.
        import json
        with open(os.path.join(mgr.dir, f"step_{step:06d}",
                               "manifest.json")) as fh:
            manifest = json.load(fh)
        extra = manifest.get("extra", {})
        if extra.get("fingerprint") != fp:
            raise CheckpointMismatch(
                f"checkpoint directory {self.policy.checkpoint_dir!r} "
                f"belongs to a different search (fingerprint mismatch); "
                f"use a fresh directory per search signature")
        target = {leaf["path"]: np.zeros(0) for leaf in manifest["leaves"]}
        # host=True: float64 numpy state, exactly as it was saved (the
        # resume is byte-identical only if nothing narrows it).
        tree, extra, step = mgr.restore(target, step=step, host=True)
        state = {k: np.asarray(v) for k, v in tree.items()}
        for k in COUNTER_KEYS:
            self.counters[k] = int(extra.get("counters", {}).get(k, 0))
        self.resumed_step = step
        log.info("resumed search at unit %d from %r", step,
                 self.policy.checkpoint_dir)
        return step, state, extra

    def unit_done(self, fp: str, unit: int, state: Mapping[str, np.ndarray],
                  scalars: Optional[Mapping] = None):
        """Mark evaluation unit `unit` (0-based) complete; snapshot at the
        configured interval. The saved step is the number of *completed*
        units, so resume() re-enters at exactly the first unit whose work
        is not in the snapshot. Consults the fault injector's "checkpoint"
        site after a commit — the kill-at-every-boundary tests hook here.

        Saves are asynchronous (the manager's single writer thread
        serializes them and the COMMITTED marker keeps each step
        crash-atomic), so the snapshot I/O overlaps the next unit's
        compute — this is what keeps checkpointing overhead in the noise
        on BnB-scale units. flush() drains the writer; `search` calls it
        on every exit so a returned (or injection-killed) search always
        has its last snapshot durable.
        """
        mgr = self._manager()
        if mgr is None:
            return
        if (unit + 1) % self.policy.checkpoint_every:
            return
        # Count this snapshot *before* capturing the counters: the
        # restored counter set must equal the uninterrupted run's at the
        # same cursor, and that run has taken this checkpoint too.
        self.counters["n_checkpoints"] += 1
        extra = {"fingerprint": fp, "unit": unit + 1,
                 "counters": dict(self.counters)}
        if scalars:
            extra.update(scalars)
        # Copy the leaves: the async writer must not race a driver that
        # reuses its running-state buffers for the next unit.
        mgr.save(unit + 1, {k: np.array(v) for k, v in state.items()},
                 extra=extra, blocking=False)
        self._consult("checkpoint")

    def flush(self):
        """Drain any in-flight snapshot write (no-op without one)."""
        if self._ckpt is not None:
            self._ckpt.wait()

    # ---- result surfacing ----

    def annotate(self, result):
        """Copy the campaign counters onto a SearchResult/ParetoResult."""
        for k in COUNTER_KEYS:
            setattr(result, k, self.counters[k])
        result.resumed_step = self.resumed_step
        return result


# ---------------------------------------------------------------------------
# Driver state codecs: the cross-unit state each search mode carries,
# encoded as flat {name: array} trees for the checkpoint layer. Scalars
# ride in float64/int64 arrays (exact round-trip); None-ness is encoded
# in array length so every leaf always exists.
# ---------------------------------------------------------------------------

def encode_best_row(best) -> Dict[str, np.ndarray]:
    """(row-or-None, edp) running argmin of the streamed EDP driver."""
    row, edp = best
    return {"best_row": (np.zeros(0, np.int64) if row is None
                         else np.asarray(row, np.int64).reshape(5)),
            "best_edp": np.asarray([edp], np.float64)}


def decode_best_row(state) -> tuple:
    """Inverse of `encode_best_row`."""
    row = state["best_row"]
    return (None if row.size == 0 else row.astype(np.int64),
            float(state["best_edp"][0]))


def encode_best_indexed(best) -> Dict[str, np.ndarray]:
    """(global index or -1, edp) running argmin of the factorized drivers."""
    gi, edp = best
    return {"best_gi": np.asarray([gi], np.int64),
            "best_edp": np.asarray([edp], np.float64)}


def decode_best_indexed(state) -> tuple:
    """Inverse of `encode_best_indexed`."""
    return int(state["best_gi"][0]), float(state["best_edp"][0])


def encode_front(rows: np.ndarray, met: Mapping[str, np.ndarray],
                 metric_keys: Sequence[str]) -> Dict[str, np.ndarray]:
    """Bounded running frontier (rows + reference-model metric columns)."""
    out = {"front_rows": np.asarray(rows, np.int64).reshape(-1, 5)}
    for k in metric_keys:
        out[f"met_{k}"] = np.asarray(met[k], np.float64)
    return out


def decode_front(state, metric_keys: Sequence[str]) -> tuple:
    """Inverse of `encode_front`."""
    rows = np.asarray(state["front_rows"], np.int64).reshape(-1, 5)
    met = {k: np.asarray(state[f"met_{k}"], np.float64)
           for k in metric_keys}
    return rows, met
