"""Request queue and batcher for the search service (the port of
`repro.serve.batching`).

Concurrent queries rarely deserve one launch each: the engine layer
already answers W workloads under W different constraint boxes in a
*single* fused multi-workload launch (`core.search.search_workloads`,
whose constraints travel as a dynamic `(W, 4)` operand of one cuda
launch).
The batcher's job is to coalesce the queue into as few such calls as
possible without changing any answer:

  * queries already memoized or eligible for the warm constraint-delta
    path are peeled off first (they cost microseconds each — batching
    them would only delay them);
  * the remaining cold queries are grouped by (objective, metric tuple)
    — the only axes `search_workloads` cannot vary within one call —
    and each group becomes one batched call;
  * within a group, workload *names* must be unique (they key the
    batched result dict), so duplicate names are split into successive
    waves rather than renamed — a renamed workload would fingerprint
    differently and poison the memo.

The batcher is synchronous and deterministic: `drain()` processes the
queue in arrival order and returns results in arrival order, which is
what makes the service's batched path testable against the sequential
path byte-for-byte.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from ..core.arch_params import Constraints
from ..core.workload import Workload

from .cache import Box, canonical_box


@dataclasses.dataclass(frozen=True)
class ServeQuery:
    """One queued question: a workload under a constraint box.

    `objective` / `pareto_metrics` follow `core.search.search`;
    `pareto_metrics` is ignored (and excluded from the memo key) in
    "edp" mode. `deadline_s` is a per-query wall-clock budget: a cold
    search past it raises `core.runtime.QueryTimeout` (cooperatively, at
    a unit/merge boundary). Deadline queries are never coalesced into a
    batched wave — a shared launch has no per-member cancellation — so
    the field stays out of the wave signature by construction.
    """

    wl: Workload
    constraints: Constraints
    objective: str = "edp"
    pareto_metrics: Optional[tuple] = None
    deadline_s: Optional[float] = None

    @property
    def box(self) -> Box:
        """The query's canonical constraint box."""
        return canonical_box(self.constraints)


class QueryBatcher:
    """Order-preserving queue that coalesces cold queries into waves.

    `group(queries)` partitions a list of cold queries into *waves*: each
    wave maps one (objective, metrics) group with pairwise-distinct
    workload names onto a single `search_workloads` call. The partition
    is greedy in arrival order, so the first occurrence of every name
    lands in the earliest possible wave and results stay reproducible.
    """

    def __init__(self):
        self._pending: List[ServeQuery] = []

    def put(self, query: ServeQuery) -> None:
        """Enqueue a query (FIFO)."""
        self._pending.append(query)

    def take(self) -> List[ServeQuery]:
        """Drain and return the queue in arrival order."""
        out, self._pending = self._pending, []
        return out

    def __len__(self) -> int:
        return len(self._pending)

    @staticmethod
    def group(queries: List[ServeQuery]
              ) -> List[Tuple[Tuple[str, Optional[tuple]],
                              List[ServeQuery]]]:
        """Partition cold queries into batched-call waves.

        Returns `[((objective, metrics), [queries...]), ...]`: every
        inner list has pairwise-distinct workload names and one
        (objective, metrics) signature, so it maps 1:1 onto a
        `search_workloads(wls={...}, constraints={...})` call.
        """
        waves: List[Tuple[Tuple[str, Optional[tuple]],
                          List[ServeQuery]]] = []
        for q in queries:
            sig = (q.objective,
                   None if q.objective == "edp" else q.pareto_metrics)
            for wave_sig, wave in waves:
                if wave_sig == sig and all(w.wl.name != q.wl.name
                                           for w in wave):
                    wave.append(q)
                    break
            else:
                waves.append((sig, [q]))
        return waves
