"""Parallel execution of the bound-guided search (the port of
`repro.parallel`'s slab scheduler): `slab_sched` fans one search's slab
queue out across leased worker threads that launch the kernels on the
search's device."""
from .slab_sched import (CANONICAL_COUNTER_KEYS, DEFAULT_LEASE_S,
                         SchedStats, SlabScheduler, canonical_counters,
                         parallel_bnb)

__all__ = ["CANONICAL_COUNTER_KEYS", "DEFAULT_LEASE_S", "SchedStats",
           "SlabScheduler", "canonical_counters", "parallel_bnb"]
