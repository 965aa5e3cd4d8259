"""Straggler mitigation at fleet scale.

Mechanisms (layered, per DESIGN.md's 1000+-node posture):

1. **Host-level** (implemented, used by the Trainer): the prefetch queue in
   train/trainer.py decouples storage latency from step latency, and the
   GFJS-range data layout (data/pipeline.py) makes host re-balancing O(1):
   a slow or dead data host's row-range is re-assigned by changing two
   integers — no data movement, because every host holds the (tiny) summary.

2. **Step-level** (this module): a deadline monitor that records per-step
   wall times, flags steps exceeding `k * median` as straggler events, and
   recommends an action: re-balance data ranges (host skew), checkpoint+
   evict (persistent slow node), or nothing (transient).  On a real fleet
   the recommendation feeds the cluster scheduler; here it feeds logs and
   the FT test-suite.

3. **Collective-level** (documented): synchronous SPMD means one slow chip
   stalls the all-reduce.  The standard mitigations our stack composes
   with: smaller microbatches (train_step ``microbatches``) to shrink the
   blast radius of a stall, gradient compression (train_step
   ``compressed_psum``) to shrink exposure to network jitter, and elastic
   restart from the checkpoint manager when a node is evicted (restore is
   topology-independent — checkpoint/store.py re-shards on load).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class StragglerEvent:
    step: int
    seconds: float
    median: float
    ratio: float
    recommendation: str


@dataclass
class ShardStraggler:
    """One shard of a partitioned summarize that blew the deadline.

    Produced by :func:`flag_shard_stragglers` from the per-shard wall
    times the executor's shard spans measure; surfaced by
    ``explain(analyze=True)`` and counted in the ``dist.stragglers``
    metric.  Same ``k * median`` rule as the step-level monitor, applied
    across shards of one build instead of across steps of one shard.
    """

    shard: int
    seconds: float
    median: float
    ratio: float


def flag_shard_stragglers(seconds: List[float],
                          threshold: float = 2.0) -> List[ShardStraggler]:
    """Shards whose wall time exceeds ``threshold * median(seconds)``.

    With fewer than 3 shards a median is meaningless (any imbalance
    would flag one of two shards), so nothing is flagged.
    """
    if len(seconds) < 3:
        return []
    med = sorted(seconds)[len(seconds) // 2]
    if med <= 0.0:
        return []
    return [ShardStraggler(shard=i, seconds=dt, median=med, ratio=dt / med)
            for i, dt in enumerate(seconds) if dt > threshold * med]


@dataclass
class StragglerMonitor:
    """Deadline-based step-time monitor."""

    threshold: float = 2.0          # x median => straggler
    evict_after: int = 3            # consecutive stragglers => evict advice
    window: int = 50
    _times: List[float] = field(default_factory=list)
    _consecutive: int = 0
    events: List[StragglerEvent] = field(default_factory=list)
    _t0: Optional[float] = None

    def step_start(self) -> None:
        self._t0 = time.perf_counter()

    def step_end(self, step: int) -> Optional[StragglerEvent]:
        assert self._t0 is not None
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        med = sorted(self._times)[len(self._times) // 2]
        if len(self._times) >= 5 and dt > self.threshold * med:
            self._consecutive += 1
            rec = ("evict-and-restore" if self._consecutive >= self.evict_after
                   else "rebalance-data-ranges" if self._consecutive > 1
                   else "transient-ignore")
            ev = StragglerEvent(step, dt, med, dt / med, rec)
            self.events.append(ev)
            return ev
        self._consecutive = 0
        return None
