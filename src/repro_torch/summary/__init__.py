"""Summary-side query answering (DESIGN.md §9), on the port's engine.

COUNT / SUM / MIN / MAX / AVG / GROUP BY / DISTINCT and predicate filters
are answered directly from the GFJS runs in O(num_runs), never paying the
O(|Q|) desummarization.

* :mod:`repro_torch.summary.algebra` — :class:`SummaryFrame` and
  :class:`ShardedSummaryFrame`, the summary-side relational algebra, with
  its weighted reductions on the CUDA ``mul_segsum`` kernel and its large
  GROUP BY sorts on the device;
* :mod:`repro_torch.summary.cache` — :class:`SummaryCache`, the
  compute-and-reuse LRU store keyed by (query fingerprint, table versions);
* :mod:`repro_torch.summary.msgcache` — :class:`MessageCache`, elimination
  messages reused across queries (DESIGN.md §20);
* :mod:`repro_torch.summary.service` — :class:`JoinService`, the front-end
  that consults the cache and runs :class:`repro_torch.GraphicalJoin` on a
  miss, on the service's device;
* :mod:`repro_torch.summary.incremental` — delta refresh (DESIGN.md §12).
"""

from repro_torch.summary.algebra import ShardedSummaryFrame, SummaryFrame
from repro_torch.summary.cache import CacheStats, SummaryCache
from repro_torch.summary.incremental import (DeltaError, IncrementalState,
                                             StaleDeltaError, capture_state,
                                             refresh_state)
from repro_torch.summary.msgcache import MessageCache
from repro_torch.summary.service import JoinService, ServiceReply

__all__ = ["SummaryFrame", "ShardedSummaryFrame", "SummaryCache",
           "CacheStats", "JoinService",
           "ServiceReply", "DeltaError", "StaleDeltaError",
           "IncrementalState", "capture_state", "refresh_state",
           "MessageCache"]
