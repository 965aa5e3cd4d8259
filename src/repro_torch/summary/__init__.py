"""Summary-side query answering (DESIGN.md §9), on the port's engine.

COUNT / SUM / MIN / MAX / AVG / GROUP BY / DISTINCT and predicate filters
are answered directly from the GFJS runs in O(num_runs), never paying the
O(|Q|) desummarization.

* :mod:`repro_torch.summary.algebra` — :class:`SummaryFrame` and
  :class:`ShardedSummaryFrame`, the summary-side relational algebra, with
  its weighted reductions on the CUDA ``mul_segsum`` kernel and its large
  GROUP BY sorts on the device.

The reference's service, cache, message cache and incremental modules are
later slices of the port (ROADMAP.md queue 1).
"""

from repro_torch.summary.algebra import ShardedSummaryFrame, SummaryFrame

__all__ = ["SummaryFrame", "ShardedSummaryFrame"]
