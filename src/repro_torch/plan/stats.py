"""Planner statistics — what the encoder already knows, organized for costing.

The cost model never touches base-table rows: everything it needs falls out
of the quantitative-learning factors the pipeline builds anyway (one GROUP BY
per table occurrence, `Factor.from_columns`):

* per-variable **domain sizes** (from the dictionary encoder);
* per-factor **cardinalities** (distinct key rows = factor entries);
* per-(factor, variable) **degree vectors** — `bincount` of the variable's
  codes over its domain.  The dot product of two degree vectors is the
  *exact* entry count of the pairwise factor product on that variable, which
  is what makes the planner skew-aware ("Skew Strikes Back": AGM-style
  bounds that ignore the degree distribution miss exactly the blow-ups GJ
  cares about).

Degree vectors are only materialized for domains up to ``DEGREE_CAP`` codes;
above that the model falls back to (entries, distinct) scalar estimates —
the classic System-R uniformity assumption, now a guarded fallback instead
of the only option.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.potentials import Factor
from repro_torch.relational.encoding import EncodedQuery

DEGREE_CAP = 1 << 22  # max domain size for which we keep a degree vector


@dataclass
class FactorStats:
    """Cheap statistics of one potential (real or simulated intermediate)."""

    vars: Tuple[str, ...]
    entries: float                       # distinct key rows (estimated)
    distinct: Dict[str, float]           # per-var distinct value count
    degrees: Dict[str, np.ndarray]       # per-var degree vector (optional)
    # base tables folded into this (possibly simulated) factor.  Messages
    # accumulate the sources of everything they consumed, so a step's
    # sources are exactly the tables whose appends dirty it — the plan-level
    # dependency map behind PhysicalPlan.dirty_steps().
    sources: FrozenSet[str] = frozenset()

    def has_degrees(self, v: str) -> bool:
        return v in self.degrees

    @staticmethod
    def of(factor: Factor, sizes: Dict[str, int],
           sources: FrozenSet[str] = frozenset()) -> "FactorStats":
        distinct: Dict[str, float] = {}
        degrees: Dict[str, np.ndarray] = {}
        for v in factor.vars:
            col = factor.col(v)
            size = int(sizes.get(v, 0))
            if 0 < size <= DEGREE_CAP:
                deg = np.bincount(col, minlength=size).astype(np.float64) \
                    if len(col) else np.zeros(size, np.float64)
                degrees[v] = deg
                distinct[v] = float(np.count_nonzero(deg))
            else:
                distinct[v] = float(len(np.unique(col)))
        return FactorStats(tuple(factor.vars), float(factor.num_entries),
                           distinct, degrees, sources)


@dataclass
class QueryStats:
    """All planner inputs for one encoded query."""

    sizes: Dict[str, int]                # per-variable domain size
    factors: List[Factor]                # the real potentials (reused later)
    factor_stats: List[FactorStats]

    @staticmethod
    def of(enc: EncodedQuery,
           factors: Optional[Sequence[Factor]] = None) -> "QueryStats":
        sizes = enc.domain_sizes()
        if factors is None:
            factors = [Factor.from_columns(cols, sizes)
                       for cols in enc.encoded_tables]
        fstats = [FactorStats.of(f, sizes, frozenset({qt.table}))
                  for f, qt in zip(factors, enc.query.tables)]
        return QueryStats(sizes, list(factors), fstats)
