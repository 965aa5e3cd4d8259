"""The join-plan IR: LogicalPlan (what to join) → PhysicalPlan (how).

A :class:`LogicalPlan` is the planner's view of a query: the primal graph,
the projection split (the paper's O' / O), and the statistics bundle.  A
:class:`PhysicalPlan` pins every choice the executor needs — elimination
order, early-projection split, kernel backends, materialization strategy —
plus the cost estimates that justified them, and renders all of it through
``explain()``.

PhysicalPlan identity (``signature()``) covers exactly the fields that
change the produced GFJS or how it is computed; `JoinQuery.fingerprint`
mixes it into the cache key so `SummaryCache`/`JoinService` distinguish
summaries built under different plans.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.graph import QueryGraph
from repro_torch.plan.cost import StepEstimate
from repro_torch.plan.stats import QueryStats
from repro_torch.relational.query import JoinQuery


# -- subtree fingerprints (cross-query message identity) ---------------------
#
# The message an elimination step emits is fully determined by the step's
# *source-potential closure*: the multiset of table occurrences feeding it
# (structure x content version), the dictionary-code spaces of the variables
# involved, the eliminated variable, the separator sequence, and whether a
# psi is kept.  Hashing exactly those ingredients gives a fingerprint under
# which identical subtrees in *different* queries collide by construction,
# and any `Table.append` invalidates by key (the version changes).

def domain_content_ids(enc) -> Dict[str, str]:
    """var -> content hash of its dictionary-encoding domain.

    Dictionary codes are domain-relative: `encode_query` builds each
    variable's domain as the sorted unique union over *all* of its
    occurrences, so a message's integer codes are only meaningful against
    that exact value array.  Hashing the domain content (not the
    contributor set) is both necessary and sufficient — and deliberately
    permissive: a dimension-key variable whose domain is the same value
    set under two different fact tables still matches.
    """
    ids: Dict[str, str] = {}
    for v, dom in enc.domains.items():
        h = hashlib.sha256()
        vals = np.ascontiguousarray(dom.values)
        if vals.dtype.kind == "O":   # object columns: hash the repr stream
            h.update(repr(vals.tolist()).encode())
        else:
            h.update(str(vals.dtype).encode())
            h.update(vals.tobytes())
        ids[v] = h.hexdigest()[:24]
    return ids


def _fp_hash(obj) -> str:
    return hashlib.sha256(
        json.dumps(obj, separators=(",", ":")).encode()).hexdigest()[:40]


def step_fingerprints(
    enc, order: Sequence[str], out_vars: Sequence[str],
    versions: Dict[str, str],
) -> Tuple[Dict[str, str], Dict[str, Tuple[str, ...]]]:
    """Canonical subtree fingerprint per elimination step of ``order``.

    Simulates exactly the working-set bookkeeping of
    `core.elimination.build_generator` (which factors contain a variable is
    structural — data never changes the wiring): each table occurrence
    hashes to (table, content version, sorted (column -> variable-label)
    pairs), and each step hashes to (order-insensitive multiset of input
    fingerprints, eliminated-variable label, separator label sequence *in
    order* — the separator order is what the consumer's factor columns
    follow — and the psi-needed flag).  Variable labels are the
    domain-content ids of :func:`domain_content_ids`, so the fingerprints
    are alias-insensitive; a label that is ambiguous within the query
    (self-joins over identical domains) falls back to including the literal
    name — conservative: loses cross-query hits, never conflates.

    Returns ``(fingerprints, sources)``: var -> fingerprint and var -> the
    base tables in the step's closure (provenance for explicit
    invalidation).  Bagged (hybrid WCOJ) plans must not call this — bag
    potentials merge occurrences outside the step wiring simulated here.
    """
    query = enc.query
    dom = domain_content_ids(enc)
    counts: Dict[str, int] = {}
    for d in dom.values():
        counts[d] = counts.get(d, 0) + 1
    labels = {v: (d if counts[d] == 1 else f"{d}|{v}")
              for v, d in dom.items()}
    out_set = set(out_vars)

    working: List[Tuple[str, frozenset, frozenset]] = []
    for qt in query.tables:
        canon = {
            "table": qt.table,
            "version": versions[qt.table],
            "cols": sorted([c, labels[u]] for c, u in qt.var_map),
        }
        working.append((_fp_hash(canon), frozenset(qt.variables),
                        frozenset((qt.table,))))

    fps: Dict[str, str] = {}
    sources: Dict[str, Tuple[str, ...]] = {}
    for v in order[:-1]:
        rel = [w for w in working if v in w[1]]
        rest = [w for w in working if v not in w[1]]
        if not rel:            # disconnected graph; the executor will raise
            return {}, {}
        scope: set = set()
        tabs: set = set()
        for _, sc, tb in rel:
            scope |= sc
            tabs |= tb
        sep = tuple(u for u in order if u != v and u in scope)
        canon = {
            "op": "eliminate",
            "var": labels[v],
            "inputs": sorted(fp for fp, _, _ in rel),
            "sep": [labels[u] for u in sep],
            "psi": v in out_set,
        }
        fp = _fp_hash(canon)
        fps[v] = fp
        sources[v] = tuple(sorted(tabs))
        working = rest + [(fp, frozenset(sep), frozenset(tabs))]
    return fps, sources


@dataclass
class LogicalPlan:
    """Query graph + projection split + planner statistics."""

    query: JoinQuery
    graph: QueryGraph
    output_vars: Tuple[str, ...]          # the paper's O (generation order src)
    projected_out: Tuple[str, ...]        # the paper's O' (eliminated silently)
    stats: QueryStats

    @property
    def variables(self) -> List[str]:
        return list(self.graph.variables)


@dataclass
class OrderCandidate:
    """One scored elimination order considered by the search."""

    source: str                           # "min_fill" | "greedy" | "beam" | ...
    order: Tuple[str, ...]
    cost: float


@dataclass
class BagStep:
    """One WCOJ multiway bag step of a hybrid GJ/WCOJ plan.

    The executor generic-joins all of the bag's table occurrences at once
    (``core/potential_join.py::multiway_product``, binding ``bind_order``
    level by level with per-level intersection on the smallest potential)
    and feeds the joint potential into ordinary GJ elimination in place of
    its member factors.  ``vars``/``bind_order`` list the bag scope in the
    plan's global elimination order; because the scope is a clique of the
    chosen order's triangulation, the downstream elimination meets exactly
    the same separators as the monolithic build and the final GFJS is
    bit-identical (DESIGN.md §19).
    """

    vars: Tuple[str, ...]          # bag scope, in global elimination order
    occurrences: Tuple[int, ...]   # table-occurrence indices joined here
    bind_order: Tuple[str, ...]    # WCOJ binding order (== vars today)
    est_entries: float = 0.0       # estimated |bag product| (drift anchor)
    est_cost: float = 0.0          # estimated work: sum of level frontiers
    agm_entries: float = 0.0       # AGM fractional-edge-cover bound
    rho: float = 0.0               # fractional edge cover number
    num_factors: int = 0
    tables: Tuple[str, ...] = ()   # base tables feeding the bag

    @property
    def cost(self) -> float:
        return self.est_cost


@dataclass
class PhysicalPlan:
    """Every executable choice, pinned."""

    query_name: str
    order: Tuple[str, ...]
    early_projection: bool
    backends: Dict[str, str]              # phase -> "numpy" | "jax"
    materialize: str                      # "inmem" | "stream"
    source: str                           # which candidate won
    est_cost: float
    steps: Tuple[StepEstimate, ...] = ()
    alternatives: Tuple[OrderCandidate, ...] = ()
    planner: str = "cost"
    search_seconds: float = 0.0
    # hash-partitioned execution (repro/dist/partition.py): split into
    # ``partitions`` shards on hash(partition_var); 1 = monolithic.
    # ``partition_fold`` over-partitions: partitions * fold virtual shards
    # folded back onto ``partitions`` workers (skew smoothing, DESIGN §17);
    # ``shard_executor`` picks where shard pipelines run ("thread" — the
    # GIL-bound pool — or "process": the repro/dist/actions.py worker pool).
    partitions: int = 1
    partition_var: Optional[str] = None
    partition_fold: int = 1
    shard_executor: str = "thread"
    # hypertree-decomposed hybrid execution: WCOJ bag steps pre-joining the
    # cyclic core, then GJ elimination over the bag marginals.  () = pure
    # GJ (every acyclic plan, and cyclic ones where the cost model found
    # no win) — folded into signature() only when non-empty, so existing
    # plans keep their historical signatures and cache keys.
    bags: Tuple[BagStep, ...] = ()

    # -- delta support -----------------------------------------------------
    def dirty_steps(self, table: str) -> Tuple[str, ...]:
        """Variables whose elimination steps an append to ``table`` dirties.

        Each :class:`StepEstimate` carries the base tables feeding it —
        directly (the step consumes one of the table's potentials) or
        transitively (it consumes a message derived from one).  The result
        is therefore the downstream closure in the message-flow DAG: the
        exact set of steps an incremental refresh must recompute; every
        other step's conditional factor and message are reusable as-is.
        """
        return tuple(s.var for s in self.steps if table in s.tables)

    def refresh_fraction(self, table: str) -> float:
        """Estimated share of elimination work an append re-runs (0..1)."""
        total = sum(s.product_entries for s in self.steps)
        if total <= 0.0:
            return 1.0
        dirty = sum(s.product_entries for s in self.steps
                    if table in s.tables)
        return dirty / total

    def admission_cost(self) -> float:
        """Cost of a cold build of this plan, for admission control.

        Sum of the per-step CostModel estimates (product entries touched
        across the elimination; DESIGN §15) divided by the partition
        count — shards run in parallel, so the per-worker critical path
        is what a serving deadline competes with.  Falls back to
        ``est_cost`` when the plan carries no step breakdown (hand-built
        plans).  ``repro.serve.server.JoinServer`` compares this against
        its ``cost_ceiling`` before admitting a cold build.
        """
        total = sum(s.cost for s in self.steps) if self.steps \
            else float(self.est_cost)
        total += sum(b.cost for b in self.bags)
        return total / max(int(self.partitions), 1)

    # -- identity ----------------------------------------------------------
    def signature(self, labels: Optional[Dict[str, str]] = None) -> str:
        """Stable hash of the execution-relevant plan fields.

        Cost estimates, alternatives, and search timings are advisory and
        deliberately excluded: two plans that run the same way hash the
        same even if their statistics were gathered at different times.

        ``labels`` (var -> canonical label, from
        `JoinQuery.canonical_labels`) renames the variables the signature
        embeds, so `fingerprint(plan=...)` can hash alias-renamed twins of
        the same plan identically; identity labels (or None) reproduce the
        historical signature byte-for-byte.
        """
        if labels:
            def lab(v):
                return labels.get(v, v)
        else:
            def lab(v):
                return v
        canon = {
            "order": [lab(v) for v in self.order],
            "early_projection": bool(self.early_projection),
            "backends": dict(sorted(self.backends.items())),
            "materialize": self.materialize,
        }
        if self.partitions > 1:
            # only folded in when actually partitioned, so monolithic plans
            # keep their historical signatures (and spilled cache entries)
            canon["partitions"] = int(self.partitions)
            canon["partition_var"] = (lab(self.partition_var)
                                      if self.partition_var else None)
            canon["partition_fold"] = int(self.partition_fold)
            canon["shard_executor"] = self.shard_executor
        if self.bags:
            # same conditionality: pure-GJ plans (all acyclic queries in
            # particular) keep their historical signatures and cache keys
            canon["bags"] = [[[lab(v) for v in b.vars], list(b.occurrences),
                              [lab(v) for v in b.bind_order]]
                             for b in self.bags]
        return hashlib.sha256(
            json.dumps(canon, separators=(",", ":")).encode()).hexdigest()[:16]

    # -- rendering ---------------------------------------------------------
    def explain(self, timings: Optional[Dict[str, float]] = None,
                actuals: Optional[Dict[str, float]] = None,
                step_seconds: Optional[Dict[str, float]] = None,
                step_seconds_sum: Optional[Dict[str, float]] = None,
                shard_report: Optional[Dict[str, object]] = None,
                bag_actuals: Optional[Dict[int, float]] = None,
                bag_seconds: Optional[Dict[int, float]] = None,
                calibration: Optional[Dict[str, float]] = None,
                calibration_source: str = "measured",
                cached_steps: Optional[Sequence[str]] = None) -> str:
        """Human-readable plan: order, per-step estimates, backends.

        Pass the executor's ``timings`` to annotate phases with measured
        wall time next to the estimates, and its ``step_actuals``
        (var -> measured product entries) to render estimate-vs-actual
        drift per step — the honest-numbers half of the plan-feedback
        loop (no re-planning yet).

        The analyze-mode kwargs (``Executor.explain(analyze=True)``
        supplies them) extend each step with measured seconds — the
        per-shard max alongside the summed work when partitioned — and
        append a per-shard section (rows, wall, straggler flags, skew)
        instead of collapsing shards into one number.

        ``bag_actuals``/``bag_seconds`` (bag index -> measured product
        size / wall) annotate the WCOJ bag section of a hybrid plan the
        same way; ``calibration`` (op -> correction scalar from
        ``CostModel.calibrate``) renders each raw estimate next to its
        calibrated value so the feedback loop's effect is visible.
        ``calibration_source="loaded"`` marks factors restored from the
        persisted sidecar (rendered ``calib(loaded)=``) rather than
        measured this run.  ``cached_steps`` (variables whose messages the
        build actually served from the message cache) renders
        ``cached=hit`` per step; steps the planner merely *priced* as
        resident (`StepEstimate.cached`) render ``cached=resident``.
        """
        calib_tag = ("calib(loaded)" if calibration_source == "loaded"
                     else "calib")
        lines = [
            f"PhysicalPlan {self.query_name!r}  "
            f"(planner={self.planner}, chosen={self.source}, "
            f"signature={self.signature()})",
            f"  elimination order : {' -> '.join(self.order)}"
            f"   (root: {self.order[-1] if self.order else '-'})",
            f"  early projection  : {'on' if self.early_projection else 'off'}",
            f"  backends          : " + ", ".join(
                f"{k}={v}" for k, v in sorted(self.backends.items())),
            f"  materialize       : {self.materialize}",
            f"  est cost          : {self.est_cost:.3g} product entries"
            f"   (search {self.search_seconds * 1e3:.2f}ms)",
        ]
        if self.partitions > 1:
            part = (f"  partitions        : {self.partitions} "
                    f"by hash({self.partition_var})")
            if self.partition_fold > 1:
                part += (f" x{self.partition_fold} fold "
                         f"({self.partitions * self.partition_fold} virtual)")
            part += f"  executor={self.shard_executor}"
            lines.insert(5, part)
        if self.bags:
            lines.append("  bags (WCOJ multiway steps):")
            for j, b in enumerate(self.bags):
                line = (
                    f"    bag[{','.join(b.vars)}] factors={b.num_factors}"
                    f"  est_entries={b.est_entries:.3g}"
                    f"  agm={b.agm_entries:.3g} (rho*={b.rho:.2f})")
                if calibration and "bag" in calibration:
                    calib = b.est_entries * calibration["bag"]
                    line += f"  {calib_tag}={calib:.3g}"
                if b.tables:
                    line += f"  tables=({','.join(b.tables)})"
                if bag_actuals and j in bag_actuals:
                    act = float(bag_actuals[j])
                    drift = (act / b.est_entries
                             if b.est_entries > 0.0 else float("inf"))
                    line += f"  actual={act:.3g} ({drift:.2f}x est)"
                if bag_seconds and j in bag_seconds:
                    line += f"  time={bag_seconds[j] * 1e3:.2f}ms"
                lines.append(line)
        if self.steps:
            lines.append("  steps:")
            for s in self.steps:
                sep = ",".join(s.separator) or "()"
                line = (
                    f"    eliminate {s.var:<12s} factors={s.num_factors}"
                    f"  est_product={s.product_entries:.3g}"
                    f"  sep=({sep})  est_message={s.message_entries:.3g}")
                if calibration and "eliminate" in calibration:
                    calib = s.product_entries * calibration["eliminate"]
                    line += f"  {calib_tag}={calib:.3g}"
                if cached_steps is not None and s.var in cached_steps:
                    line += "  cached=hit"
                elif getattr(s, "cached", False):
                    line += "  cached=resident"
                if s.tables:
                    line += f"  tables=({','.join(s.tables)})"
                if actuals and s.var in actuals:
                    act = float(actuals[s.var])
                    drift = (act / s.product_entries
                             if s.product_entries > 0.0 else float("inf"))
                    line += f"  actual={act:.3g} ({drift:.2f}x est)"
                if step_seconds and s.var in step_seconds:
                    line += f"  time={step_seconds[s.var] * 1e3:.2f}ms"
                    if (step_seconds_sum
                            and s.var in step_seconds_sum
                            and step_seconds_sum[s.var]
                            != step_seconds[s.var]):
                        line += (f" (max; sum "
                                 f"{step_seconds_sum[s.var] * 1e3:.2f}ms)")
                lines.append(line)
        if shard_report:
            sizes = shard_report.get("sizes", [])
            seconds = shard_report.get("seconds", [])
            stragglers = {getattr(s, "shard", None)
                          for s in shard_report.get("stragglers", [])}
            lines.append("  shards:")
            for i, (rows, sec) in enumerate(zip(sizes, seconds)):
                mark = "  STRAGGLER" if i in stragglers else ""
                lines.append(f"    shard {i:<3d} rows={rows:<12d} "
                             f"wall={sec * 1e3:10.2f}ms{mark}")
            lines.append(
                f"    skew: rows={shard_report.get('skew', 1.0):.2f}x  "
                f"time={shard_report.get('time_skew', 1.0):.2f}x")
            if shard_report.get("executor"):
                line = (f"    executor: {shard_report['executor']} "
                        f"workers={shard_report.get('workers', '?')}")
                if shard_report.get("retries"):
                    line += (f"  degraded={shard_report['retries']} "
                             "(retried on threads)")
                lines.append(line)
        if self.alternatives:
            lines.append("  candidates:")
            for c in self.alternatives:
                mark = "*" if (c.source == self.source
                               and tuple(c.order) == tuple(self.order)) else " "
                lines.append(
                    f"   {mark}{c.source:<10s} cost={c.cost:<12.4g} "
                    f"[{', '.join(c.order)}]")
        if calibration:
            src = " [loaded from sidecar]" \
                if calibration_source == "loaded" else ""
            lines.append(
                f"  calibration (op -> geometric-mean actual/est){src}:")
            for k, v in sorted(calibration.items()):
                lines.append(f"    {k:<16s} x{v:.3f}")
        if timings:
            lines.append("  measured:")
            for k, v in timings.items():
                lines.append(f"    {k:<16s} {v * 1e3:10.2f}ms")
        return "\n".join(lines)
