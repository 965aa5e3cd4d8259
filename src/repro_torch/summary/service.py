"""JoinService — the query-answering front-end over summaries.

One object owns a catalog, a :class:`SummaryCache`, a plan cache, and the
decision of when to actually run the Graphical Join:

    svc = JoinService(catalog, byte_budget=64 << 20, spill_dir=".../spill")
    n    = svc.count(query)                              # O(runs) after 1st
    tbl  = svc.group_by(query, "A", total=("sum", "D"))
    r    = svc.frame(query)            # SummaryFrame + provenance/timings
    plan = svc.compile(query)          # pre-compiled PhysicalPlan (serve path)
    r2   = svc.frame(query, plan=plan) # keyed on plan identity
    svc.append("user_friends", rows)   # live growth; summaries refresh
    r3   = svc.frame(query)            # ... lazily: source == "refreshed"

Summaries are keyed on (canonical query fingerprint × table content
versions × physical-plan signature): the same query executed under a
different plan is a different summary (the GFJS column order depends on the
elimination order).  `compile` runs the cost-based planner once and caches
the PhysicalPlan per (query, table versions); `frame` reuses it so warm
requests never re-plan.

Cache hits skip ``build_model`` / ``build_generator`` / ``summarize``
entirely — a request served from cache carries no build-phase timings,
which is the service-level observable the tests assert on.

Below whole-summary reuse sits *message* reuse (DESIGN.md §20): every
build this service runs shares one :class:`MessageCache`, so a cold build
whose elimination subtrees match an earlier query's — same occurrence
structure over the same table contents — injects the cached messages and
skips those product+marginalization steps outright.  The message cache is
byte-pooled with the summary cache and spills under ``<spill_dir>/msg``;
``message_reuse=False`` disables it.  Cost-model drift corrections are
persisted to a ``calibration.json`` sidecar in ``spill_dir`` and seed the
planner in later processes (``calib(loaded)=`` in ``explain()``).

Base-table appends are first-class: `append` upgrades the catalog and
queues a :class:`~repro_torch.relational.table.TableDelta`; the next `frame()`
for an affected query chains the pending deltas through the incremental
refresher (re-encode the blocks, re-run only dirty elimination steps,
splice — DESIGN.md §12) and upgrades the cache entry in place via
`SummaryCache.refresh`.  A broken delta chain, a mixed-dtype block, or a
dropped state all fall back to the cold compute path — refresh is an
optimization, never a correctness dependency.

The service is safe to call from multiple threads: the summary cache locks
internally, the plan cache is guarded here, and append *staging* (the
O(table) column copy) is serialized per table.  Two threads racing on the
same cold query may both compute it (last put wins) — duplicate work, never
a wrong answer.  Refresh races the same way: both threads derive the same
new-consistent summary, and `SummaryCache.refresh` commits atomically.
Serving tiers that cannot afford the duplicate work put
`repro_torch.serve.server.JoinServer` in front: it collapses concurrent
identical-key misses onto one build (waiters' replies carry
``source="collapsed"``), batches per-key probes, and admission-controls
cold builds by the plan's cost estimate (DESIGN.md §18).

Port of ``src/repro/summary/service.py`` with one rewrite: the service
has a ``device`` (``"cuda"`` by default; ``"cuda"`` without a card raises
in ``__init__``), passed to every ``GraphicalJoin`` it builds and every
``SummaryFrame`` it returns, so untraced builds generate on the card and
every aggregate reduces there.  Traced builds (``incremental=True``)
generate on numpy, as in the reference.  A GFJS generated on the card
holds its device memo (``GFJS._launch``), which ``resident_nbytes()`` and
so the cache's byte budget count; the memo is freed when no cache entry,
retained state or reply holds the GFJS — a long-lived ``ServiceReply``
(its ``frame`` holds the GFJS) keeps those device bytes alive.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.api import GraphicalJoin
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import span as _span
from repro_torch.plan.ir import PhysicalPlan
from repro_torch.relational.query import JoinQuery
from repro_torch.relational.table import Catalog, TableDelta
from repro_torch.summary.algebra import AggSpec, Predicate, SummaryFrame
from repro_torch.summary.cache import SummaryCache, cache_key, cache_key_for_versions
from repro_torch.summary.msgcache import MessageCache
from repro_torch.summary.incremental import (DeltaError, IncrementalState,
                                       capture_state, refresh_state)


@dataclass
class ServiceReply:
    """A frame plus how it was produced (the service's provenance record)."""

    frame: SummaryFrame
    source: str                # "memory" | "disk" | "refreshed" | "computed"
                               # (+ "collapsed": a JoinServer waiter that
                               #  shared another request's in-flight build)
    key: str
    timings: Dict[str, float] = field(default_factory=dict)
    plan: Optional[PhysicalPlan] = None

    @property
    def cache_hit(self) -> bool:
        return self.source in ("memory", "disk")

    def explain(self) -> str:
        """Provenance report: where the frame came from, what it cost,
        and (when available) the plan it was built under."""
        lines = [
            f"ServiceReply  source={self.source}  key={self.key[:16]}…",
            "  timings:",
        ]
        for k, v in self.timings.items():
            lines.append(f"    {k:<16s} {v * 1e3:10.2f}ms")
        if self.plan is not None:
            lines.append(self.plan.explain())
        return "\n".join(lines)


class JoinService:
    """Answer join queries from cached summaries; compute-and-reuse on miss."""

    def __init__(self, catalog: Catalog, *,
                 cache: Optional[SummaryCache] = None,
                 byte_budget: int = 256 << 20,
                 spill_dir: Optional[str] = None,
                 ttl_seconds: Optional[float] = None,
                 planner: str = "cost",
                 max_plans: int = 256,
                 incremental: bool = True,
                 max_states: int = 16,
                 max_state_bytes: int = 512 << 20,
                 max_pending_deltas: int = 64,
                 partitions: int = 1,
                 partition_fold: Optional[int] = None,
                 shard_executor: Optional[str] = None,
                 message_reuse: bool = True,
                 message_cache: Optional[MessageCache] = None,
                 device: Union[str, torch.device] = "cuda") -> None:
        # where builds generate and frames reduce; resolved once, so a
        # "cuda" service without a card fails here, not on its first miss
        self.device = engine.resolve_device(device)
        self.catalog = catalog
        self.cache = cache if cache is not None else SummaryCache(
            byte_budget=byte_budget, spill_dir=spill_dir,
            ttl_seconds=ttl_seconds)
        # elimination-message reuse (DESIGN.md §20): one MessageCache shared
        # across every build this service runs, byte-pooled with the summary
        # cache (messages yield budget to summaries, never the reverse) and
        # spilling under <spill_dir>/msg.  message_reuse=False turns the
        # whole mechanism off; a caller-supplied message_cache wins.
        if message_cache is not None:
            self.message_cache: Optional[MessageCache] = message_cache
        elif message_reuse:
            self.message_cache = MessageCache(
                spill_dir=os.path.join(spill_dir, "msg") if spill_dir
                else None,
                summary_cache=self.cache)
        else:
            self.message_cache = None
        # CostModel calibration sidecar (JSON next to the spill dir): drift
        # corrections measured by past builds persist across processes and
        # seed the planner until this process measures its own
        self.calibration_path = (
            os.path.join(spill_dir, "calibration.json") if spill_dir
            else None)
        self._corrections: Optional[Dict[str, float]] = None
        self._corrections_loaded = False
        self.planner = planner
        # > 1: plans pin hash-partitioned execution; summaries are
        # ShardedGFJS, cache keys fold the shard scheme in through the plan
        # signature, and appends fall back to rebuild (no splice-refresh of
        # sharded summaries) — the aggregate API is shape-oblivious
        self.partitions = int(partitions)
        # partitioned-execution knobs, pinned into every compiled plan:
        # shard_executor="process" names the repro_torch/dist/actions.py
        # spawn pool, which generates on numpy — the service's plans
        # generate with the torch engine, so their shards stay on threads
        # on self.device, as the reference keeps its jax shards on threads;
        # partition_fold over-partitions for skew smoothing (None =
        # planner auto-choice from stats)
        self.partition_fold = partition_fold
        self.shard_executor = shard_executor
        self.max_plans = int(max_plans)
        self.incremental = bool(incremental)
        self.max_states = int(max_states)
        self.max_state_bytes = int(max_state_bytes)
        self.max_pending_deltas = int(max_pending_deltas)
        self.requests = 0
        self.refreshes = 0
        self._lock = threading.RLock()
        # (query fingerprint, table versions) -> (plan, base-table names).
        # Keys embed content versions, so every table refresh mints a new
        # key — LRU-bounded at max_plans so version churn can't grow it
        # without bound (plans are tiny; re-planning a evicted one is ms).
        self._plans: "OrderedDict[Tuple[str, Tuple[str, ...]], " \
                     "Tuple[PhysicalPlan, frozenset]]" = OrderedDict()
        # incremental-maintenance side state, all guarded by self._lock:
        # plan-keyed fingerprint -> IncrementalState (LRU-bounded), and the
        # per-table append log frame() chains through to catch a state up
        self._states: "OrderedDict[str, IncrementalState]" = OrderedDict()
        self._pending: Dict[str, list] = {}
        # per-table append staging locks (guarded by self._lock): k
        # concurrent appenders to one hot table serialize the O(table)
        # column copy — k stagings total, not the O(k²·table) of every
        # loser re-staging against each winner's new base
        self._append_locks: Dict[str, threading.Lock] = {}

    # -- planning -----------------------------------------------------------
    def _plan_key(self, query: JoinQuery) -> Tuple[str, Tuple[str, ...]]:
        # literal=True: plans embed the query's own variable names in
        # ``order`` — serving one to an alias-renamed twin would crash the
        # executor.  (Summary cache keys stay canonical: GFJS columns are
        # the output variables, which keep their literal labels.)
        names = sorted({qt.table for qt in query.tables})
        return (query.fingerprint(literal=True),
                tuple(self.catalog[n].version() for n in names))

    def _load_corrections(self) -> Optional[Dict[str, float]]:
        """Calibration corrections from the sidecar (lazy, once)."""
        with self._lock:
            if not self._corrections_loaded:
                self._corrections_loaded = True
                p = self.calibration_path
                if p is not None and os.path.exists(p):
                    try:
                        with open(p) as f:
                            raw = json.load(f)
                        self._corrections = {
                            str(k): float(v) for k, v in raw.items()
                            if math.isfinite(float(v)) and float(v) > 0}
                    except (ValueError, TypeError, OSError):
                        self._corrections = None   # corrupt sidecar: ignore
            return dict(self._corrections) if self._corrections else None

    def _persist_calibration(self, measured: Dict[str, float]) -> None:
        """Blend a build's measured drift into the sidecar (geometric mean
        with the stored factor — one outlier build can't whipsaw the
        planner) and write it back atomically."""
        if not measured:
            return
        with self._lock:
            cur = dict(self._corrections or {})
            for op, f in measured.items():
                f = float(f)
                if not (math.isfinite(f) and f > 0):
                    continue
                prev = cur.get(op)
                cur[op] = f if prev is None else math.sqrt(prev * f)
            self._corrections = cur
            self._corrections_loaded = True
            p = self.calibration_path
            payload = dict(cur)
        if p is None:
            return
        try:
            tmp = p + ".tmp"
            os.makedirs(os.path.dirname(p), exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(payload, f, sort_keys=True)
            os.replace(tmp, p)
        except OSError:
            pass    # persistence is best-effort, never a failure path

    def _remember_plan(self, pkey, plan: PhysicalPlan,
                       tables: frozenset) -> None:
        """Insert into the LRU-bounded plan cache (lock held by caller)."""
        self._plans.setdefault(pkey, (plan, tables))
        self._plans.move_to_end(pkey)
        while len(self._plans) > self.max_plans:
            self._plans.popitem(last=False)

    def compile(self, query: JoinQuery) -> PhysicalPlan:
        """The PhysicalPlan for ``query`` on the current table versions.

        Compiled once per (query shape, table versions) and cached; the
        serve path calls this up front and hands the plan to `frame`.
        """
        pkey = self._plan_key(query)
        with self._lock:
            hit = self._plans.get(pkey)
            if hit is not None:
                self._plans.move_to_end(pkey)
                return hit[0]
        gj = GraphicalJoin(self.catalog, query, planner=self.planner,
                           partitions=self.partitions,
                           partition_fold=self.partition_fold,
                           shard_executor=self.shard_executor,
                           message_cache=self.message_cache,
                           corrections=self._load_corrections(),
                           device=self.device)
        plan = gj.plan()
        with self._lock:
            self._remember_plan(
                pkey, plan, frozenset(qt.table for qt in query.tables))
        return plan

    # -- summary acquisition ----------------------------------------------
    def frame(self, query: JoinQuery,
              plan: Optional[PhysicalPlan] = None) -> ServiceReply:
        """The summary for ``query``: cache first, GraphicalJoin on miss.

        Every reply — cache hits included — carries a ``"service"``
        timing (end-to-end request latency) and lands in the
        ``service.latency_seconds.<source>`` histogram, so the serving
        path is measurable even when no join ever runs.
        """
        with _span("service:frame", cat="service", query=query.name) as sp:
            t_req = time.perf_counter()
            reply = self._frame_inner(query, plan)
            dt = time.perf_counter() - t_req
            reply.timings["service"] = dt
            sp.set(source=reply.source)
            REGISTRY.counter("service.requests").inc()
            REGISTRY.counter(f"service.source.{reply.source}").inc()
            REGISTRY.histogram(
                f"service.latency_seconds.{reply.source}",
                unit="s").observe(dt)
            return reply

    def _frame_inner(self, query: JoinQuery,
                     plan: Optional[PhysicalPlan] = None) -> ServiceReply:
        with self._lock:
            self.requests += 1
        gj: Optional[GraphicalJoin] = None
        if plan is None:
            pkey = self._plan_key(query)
            with self._lock:
                hit = self._plans.get(pkey)
                if hit is not None:
                    self._plans.move_to_end(pkey)
            if hit is not None:
                plan = hit[0]
            else:
                # plan inline and keep the GraphicalJoin: a cache miss below
                # reuses its encoding/potentials instead of re-planning
                # no trace under partitioned plans: refresh is rebuild there
                gj = GraphicalJoin(self.catalog, query, planner=self.planner,
                                   record_trace=self.incremental
                                   and self.partitions == 1,
                                   partitions=self.partitions,
                                   partition_fold=self.partition_fold,
                                   shard_executor=self.shard_executor,
                                   message_cache=self.message_cache,
                                   corrections=self._load_corrections(),
                                   device=self.device)
                plan = gj.plan()
                with self._lock:
                    self._remember_plan(
                        pkey, plan,
                        frozenset(qt.table for qt in query.tables))
        versions = {qt.table: self.catalog[qt.table].version()
                    for qt in query.tables}
        key = cache_key_for_versions(query, versions, plan=plan)
        t0 = time.perf_counter()
        cached, source = self.cache.get_with_source(key)
        lookup = time.perf_counter() - t0
        if cached is not None:
            return ServiceReply(SummaryFrame.of(cached, self.device), source,
                                key, {"cache_lookup": lookup}, plan)
        # a miss after an append: catch the retained state up through the
        # delta chain instead of recomputing from scratch
        refreshed = self._try_refresh(query, plan, lookup)
        if refreshed is not None:
            return refreshed
        if gj is None:
            gj = GraphicalJoin(self.catalog, query, plan=plan,
                               record_trace=self.incremental
                               and plan.partitions == 1
                               and not plan.bags,
                               message_cache=self.message_cache,
                               corrections=self._load_corrections(),
                               device=self.device)
        gfjs = gj.run()
        # key on what the executor actually encoded: an append racing this
        # compute may have advanced the catalog past the entry snapshot,
        # and mislabeling the summary would make a later delta refresh
        # double-apply the append
        built = getattr(gj._executor, "source_versions", None) or versions
        if built != versions:
            key = cache_key_for_versions(query, built, plan=plan)
        self.cache.put(key, gfjs, tables={qt.table for qt in query.tables})
        self._persist_calibration(gj._executor.calibration())
        if self.incremental:
            self._remember_state(query, plan, gj, gfjs, built, key)
        timings = dict(gj.timings)
        timings["cache_lookup"] = lookup
        return ServiceReply(SummaryFrame.of(gfjs, self.device), "computed",
                            key, timings, plan)

    # -- incremental maintenance ------------------------------------------
    def append(self, table: str, rows) -> TableDelta:
        """Append rows to a base table; summaries refresh lazily.

        The catalog is upgraded immediately (new content version), the
        delta is queued, and compiled plans are carried forward to the new
        version — a refreshed summary must run under the plan it was built
        with, and re-planning on every append would fork the cache key.
        Nothing is recomputed here: the next `frame()` for an affected
        query chains the pending deltas through the incremental refresher
        (repro/summary/incremental.py) and upgrades the cache entry in
        place; queries never asked again never pay for the append.

        The O(table) column copy of the grown table is staged *outside*
        the service lock (a slow copy must not stall readers) but
        *serialized per table*: concurrent appenders to one hot table
        queue on the table's staging lock, so k appends cost k copies —
        the unbounded lost-race re-staging this path used to do was
        O(k²·table).  The retry loop survives only as a guard against
        out-of-band catalog mutation (a table replaced around `append`);
        the delta chain stays linear either way.
        """
        with self._lock:
            tlock = self._append_locks.setdefault(table, threading.Lock())
        with tlock:
            return self._append_staged(table, rows)

    def _append_staged(self, table: str, rows) -> TableDelta:
        """Stage + install one append (table staging lock held)."""
        while True:
            base = self.catalog[table]
            delta = base.append(rows)          # O(table) copy, unlocked
            with self._lock:
                if self.catalog.tables.get(table) is not base:
                    # only an out-of-band catalog.add can get here now:
                    # same-table appends serialize on the staging lock
                    REGISTRY.counter("service.append_restages").inc()
                    continue                   # lost the race: re-stage
                self.catalog.add(delta.new_table)
                log = self._pending.setdefault(table, [])
                # slim(): the log must not pin a full table copy per append
                log.append(delta.slim())
                del log[:max(0, len(log) - self.max_pending_deltas)]
                for pkey, (plan, tabs) in list(self._plans.items()):
                    if table not in tabs:
                        continue
                    idx = sorted(tabs).index(table)
                    if pkey[1][idx] != delta.base_version:
                        continue
                    versions = list(pkey[1])
                    versions[idx] = delta.new_version
                    self._plans.pop(pkey)
                    self._remember_plan((pkey[0], tuple(versions)), plan, tabs)
            # message fingerprints embed content versions, so the grown
            # table's old messages can never be *served* stale — but they
            # can never hit again either; reclaim their bytes eagerly
            if self.message_cache is not None:
                self.message_cache.invalidate(table)
            return delta

    def _state_key(self, query: JoinQuery, plan: PhysicalPlan) -> str:
        # literal: an IncrementalState replays this query's own trace —
        # sharing it across alias-renamed twins would splice wrong names
        return query.fingerprint(plan=plan, literal=True)

    def _remember_state(self, query: JoinQuery, plan: PhysicalPlan,
                        gj: GraphicalJoin, gfjs, versions, key: str) -> None:
        try:
            state = capture_state(gj, gfjs, versions=versions)
        except ValueError:      # ran without a trace (e.g. incremental off)
            return
        state.cache_key = key
        with self._lock:
            skey = self._state_key(query, plan)
            self._states[skey] = state
            self._states.move_to_end(skey)
            self._shrink_states()

    def _shrink_states(self) -> None:
        """LRU-evict retained states past the count AND byte bounds (lock
        held).  A state pins the elimination trace, a second GFJS, and the
        expansion cache — entry counting alone would let a few giant
        summaries dwarf the summary cache's own byte budget."""
        while len(self._states) > self.max_states or (
                len(self._states) > 1
                and sum(s.nbytes() for s in self._states.values())
                > self.max_state_bytes):
            self._states.popitem(last=False)

    def _chain_deltas(self, state: IncrementalState):
        """Pending deltas that carry ``state`` to the current catalog.

        None means the chain is broken (a table changed outside `append`,
        or the log was trimmed past the state's version) — rebuild.
        Caller holds the lock.
        """
        deltas = []
        for t in sorted({qt.table for qt in state.query.tables}):
            have = state.table_versions[t]
            want = self.catalog[t].version()
            if have == want:
                continue
            for d in self._pending.get(t, []):
                if have == want:
                    break
                if d.base_version == have:
                    deltas.append(d)
                    have = d.new_version
            if have != want:
                return None
        return deltas

    def can_refresh(self, query: JoinQuery, plan: PhysicalPlan) -> bool:
        """True if a cache miss for (query, plan) would be served by a
        delta refresh of a retained state rather than a cold GJ build.

        Advisory — the answer can go stale the moment the lock drops —
        but it is the admission gate ``repro_torch.serve.server.JoinServer``
        uses to price only genuinely cold builds: a refreshable miss
        costs O(delta), not O(full build), and must not be rejected or
        queued by a cost ceiling sized for the latter.
        """
        if not self.incremental:
            return False
        with self._lock:
            state = self._states.get(self._state_key(query, plan))
            return (state is not None
                    and self._chain_deltas(state) is not None)

    def _try_refresh(self, query: JoinQuery, plan: PhysicalPlan,
                     lookup: float) -> Optional[ServiceReply]:
        """Serve a cache miss by delta-refreshing a retained state."""
        if not self.incremental:
            return None
        with self._lock:
            state = self._states.get(self._state_key(query, plan))
            if state is None:
                return None
            deltas = self._chain_deltas(state)
        if not deltas:      # broken chain (None) or nothing to apply ([])
            return None
        t0 = time.perf_counter()
        try:
            new_state, report = refresh_state(state, deltas)
        except DeltaError:
            return None     # fall back to the cold compute path
        dt = time.perf_counter() - t0
        new_key = cache_key_for_versions(
            query, new_state.table_versions, plan=plan)
        new_state.cache_key = new_key
        old_key = state.cache_key or new_key
        with self._lock:
            # commit only if the state we refreshed from is still current:
            # a concurrent invalidate() dropped it precisely to declare its
            # history untrustworthy, and re-admitting the spliced summary
            # would resurrect that history under unchanged content versions
            skey = self._state_key(query, plan)
            if self._states.get(skey) is not state:
                return None
            # cache.refresh runs under the service lock by design: the
            # atomic pairing with the state check above is what closes the
            # invalidate() race.  Eviction spills triggered by this admit
            # are *deferred* — only the in-memory bookkeeping happens under
            # the lock; the disk writes run below, after release, so a slow
            # spill can't stall concurrent cache-hit readers.
            spills = self.cache.refresh(
                old_key, new_key, new_state.gfjs,
                tables={qt.table for qt in query.tables}, defer_spill=True)
            self.refreshes += 1
            self._states[skey] = new_state
            self._states.move_to_end(skey)
            self._shrink_states()
        self.cache.write_spills(spills)
        timings = {"cache_lookup": lookup, "refresh": dt}
        timings.update({f"refresh_{k}": v for k, v in report.items()
                        if k != "seconds"})
        return ServiceReply(SummaryFrame.of(new_state.gfjs, self.device),
                            "refreshed", new_key, timings, plan)

    def invalidate(self, table: str) -> int:
        """Force-drop cached summaries and compiled plans built on ``table``.

        Also drops retained incremental states and the table's pending
        delta log: invalidation declares the table's history untrustworthy,
        so nothing derived from it may be spliced forward.  State removal
        and cache invalidation happen under one service-lock hold, ordered
        before the cache sweep — an in-flight refresh either sees its state
        gone (and aborts) or commits first (and its entry is swept here).
        """
        with self._lock:
            self._plans = OrderedDict(
                (k, v) for k, v in self._plans.items() if table not in v[1])
            self._pending.pop(table, None)
            self._states = OrderedDict(
                (k, s) for k, s in self._states.items()
                if table not in s.table_versions)
            removed = self.cache.invalidate(table)
        if self.message_cache is not None:
            self.message_cache.invalidate(table)
        return removed

    # -- one-shot aggregate API -------------------------------------------
    def count(self, query: JoinQuery,
              where: Optional[Mapping[str, Predicate]] = None) -> int:
        return self._filtered(query, where).frame.count()

    def sum(self, query: JoinQuery, var: str,
            where: Optional[Mapping[str, Predicate]] = None):
        return self._filtered(query, where).frame.sum(var)

    def mean(self, query: JoinQuery, var: str,
             where: Optional[Mapping[str, Predicate]] = None):
        return self._filtered(query, where).frame.mean(var)

    def min(self, query: JoinQuery, var: str,
            where: Optional[Mapping[str, Predicate]] = None):
        return self._filtered(query, where).frame.min(var)

    def max(self, query: JoinQuery, var: str,
            where: Optional[Mapping[str, Predicate]] = None):
        return self._filtered(query, where).frame.max(var)

    def distinct(self, query: JoinQuery, var: str) -> np.ndarray:
        return self.frame(query).frame.distinct(var)

    def group_by(self, query: JoinQuery, keys: Union[str, Sequence[str]],
                 where: Optional[Mapping[str, Predicate]] = None,
                 **aggs: AggSpec) -> Dict[str, np.ndarray]:
        return self._filtered(query, where).frame.group_by(keys, **aggs)

    def _filtered(self, query: JoinQuery,
                  where: Optional[Mapping[str, Predicate]]) -> ServiceReply:
        reply = self.frame(query)
        if where:
            reply.frame = reply.frame.filter(where)
        return reply

    # -- observability -----------------------------------------------------
    def stats(self) -> Dict[str, int]:
        out = self.cache.stats.as_dict()
        with self._lock:
            out["requests"] = self.requests
            out["compiled_plans"] = len(self._plans)
            out["refreshed_requests"] = self.refreshes
            out["retained_states"] = len(self._states)
            out["pending_deltas"] = sum(
                len(v) for v in self._pending.values())
        out["resident_bytes"] = self.cache.resident_bytes
        out["resident_entries"] = len(self.cache)
        if self.message_cache is not None:
            for k, v in self.message_cache.stats.as_dict().items():
                out[f"msgcache_{k}"] = v
            out["msgcache_resident_bytes"] = \
                self.message_cache.resident_bytes
            out["msgcache_entries"] = len(self.message_cache)
        return out
