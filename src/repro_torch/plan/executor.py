"""Executor — runs a PhysicalPlan phase by phase (the monolithic path).

Port of ``src/repro/plan/executor.py`` for one query on one device.  The
host phases (encode, potentials, plan, eliminate) are the numpy code the
reference runs; the two device phases — GFJS generation and
desummarization — run on the torch engine (``core/engine.py``) on the
executor's explicit ``device``.  Per-phase wall times land in ``timings``
under the reference's keys, and ``explain()`` renders the plan annotated
with whatever has been measured so far.

``record_trace`` keeps the elimination trace and the expansion indices
that ``capture_state`` / ``refresh`` (``summary/incremental.py``) replay;
a traced build generates on numpy, as in the reference.  A
``message_cache`` (``summary/msgcache.py``) prices residency in the plan
search and injects cached messages into untraced, bagless builds.

Not ported yet (ROADMAP.md queue 1): partitioned builds.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.elimination import Generator, build_generator
from repro_torch.core.gfjs import (GFJS, desummarize, generate_gfjs,
                                   stream_desummarize)
from repro_torch.obs.metrics import REGISTRY, MetricsRegistry, TimingsView
from repro_torch.obs.trace import Tracer, span as obs_span
from repro_torch.plan.ir import LogicalPlan, PhysicalPlan
from repro_torch.plan.search import STREAM_THRESHOLD, plan_query
from repro_torch.plan.stats import QueryStats
from repro_torch.relational.encoding import EncodedQuery, encode_query
from repro_torch.relational.query import JoinQuery
from repro_torch.relational.table import Catalog


class Executor:
    """Drive one query through encode → plan → generator → summarize."""

    def __init__(self, catalog: Catalog, query: JoinQuery, *,
                 elimination_order: Optional[Sequence[str]] = None,
                 early_projection: bool = True,
                 planner: str = "cost",
                 plan: Optional[PhysicalPlan] = None,
                 record_trace: bool = False,
                 generation_backend: Optional[str] = None,
                 partitions: Optional[int] = None,
                 partition_fold: Optional[int] = None,
                 shard_executor: Optional[str] = None,
                 hybrid: Optional[bool] = None,
                 message_cache=None,
                 corrections: Optional[Dict[str, float]] = None,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 device: Union[str, torch.device] = "cuda") -> None:
        self.catalog = catalog
        self.query = query
        self.device = engine.resolve_device(device)
        self.tracer = tracer
        self.metrics = metrics if metrics is not None else REGISTRY
        self.elimination_order = elimination_order
        self.early_projection = early_projection
        self.planner = planner
        self.record_trace = record_trace
        # pins plan.backends["summarize"]: "numpy" (dynamic-shape oracle) or
        # "torch" (device-resident core/engine.py::generate_gfjs)
        self.generation_backend = generation_backend
        # not ported yet: plan_query refuses partitions > 1 by name rather
        # than silently building monolithically; fold and shard executor
        # are validated there against a monolithic plan
        self.partitions = partitions
        self.partition_fold = partition_fold
        self.shard_executor = shard_executor
        # cross-query message reuse: probed per elimination step under the
        # plan-time subtree fingerprints; traced and bagged builds bypass it
        self.message_cache = message_cache
        # hypertree-decomposed hybrid GJ/WCOJ execution: None = let the
        # cost model pick, True = force bags on a cyclic query, False = GJ.
        # Incremental refresh cannot replay bag potentials, so record_trace
        # forces pure GJ, and an explicit conflict is refused here
        self.hybrid = hybrid
        self.corrections = dict(corrections) if corrections else None
        if record_trace and hybrid is True:
            raise ValueError(
                "record_trace is unsupported with hybrid=True: bag "
                "potentials merge table occurrences, breaking the "
                "per-occurrence wiring incremental refresh replays")
        if record_trace and plan is not None and plan.bags:
            raise ValueError(
                "record_trace is unsupported for a pre-compiled plan with "
                "bag steps (see hybrid=True)")
        if record_trace and (
                (partitions is not None and partitions > 1)
                or (plan is not None and plan.partitions > 1)):
            raise ValueError(
                "record_trace is unsupported under a partitioned plan: "
                "splice-based incremental refresh does not understand "
                "shard structure (partitioned summaries rebuild on append)")
        self.timings: Dict[str, float] = TimingsView(self.metrics)
        self.enc: Optional[EncodedQuery] = None
        self.logical: Optional[LogicalPlan] = None
        self.plan: Optional[PhysicalPlan] = plan
        self._forced_plan = plan is not None
        self.generator: Optional[Generator] = None
        self.source_versions: Optional[Dict[str, str]] = None
        # per-level (src, cidx) gather indices of the last traced summarize,
        # which incremental refresh splices
        self.expansion_cache = None
        self.refresh_report: Dict[str, float] = {}
        # plan feedback: measured per-step product sizes and wall times
        self.step_actuals: Dict[str, float] = {}
        self.step_seconds: Dict[str, float] = {}
        self.bag_actuals: Dict[int, float] = {}
        self.bag_seconds: Dict[int, float] = {}
        # variables the last build took from the message cache
        self.cached_steps: Tuple[str, ...] = ()

    # -- observability plumbing --------------------------------------------
    def _phase(self, name: str, **args):
        """A ``phase:<name>`` span on this executor's tracer, the ambient
        tracer, or the shared no-op — in that order."""
        if self.tracer is not None:
            return self.tracer.span(f"phase:{name}", cat="phase", **args)
        return obs_span(f"phase:{name}", cat="phase", **args)

    # -- phases ------------------------------------------------------------
    def build_model(self) -> "Executor":
        """Encode the query; re-entry resets every downstream product.

        The base tables are snapshotted once up front, and
        ``source_versions`` records exactly what was encoded.
        """
        self._reset_downstream()
        with self._phase("build_model"):
            t0 = time.perf_counter()
            snapshot = {qt.table: self.catalog[qt.table]
                        for qt in self.query.tables}
            self.enc = encode_query(Catalog(dict(snapshot)), self.query)
            self.source_versions = {n: t.version()
                                    for n, t in snapshot.items()}
            self.timings["build_model"] = time.perf_counter() - t0
        return self

    def _reset_downstream(self) -> None:
        self.enc = None
        self.logical = None
        self.generator = None
        self.expansion_cache = None
        self.step_actuals = {}
        self.step_seconds = {}
        self.bag_actuals = {}
        self.bag_seconds = {}
        self.cached_steps = ()
        if not self._forced_plan:
            self.plan = None
        self.timings = TimingsView(self.metrics)

    def build_plan(self) -> PhysicalPlan:
        """Logical plan + order search + physical pinning (cached)."""
        if self.enc is None:
            self.build_model()
        if self.plan is not None and self.logical is not None:
            return self.plan
        with self._phase("plan", planner=self.planner):
            t0 = time.perf_counter()
            if self.plan is not None:
                # pre-compiled plan: every choice is already pinned, so
                # skip the statistics pass and the search; build only the
                # potentials the generator needs
                from repro_torch.core.potentials import Factor
                from repro_torch.plan.search import build_logical_plan
                sizes = self.enc.domain_sizes()
                factors = [Factor.from_columns(cols, sizes)
                           for cols in self.enc.encoded_tables]
                self.logical = build_logical_plan(
                    self.enc, early_projection=self.plan.early_projection,
                    stats=QueryStats(sizes, factors, []))
            else:
                self.logical, self.plan = plan_query(
                    self.enc,
                    elimination_order=self.elimination_order,
                    early_projection=self.early_projection,
                    planner=self.planner,
                    generation_backend=self.generation_backend,
                    partitions=self.partitions,
                    partition_fold=self.partition_fold,
                    shard_executor=self.shard_executor,
                    # trace capability wins over a cost-picked hybrid
                    hybrid=False if self.record_trace else self.hybrid,
                    corrections=self.corrections,
                    # residency pricing only for builds that can consume
                    # cached messages
                    message_cache=(None if self.record_trace
                                   else self.message_cache),
                    table_versions=self.source_versions)
            self.timings["plan"] = time.perf_counter() - t0
        return self.plan

    def build_generator(self) -> "Executor":
        plan = self.build_plan()
        with self._phase("build_generator"):
            t0 = time.perf_counter()
            msg_fps = msg_sources = None
            if (self.message_cache is not None and not self.record_trace
                    and not plan.bags and plan.partitions == 1):
                from repro_torch.plan.ir import step_fingerprints
                msg_fps, msg_sources = step_fingerprints(
                    self.enc, plan.order, self.enc.query.output_variables,
                    self.source_versions)
            self.generator = build_generator(
                self.enc,
                elimination_order=list(plan.order),
                early_projection=plan.early_projection,
                factors=list(self.logical.stats.factors) or None,
                record_trace=self.record_trace,
                step_estimates={s.var: s.product_entries for s in plan.steps},
                bags=plan.bags or None,
                bag_estimates={j: b.est_entries
                               for j, b in enumerate(plan.bags)},
                message_cache=self.message_cache if msg_fps else None,
                step_fingerprints=msg_fps,
                step_sources=msg_sources,
            )
            self.step_actuals = {v: float(n) for v, n
                                 in self.generator.step_products.items()}
            self.step_seconds = dict(self.generator.step_seconds)
            self.bag_actuals = {j: float(n) for j, n
                                in self.generator.bag_products.items()}
            self.bag_seconds = dict(self.generator.bag_seconds)
            self.cached_steps = tuple(self.generator.cached_steps)
            self.timings["build_generator"] = time.perf_counter() - t0
        return self

    def summarize(self) -> GFJS:
        plan = self.build_plan()
        if self.generator is None:
            self.build_generator()
        # trace capture needs the host (src, cidx) gather indices that
        # splice-based incremental refresh replays: numpy only, as in the
        # reference
        backend = "numpy" if self.record_trace else \
            plan.backends.get("summarize", "torch")
        self.expansion_cache = [] if self.record_trace else None
        with self._phase("summarize", backend=backend):
            t0 = time.perf_counter()
            if backend == "torch":
                gfjs = engine.generate_gfjs(self.generator, self.enc.domains,
                                            device=self.device)
            else:
                gfjs = generate_gfjs(self.generator, self.enc.domains,
                                     self.expansion_cache)
            self.timings["summarize"] = time.perf_counter() - t0
        return gfjs

    def run(self) -> GFJS:
        return self.summarize()

    # -- incremental refresh ----------------------------------------------
    def capture_state(self, gfjs: GFJS, versions=None):
        """Snapshot this run for later delta refreshes (record_trace only)."""
        from repro_torch.summary.incremental import capture_state
        return capture_state(self, gfjs, versions=versions)

    def refresh(self, state, deltas):
        """The ``refresh`` phase: apply appends to a captured state.

        Re-encodes only the appended blocks, re-runs only the dirty
        elimination steps, and splices the result into the retained
        summary (numpy, as in the reference: the refreshed GFJS has no
        device memo, so its first desummarize on the card uploads each
        level once).  Wall time lands in ``timings["refresh"]``; the
        refreshed generator is adopted so ``desummarize`` / ``explain``
        keep working.
        """
        from repro_torch.summary.incremental import refresh_state
        if not isinstance(deltas, (list, tuple)):
            deltas = [deltas]
        with self._phase("refresh"):
            t0 = time.perf_counter()
            new_state, report = refresh_state(state, deltas)
            self.timings["refresh"] = time.perf_counter() - t0
        self.generator = new_state.generator
        self.expansion_cache = new_state.expansion_cache
        self.source_versions = dict(new_state.table_versions)
        if self.enc is not None:
            # domains advance with the refresh so desummarize decodes
            # through the grown dictionaries; the encoded base columns are
            # not re-read (re-enter build_model to re-derive them)
            self.enc = EncodedQuery(self.enc.query, new_state.domains,
                                    self.enc.encoded_tables)
        self.refresh_report = report
        return new_state

    # -- plan-directed materialization ------------------------------------
    def desummarize(self, gfjs: GFJS, *, decode: bool = True
                    ) -> Dict[str, Union[torch.Tensor, np.ndarray]]:
        """Full expansion on the torch engine.

        ``decode=True`` returns numpy arrays of raw values; ``decode=False``
        keeps the codes on the executor's device as tensors.  A join size
        past the int32 kernel range expands on numpy instead (counted in
        ``engine.numpy_fallbacks``), as in the reference.
        """
        with self._phase("desummarize", backend="torch",
                         rows=gfjs.join_size) as sp:
            t0 = time.perf_counter()
            if gfjs.join_size > engine.I32_MAX:
                engine.count_numpy_fallback(sp, "join size past int32")
                out = desummarize(gfjs, decode=decode)
                if not decode:
                    out = {v: torch.from_numpy(c).to(self.device)
                           for v, c in out.items()}
            else:
                out = engine.desummarize(gfjs, decode=decode,
                                         device=self.device)
            self.timings["desummarize"] = time.perf_counter() - t0
        return out

    def materialize(self, gfjs: GFJS, *, decode: bool = True,
                    chunk_rows: int = 1 << 20
                    ) -> Union[Dict[str, Union[torch.Tensor, np.ndarray]],
                               Iterator[Dict[str, np.ndarray]]]:
        """In-memory dict or a row-chunk iterator.

        The plan's pinned choice is a hint from distinct-key estimates; the
        exact join size makes the final call — a duplication-heavy join
        must stream regardless of what the planner guessed.
        """
        plan_streams = self.plan is not None and \
            self.plan.materialize == "stream"
        if plan_streams or gfjs.join_size > STREAM_THRESHOLD:
            return stream_desummarize(gfjs, chunk_rows, decode=decode)
        return self.desummarize(gfjs, decode=decode)

    # -- observability -----------------------------------------------------
    def calibration(self) -> Dict[str, float]:
        """Per-op correction factors from the last build's est-vs-actual
        drift (geometric mean of actual/est, per CostModel.drift_factor)."""
        from repro_torch.plan.cost import CostModel
        plan = self.plan
        if plan is None:
            return {}
        out: Dict[str, float] = {}
        if self.step_actuals:
            est = {s.var: float(s.product_entries) for s in plan.steps}
            out["eliminate"] = CostModel.drift_factor(est, self.step_actuals)
        if self.bag_actuals:
            est = {j: float(b.est_entries) for j, b in enumerate(plan.bags)}
            out["bag"] = CostModel.drift_factor(est, self.bag_actuals)
        return out

    def explain(self, *, analyze: bool = False) -> str:
        """Render the plan; ``analyze=True`` adds per-step and per-bag
        measured seconds to the estimates, drift and calibration."""
        plan = self.build_plan()
        calibration = self.calibration() or None
        calibration_source = "measured"
        if calibration is None and self.corrections:
            calibration = dict(self.corrections)
            calibration_source = "loaded"
        kw = dict(timings=self.timings, actuals=self.step_actuals,
                  bag_actuals=self.bag_actuals, calibration=calibration,
                  calibration_source=calibration_source,
                  cached_steps=self.cached_steps or None)
        if analyze:
            kw.update(step_seconds=self.step_seconds,
                      bag_seconds=self.bag_seconds)
        return plan.explain(**kw)
