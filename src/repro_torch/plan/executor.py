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
search and injects cached messages into untraced, bagless, monolithic
builds.

A plan with ``partitions`` > 1 builds a ``ShardedGFJS``
(``dist/partition.py``): each shard's generator and GFJS from its hash
slice of the encoded potentials, on worker threads that each generate
with the torch engine on the executor's device (one card, its default
stream), or with ``shard_executor="process"`` on numpy in the spawn pool
of ``dist/actions.py``.  A sharded GFJS desummarizes shard by shard on
the device, each shard into its slice of one preallocated column.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.elimination import Generator, build_generator
from repro_torch.core.gfjs import (GFJS, ShardedGFJS, desummarize,
                                   generate_gfjs, stream_desummarize)
from repro_torch.obs.metrics import REGISTRY, MetricsRegistry
from repro_torch.obs.trace import (Tracer, ambient_tracer, span as obs_span,
                                   span_in)
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
                 partition_var: Optional[str] = None,
                 partition_fold: Optional[int] = None,
                 shard_executor: Optional[str] = None,
                 shard_timeout: Optional[float] = None,
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
        # hash-partitioned execution (repro_torch/dist/partition.py): > 1
        # makes summarize() produce a ShardedGFJS; record_trace is refused
        # with it below (partitioned summaries rebuild on append)
        self.partitions = partitions
        self.partition_var = partition_var
        # process-parallel shards (repro_torch/dist/actions.py): "process"
        # sends numpy shard builds to the spawn pool; fold over-partitions
        # for skew smoothing; shard_timeout (seconds) bounds each action
        # before the degrade-to-thread retry — a runtime knob, not plan
        # identity, so it lives here and not on the PhysicalPlan
        self.partition_fold = partition_fold
        self.shard_executor = shard_executor
        self.shard_timeout = shard_timeout
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
        self.timings: Dict[str, float] = {}
        self.enc: Optional[EncodedQuery] = None
        self.logical: Optional[LogicalPlan] = None
        self.plan: Optional[PhysicalPlan] = plan
        self._forced_plan = plan is not None
        self.generator: Optional[Generator] = None
        # a partitioned run has no monolithic generator to memoize, so the
        # merged summary itself is kept (cleared on build_model re-entry)
        self._sharded: Optional[ShardedGFJS] = None
        self.source_versions: Optional[Dict[str, str]] = None
        # per-level (src, cidx) gather indices of the last traced summarize,
        # which incremental refresh splices
        self.expansion_cache = None
        self.refresh_report: Dict[str, float] = {}
        # plan feedback: measured per-step product sizes and wall times.
        # Partitioned runs sum the products over shards, keep the per-step
        # max seconds in step_seconds and the sum in step_seconds_sum, and
        # the per-shard picture in shard_report
        self.step_actuals: Dict[str, float] = {}
        self.step_seconds: Dict[str, float] = {}
        self.step_seconds_sum: Dict[str, float] = {}
        self.shard_report: Optional[Dict[str, Any]] = None
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
        self._sharded = None
        self.expansion_cache = None
        self.step_actuals = {}
        self.step_seconds = {}
        self.step_seconds_sum = {}
        self.shard_report = None
        self.bag_actuals = {}
        self.bag_seconds = {}
        self.cached_steps = ()
        if not self._forced_plan:
            self.plan = None
        self.timings = {}

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
                # potentials the generator needs (none under a partitioned
                # plan: each shard derives its own from its slice)
                from repro_torch.core.potentials import Factor
                from repro_torch.plan.search import build_logical_plan
                sizes = self.enc.domain_sizes()
                factors = [] if self.plan.partitions > 1 else \
                    [Factor.from_columns(cols, sizes)
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
                    partition_var=self.partition_var,
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
            self.step_seconds_sum = dict(self.generator.step_seconds)
            self.bag_actuals = {j: float(n) for j, n
                                in self.generator.bag_products.items()}
            self.bag_seconds = dict(self.generator.bag_seconds)
            self.cached_steps = tuple(self.generator.cached_steps)
            self.timings["build_generator"] = time.perf_counter() - t0
        return self

    def summarize(self) -> Union[GFJS, ShardedGFJS]:
        plan = self.build_plan()
        if plan.partitions > 1:
            return self._summarize_partitioned(plan)
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

    def _summarize_partitioned(self, plan: PhysicalPlan) -> ShardedGFJS:
        """Hash-partitioned build: independent shard pipelines, merged view.

        Each shard gets its own generator + GFJS over the shard's slice of
        the partitioned potentials (replicated potentials are shared by
        reference).  Under the torch backend every shard thread generates
        with ``engine.generate_gfjs`` on the executor's device, so each
        shard's GFJS keeps its own device memo; the threads share the
        card's default stream, so their host work overlaps and their
        kernels queue in launch order.  ``record_trace`` is refused in
        ``__init__``: partitioned summaries fall back to rebuild on appends
        (the service handles that transparently).

        Per-step actuals are *summed* over shards (the shards partition
        the monolithic product exactly).  Per-step seconds keep the FULL
        per-shard matrix (``shard_report["step_seconds"]``), exposed two
        ways: ``step_seconds`` is the per-step max (the critical path),
        ``step_seconds_sum`` the total work.  Shard spans are opened from
        worker threads with the summarize phase span handed across
        explicitly (ambient context never crosses the pool boundary).

        ``plan.partition_fold`` > 1 cuts ``partitions * fold`` *virtual*
        shards: the pool still runs ``partitions`` workers, and free
        workers pulling queued shards is the fold that smooths hash skew
        (DESIGN §17).  ``plan.shard_executor == "process"`` dispatches the
        virtual shards to the repro_torch/dist/actions.py spawn pool, where
        they generate on numpy — except under the torch backend, as the
        reference keeps its jax backend on threads: the device work already
        overlaps across threads, and a worker must never open a second CUDA
        context.  Worker span records are grafted under the summarize phase
        span and worker metrics merged into this executor's registry, so
        explain(analyze=True)/shard_report keep the same shape on every
        path.
        """
        if plan.bags:
            # plan_query refuses hybrid + partitions; this catches
            # hand-built plans arriving through the pre-compiled path
            raise ValueError(
                "hypertree bag steps are unsupported under a partitioned "
                "plan: bag potentials are built monolithically")
        if self._sharded is not None:
            return self._sharded
        from repro_torch.dist.partition import (PartitionScheme,
                                                partition_encoded)
        nshards = plan.partitions * max(1, plan.partition_fold)
        with self._phase("partition", partitions=plan.partitions,
                         partition_var=plan.partition_var,
                         fold=plan.partition_fold):
            t0 = time.perf_counter()
            scheme = PartitionScheme(plan.partition_var, nshards)
            shard_encs = partition_encoded(self.enc, scheme)
            self.timings["partition"] = time.perf_counter() - t0

        backend = plan.backends.get("summarize", "torch")
        order = list(plan.order)
        # expected per-shard product: the shards partition the monolithic
        # product exactly, so 1/nshards of the planner estimate per step
        shard_est = {s.var: s.product_entries / nshards
                     for s in plan.steps}
        use_process = plan.shard_executor == "process" and backend != "torch"

        with self._phase("summarize", backend=backend,
                         partitions=plan.partitions,
                         executor=plan.shard_executor) as parent_sp:
            tracer = self.tracer if self.tracer is not None \
                else ambient_tracer()
            t1 = time.perf_counter()
            if use_process:
                shards, shard_walls, shard_matrix, shard_spans, \
                    shard_products, retries = self._run_shards_process(
                        plan, shard_encs, order, shard_est, parent_sp,
                        tracer)
            else:
                shards, shard_walls, shard_matrix, shard_spans, \
                    shard_products, retries = self._run_shards_thread(
                        plan, shard_encs, order, shard_est, backend,
                        parent_sp, tracer)

            self.step_actuals = {}
            self.step_seconds = {}
            self.step_seconds_sum = {}
            for products, seconds in zip(shard_products, shard_matrix):
                for v, n in products.items():
                    self.step_actuals[v] = \
                        self.step_actuals.get(v, 0.0) + float(n)
                for v, dt in seconds.items():
                    self.step_seconds[v] = \
                        max(self.step_seconds.get(v, 0.0), dt)
                    self.step_seconds_sum[v] = \
                        self.step_seconds_sum.get(v, 0.0) + dt
            sharded = ShardedGFJS(
                shards=shards,
                column_order=list(shards[0].column_order),
                join_size=int(sum(s.join_size for s in shards)),
                domains=self.enc.domains,
                partition_var=scheme.var,
                salt=scheme.salt,
            )
            self.timings["summarize"] = time.perf_counter() - t1
            self.shard_report = self._make_shard_report(
                sharded, shard_walls, shard_matrix, shard_spans,
                workers=plan.partitions,
                executor="process" if use_process else "thread",
                retries=retries)
        self._sharded = sharded
        return sharded

    def _run_shards_thread(self, plan, shard_encs, order, shard_est,
                           backend, parent_sp, tracer):
        """``partitions`` worker threads pull the (possibly
        over-partitioned) shard queue; under the torch backend each
        generates on the executor's device."""

        def run_shard(item):
            i, enc_s = item
            t_s = time.perf_counter()
            with span_in(tracer, parent_sp, f"shard:{i}", cat="shard",
                         shard=i) as sp:
                gen = build_generator(
                    enc_s, elimination_order=order,
                    early_projection=plan.early_projection,
                    step_estimates=shard_est)
                if backend == "torch":
                    gfjs = engine.generate_gfjs(gen, enc_s.domains,
                                                device=self.device)
                else:
                    gfjs = generate_gfjs(gen, enc_s.domains)
                sp.set(rows=gfjs.join_size)
            return gen, gfjs, time.perf_counter() - t_s, sp

        with ThreadPoolExecutor(max_workers=plan.partitions) as pool:
            results = list(pool.map(run_shard, enumerate(shard_encs)))
        return ([gfjs for _, gfjs, _, _ in results],
                [w for _, _, w, _ in results],
                [dict(g.step_seconds) for g, _, _, _ in results],
                [sp for _, _, _, sp in results],
                [dict(g.step_products) for g, _, _, _ in results],
                0)

    def _run_shards_process(self, plan, shard_encs, order, shard_est,
                            parent_sp, tracer):
        """Dispatch numpy shard builds to the repro_torch/dist/actions.py
        spawn pool.

        One :class:`ShardBuildAction` per virtual shard; the shared
        persistent pool runs ``plan.partitions`` worker processes.  Each
        reply's span records are grafted under the summarize phase span —
        rebased so the worker's root lands at its observed completion time
        (worker and coordinator ``perf_counter`` epochs are otherwise
        incomparable) — and its metrics snapshot is merged, so the
        analyze/report surface matches the thread path shape-for-shape.
        A failed or timed-out worker already came back via the inline
        thread retry inside the pool (degrade, don't kill the query).
        """
        from repro_torch.dist.actions import (ShardBuildAction,
                                              shared_shard_executor)
        from repro_torch.obs.trace import NULL_SPAN
        actions = [
            ShardBuildAction(shard=i, enc=enc_s, order=tuple(order),
                             early_projection=plan.early_projection,
                             backend="numpy", step_estimates=shard_est)
            for i, enc_s in enumerate(shard_encs)]
        pool = shared_shard_executor(plan.partitions)
        outcomes = pool.run(actions, timeout=self.shard_timeout)

        shards, walls, matrix, spans, products = [], [], [], [], []
        retries = 0
        for out in outcomes:
            res = out.result
            retries += 1 if out.retried else 0
            shards.append(res.gfjs)
            walls.append(res.build_seconds)
            matrix.append(dict(res.step_seconds))
            products.append(dict(res.step_products))
            if res.metrics:
                self.metrics.merge(res.metrics)
            root = NULL_SPAN
            if tracer is not None and res.spans:
                # the worker's root span is its last-closed record; rebase
                # so it ends at the observed completion instant (graft
                # ignores a non-Span parent, so NULL_SPAN is safe)
                offset = out.t_done - float(res.spans[-1]["t1"])
                grafted = tracer.graft(res.spans, parent=parent_sp,
                                       offset=offset)
                root = grafted[-1]
                root.set(retried=out.retried)
            spans.append(root)
        return shards, walls, matrix, spans, products, retries

    def _make_shard_report(self, sharded: ShardedGFJS,
                           walls: List[float],
                           matrix: List[Dict[str, float]],
                           spans: List[Any], *,
                           workers: Optional[int] = None,
                           executor: str = "thread",
                           retries: int = 0) -> Dict[str, Any]:
        """Per-shard breakdown + skew + stragglers: what
        explain(analyze=True) renders.

        Skew is computed over per-*worker* loads: the (possibly
        over-partitioned) virtual-shard sizes/walls are folded onto
        ``workers`` bins first (repro_torch/dist/partition.py::fold_loads —
        the same LPT model the planner used to pick the fold), so fold=1
        degenerates to per-shard skew and fold>1 reports the balance the
        pool actually achieves, not the raw hash spread.
        """
        from repro_torch.dist.partition import fold_loads
        from repro_torch.ft.straggler import flag_shard_stragglers
        workers = len(sharded.shards) if workers is None else workers
        sizes = [int(s.join_size) for s in sharded.shards]
        w_sizes = fold_loads(sizes, workers)
        w_walls = fold_loads(walls, workers)
        mean_size = float(w_sizes.mean()) if len(w_sizes) else 0.0
        mean_wall = float(w_walls.mean()) if len(w_walls) else 0.0
        skew = float(w_sizes.max()) / mean_size if mean_size > 0 else 1.0
        time_skew = float(w_walls.max()) / mean_wall if mean_wall > 0 else 1.0
        stragglers = flag_shard_stragglers(walls)
        straggler_ids = {s.shard for s in stragglers}
        for i, sp in enumerate(spans):
            sp.set(wall_seconds=walls[i], straggler=i in straggler_ids)
        self.metrics.gauge("dist.shard_skew", unit="x").set(skew)
        self.metrics.gauge("dist.time_skew", unit="x").set(time_skew)
        if stragglers:
            self.metrics.counter("dist.stragglers").inc(len(stragglers))
        if retries:
            self.metrics.counter("dist.shard_degraded").inc(retries)
        for w in walls:
            self.metrics.histogram("dist.shard_seconds", unit="s").observe(w)
        return {
            "sizes": sizes,
            "seconds": list(walls),
            "step_seconds": matrix,
            "skew": skew,
            "time_skew": time_skew,
            "stragglers": stragglers,
            "executor": executor,
            "workers": workers,
            "retries": retries,
        }

    def run(self) -> Union[GFJS, ShardedGFJS]:
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
    def desummarize(self, gfjs: Union[GFJS, ShardedGFJS], *,
                    decode: bool = True
                    ) -> Dict[str, Union[torch.Tensor, np.ndarray]]:
        """Full expansion on the torch engine.

        ``decode=True`` returns numpy arrays of raw values; ``decode=False``
        keeps the codes on the executor's device as tensors.  A join size
        past the int32 kernel range expands on numpy instead (counted in
        ``engine.numpy_fallbacks``), as in the reference.  A sharded
        summary expands shard by shard, in shard order, each shard into
        its slice of one preallocated column per variable
        (``engine.desummarize_sharded``); a shard past the int32 kernel
        range raises there.
        """
        with self._phase("desummarize", backend="torch",
                         rows=gfjs.join_size) as sp:
            t0 = time.perf_counter()
            if isinstance(gfjs, ShardedGFJS):
                out = engine.desummarize_sharded(gfjs, decode=decode,
                                                 device=self.device)
            elif gfjs.join_size > engine.I32_MAX:
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

    def materialize(self, gfjs: Union[GFJS, ShardedGFJS], *,
                    decode: bool = True,
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
        measured seconds (max and summed over shards) to the estimates,
        drift and calibration, and the per-shard breakdown with its
        stragglers."""
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
                      step_seconds_sum=self.step_seconds_sum,
                      shard_report=self.shard_report,
                      bag_seconds=self.bag_seconds)
        return plan.explain(**kw)
