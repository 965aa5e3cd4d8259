"""Public Graphical Join API of the port — a thin facade over plan + execute.

    gj = GraphicalJoin(catalog, query)            # device="cuda" by default
    gfjs = gj.run()         # encode -> plan -> eliminate -> generate (device)
    print(gj.explain())     # order, per-step estimates, backends, timings
    result = gj.desummarize(gfjs)                 # O(|Q|), on the device
    n = gj.aggregate("count", by=["A"], gfjs=gfjs)  # O(runs), from the GFJS
    gj.store(gfjs, "q.gfjs"); gfjs = GraphicalJoin.load("q.gfjs")
    state = gj.capture_state(gfjs)                # with record_trace=True
    state = gj.refresh(state, catalog.append("t", rows))

Same surface as ``repro.core.api.GraphicalJoin`` for the monolithic path,
incremental refresh, the message cache, the summary algebra and storage;
``device`` names where the device phases and the aggregates' reductions
run (``"cpu"`` runs the plain PyTorch versions of the kernels, and
``"cuda"`` without a card raises).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core.elimination import Generator
from repro_torch.core.gfjs import GFJS, desummarize_range, stream_desummarize
from repro_torch.core.storage import load_gfjs, save_gfjs
from repro_torch.plan.executor import Executor
from repro_torch.plan.ir import PhysicalPlan
from repro_torch.relational.encoding import EncodedQuery
from repro_torch.relational.query import JoinQuery
from repro_torch.relational.table import Catalog


class GraphicalJoin:
    """End-to-end driver for the Graphical Join.

    ``elimination_order`` forces an order (bypassing the search);
    ``planner`` selects the search mode ("cost" or "min_fill"); ``plan``
    injects a pre-compiled :class:`PhysicalPlan` (the ``JoinService``
    serve path); ``record_trace`` keeps the elimination trace and the
    expansion indices so ``capture_state`` / ``refresh`` can maintain the
    summary on base-table appends (``summary/incremental.py``; a traced
    build generates on numpy, as in the reference); ``generation_backend``
    pins GFJS generation to "numpy" (the dynamic-shape oracle) or "torch"
    (the device-resident frontier, the default); ``hybrid`` controls
    hypertree-decomposed GJ/WCOJ execution on cyclic queries;
    ``message_cache`` plugs a
    :class:`repro_torch.summary.msgcache.MessageCache` into planning
    (residency pricing) and elimination (cached messages are injected;
    traced and bagged builds bypass it); ``corrections`` seeds the cost
    model with calibration ratios; ``tracer`` / ``metrics`` plug a
    :class:`repro_torch.obs.trace.Tracer` /
    :class:`repro_torch.obs.metrics.MetricsRegistry` into every phase.
    ``partitions`` > 1 is not ported yet and raises
    :class:`NotImplementedError` when the plan is built;
    ``partition_fold`` and ``shard_executor`` are accepted as in the
    reference and refused there for a monolithic plan.
    """

    def __init__(
        self,
        catalog: Catalog,
        query: JoinQuery,
        *,
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
        tracer=None,
        metrics=None,
        message_cache=None,
        corrections: Optional[Dict[str, float]] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        self.catalog = catalog
        self.query = query
        self._executor = Executor(
            catalog, query,
            elimination_order=elimination_order,
            early_projection=early_projection,
            planner=planner,
            plan=plan,
            record_trace=record_trace,
            generation_backend=generation_backend,
            partitions=partitions,
            partition_fold=partition_fold,
            shard_executor=shard_executor,
            hybrid=hybrid,
            tracer=tracer,
            metrics=metrics,
            message_cache=message_cache,
            corrections=corrections,
            device=device,
        )

    # -- executor state, exposed under the reference's names ---------------
    @property
    def timings(self) -> Dict[str, float]:
        return self._executor.timings

    @property
    def enc(self) -> Optional[EncodedQuery]:
        return self._executor.enc

    @property
    def generator(self) -> Optional[Generator]:
        return self._executor.generator

    @property
    def device(self) -> torch.device:
        return self._executor.device

    # configuration writes pass through to the executor and discard a
    # pending plan, so the next phase re-plans
    @property
    def elimination_order(self) -> Optional[Sequence[str]]:
        return self._executor.elimination_order

    @elimination_order.setter
    def elimination_order(self, value: Optional[Sequence[str]]) -> None:
        self._executor.elimination_order = value
        self._invalidate_plan()

    @property
    def early_projection(self) -> bool:
        return self._executor.early_projection

    @early_projection.setter
    def early_projection(self, value: bool) -> None:
        self._executor.early_projection = value
        self._invalidate_plan()

    def _invalidate_plan(self) -> None:
        ex = self._executor
        if not ex._forced_plan:
            ex.plan = None
            ex.logical = None
            ex.generator = None

    # -- phases ------------------------------------------------------------
    def build_model(self) -> "GraphicalJoin":
        """Encode; calling it again clears every downstream product."""
        self._executor.build_model()
        return self

    def plan(self) -> PhysicalPlan:
        """The physical plan (computed on first use, then pinned)."""
        return self._executor.build_plan()

    def build_generator(self) -> "GraphicalJoin":
        self._executor.build_generator()
        return self

    def summarize(self) -> GFJS:
        return self._executor.summarize()

    # -- convenience -------------------------------------------------------
    def join_size(self) -> int:
        """|Q| without touching the data again (sum of the root marginal)."""
        if self.generator is None:
            self.build_generator()
        return self.generator.join_size

    def run(self) -> GFJS:
        """build_model -> plan -> build_generator -> summarize."""
        return self.summarize()

    # -- incremental maintenance ------------------------------------------
    def capture_state(self, gfjs: GFJS, versions=None):
        """Snapshot for later delta refreshes (requires record_trace=True)."""
        return self._executor.capture_state(gfjs, versions=versions)

    def refresh(self, state, deltas):
        """Apply table appends to a captured state (the ``refresh`` phase).

            gj = GraphicalJoin(cat, query, record_trace=True, device="cpu")
            gfjs = gj.run(); state = gj.capture_state(gfjs)
            delta = cat.append("user_friends", rows)
            state = gj.refresh(state, delta)     # state.gfjs is the new summary

        Only the appended block is encoded and only the dirty elimination
        steps re-run; ``timings["refresh"]`` holds the wall time.
        """
        return self._executor.refresh(state, deltas)

    def explain(self, *, analyze: bool = False) -> str:
        """Render the plan, annotated with any timings measured so far."""
        return self._executor.explain(analyze=analyze)

    def desummarize(self, gfjs: GFJS, *, decode: bool = True
                    ) -> Dict[str, Union[torch.Tensor, np.ndarray]]:
        """All |Q| rows: numpy raw values, or (``decode=False``) int32 code
        tensors kept on the device."""
        return self._executor.desummarize(gfjs, decode=decode)

    def desummarize_range(self, gfjs: GFJS, lo: int, hi: int, *,
                          decode: bool = True) -> Dict[str, np.ndarray]:
        """Rows [lo, hi) on the host (numpy)."""
        return desummarize_range(gfjs, lo, hi, decode=decode)

    def stream(self, gfjs: GFJS, chunk_rows: int = 1 << 20, *,
               decode: bool = True):
        """The result in host row chunks (numpy)."""
        return stream_desummarize(gfjs, chunk_rows, decode=decode)

    # -- summary algebra and storage ---------------------------------------
    def aggregate(self, op: str, var: Optional[str] = None, *,
                  by: Optional[Sequence[str]] = None,
                  where: Optional[Dict] = None,
                  gfjs: Optional[GFJS] = None):
        """Answer an aggregate from the summary — O(runs), never O(|Q|).

            gj.aggregate("count")
            gj.aggregate("sum", "D", by=["A"], where={"B": "b1"})

        ``op``: count / sum / mean / min / max / distinct / count_distinct.
        Pass a previously computed ``gfjs`` to reuse it (the compute-and-
        reuse path); otherwise the pipeline runs (or re-runs) first.  The
        reductions run on ``self.device``; the summary-side time lands in
        ``timings["aggregate"]``.
        """
        from repro_torch.summary.algebra import SummaryFrame
        if gfjs is None:
            gfjs = self.run()
        t0 = time.perf_counter()
        frame = SummaryFrame.of(gfjs, self.device)
        if where:
            frame = frame.filter(where)
        if by:
            if op == "count":
                out = frame.group_by(list(by), count="count")
            else:
                if var is None:
                    raise ValueError(f"aggregate {op!r} needs a variable")
                out = frame.group_by(list(by), **{op: (op, var)})
        elif op == "count":
            out = frame.count()
        elif op in ("sum", "mean", "min", "max", "distinct", "count_distinct"):
            if var is None:
                raise ValueError(f"aggregate {op!r} needs a variable")
            out = getattr(frame, op)(var)
        else:
            raise ValueError(f"unknown aggregate op {op!r}")
        self.timings["aggregate"] = time.perf_counter() - t0
        return out

    def store(self, gfjs: GFJS, path: str) -> int:
        """Write the summary (the reference's file format); bytes on disk."""
        t0 = time.perf_counter()
        n = save_gfjs(gfjs, path)
        self.timings["store"] = time.perf_counter() - t0
        return n

    @staticmethod
    def load(path: str) -> GFJS:
        """A summary written by ``store`` (by either package)."""
        return load_gfjs(path)
