"""JoinServer — the thread-safe serving front-end over :class:`JoinService`.

The paper's headline wins come from computing a GFJS summary **once** and
answering everything else in O(num_runs).  The raw service honors that for
sequential traffic, but a serving tier sees *stampedes*: N threads racing
the same cold query used to run N full Graphical-Join builds (documented in
``summary/service.py`` as "duplicate work, never a wrong answer"), and the
per-key feature path re-derived its group-by table once per racer after
every append.  At 10k+ requests/s that duplicate work IS the latency.

:class:`JoinServer` closes the gap with three mechanisms (DESIGN.md §18):

* **Request collapsing** (single-flight).  Concurrent requests for the
  same (query fingerprint × table versions × plan signature) cache key
  share one in-flight build through a per-key latch: the first arrival
  becomes the *leader* and runs ``JoinService.frame``; everyone else
  waits on the latch and receives the leader's reply re-labeled
  ``source="collapsed"``.  N racers cost 1 build + N−1 waits, never N
  builds.
* **Batched probes**.  ``lookup`` answers per-key group-by probes (the
  serve-path feature pull) against one *resident* per-key table: the
  first prober leads, optionally lingers ``batch_window`` seconds to
  collect concurrent requests, pulls the frame once (single-flighted),
  derives the group-by table once (LRU-memoized per cache key), then
  answers every collected request with ONE vectorized ``searchsorted``
  over the concatenated keys and scatters the rows back.
Beneath collapsing sits the service's elimination-*message* reuse
(DESIGN.md §20): collapsing de-duplicates builds of the SAME cache key,
while the shared :class:`~repro_torch.summary.msgcache.MessageCache` lets the
one leader build that does run inject messages computed by *different*
queries with matching elimination subtrees — the two mechanisms compose,
and ``stats()`` on the underlying service exposes the ``msgcache_*``
counters alongside the server's own.

* **Admission control**.  A cold build (cache miss with no refreshable
  retained state) is priced by the plan layer's CostModel step estimates
  (``PhysicalPlan.admission_cost``).  Above ``cost_ceiling`` the request
  is rejected (:class:`AdmissionRejected`) or, with ``admission="queue"``,
  queued for one of ``max_expensive_builds`` build slots under the
  request's deadline.  Deadlines also bound waiters on a collapsed build
  and batched-probe followers: expiry raises :class:`DeadlineExceeded` —
  a clean timeout, never a partial frame.

Observability rides :mod:`repro_torch.obs`: every request opens a
``server:request`` span (the leader nests a ``server:build`` child whose
id collapsed waiters carry as ``build_span_id`` — the span-level record of
the latch handoff), and the server mirrors its counters (``requests`` /
``collapsed`` / ``rejected`` / ``deadline_expired`` / ``batched``), gauges
(``inflight`` / ``queue_depth``), and per-source latency histograms into
the process registry under ``server.*``.

Port of ``src/repro/serve/server.py``: only the imports differ.  It
sits in front of the port's service, whose frames answer on the service's
device; the LM engine lives in ``serve/engine.py``.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import span as _ambient_span
from repro_torch.summary.cache import cache_key_for_versions
from repro_torch.summary.service import ServiceReply


def _table_nbytes(table: Dict[str, np.ndarray]) -> int:
    """Resident footprint of one group-by table (column array bytes)."""
    return int(sum(np.asarray(v).nbytes for v in table.values()))


class AdmissionRejected(RuntimeError):
    """Cold build priced above the server's cost ceiling (reject mode)."""


class DeadlineExceeded(TimeoutError):
    """A request's deadline expired while waiting (collapse latch, probe
    batch, or admission queue) — the caller got nothing, never a partial
    frame."""


class _Flight:
    """One in-flight build: the latch waiters park on, plus its result."""

    __slots__ = ("event", "value", "error", "waiters", "meta")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.value: Any = None
        self.error: Optional[BaseException] = None
        self.waiters = 0
        self.meta: Dict[str, Any] = {}      # leader-stashed (build span id)


class SingleFlight:
    """Collapse concurrent identical-key calls into one execution.

    ``do(key, fn)`` elects the first caller per live key as the leader:
    it runs ``fn(flight)`` and publishes the result (or the exception)
    through the flight latch; concurrent callers with the same key wait
    on the latch — bounded by ``timeout`` — and share the outcome.  The
    flight is removed before the latch fires, so a *later* call starts a
    fresh flight (by then the result is typically cached downstream).

    Returns ``(value, leader, flight)``; re-raises the leader's exception
    in every waiter.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._flights: Dict[Any, _Flight] = {}

    def inflight(self) -> int:
        with self._lock:
            return len(self._flights)

    def do(self, key: Any, fn: Callable[[_Flight], Any], *,
           timeout: Optional[float] = None) -> Tuple[Any, bool, _Flight]:
        with self._lock:
            fl = self._flights.get(key)
            leader = fl is None
            if leader:
                fl = _Flight()
                self._flights[key] = fl
            else:
                fl.waiters += 1
        if leader:
            try:
                fl.value = fn(fl)
            except BaseException as e:
                fl.error = e
                raise
            finally:
                with self._lock:
                    self._flights.pop(key, None)
                fl.event.set()
            return fl.value, True, fl
        if not fl.event.wait(timeout):
            raise DeadlineExceeded(
                f"deadline expired after {timeout:.3f}s waiting on a "
                "collapsed build")
        if fl.error is not None:
            raise fl.error
        return fl.value, False, fl


def lookup_rows(table: Dict[str, np.ndarray], key_var: str,
                agg_names: List[str], keys: np.ndarray) -> np.ndarray:
    """``[len(keys), len(agg_names)]`` float32 rows of a group-by table.

    ``table`` is ``SummaryFrame.group_by`` output (rows sorted by key), so
    one ``searchsorted`` resolves every requested key; keys missing from
    the join result get zero rows.  Shared by :meth:`JoinServer.lookup`
    and ``serve/engine.py::RelationalFeatureProvider``.
    """
    uniq = np.asarray(table[key_var])
    keys = np.asarray(keys)
    pos = np.searchsorted(uniq, keys)
    pos_c = np.clip(pos, 0, max(len(uniq) - 1, 0))
    ok = (uniq[pos_c] == keys) if len(uniq) else np.zeros(len(keys), bool)
    out = np.zeros((len(keys), len(agg_names)), np.float32)
    for j, name in enumerate(agg_names):
        col = np.asarray(table[name], np.float32)
        if len(col):
            out[:, j] = np.where(ok, col[pos_c], 0.0)
    return out


class _Slot:
    """One probe request parked in a batch."""

    __slots__ = ("keys", "event", "out", "error")

    def __init__(self, keys: np.ndarray) -> None:
        self.keys = keys
        self.event = threading.Event()
        self.out: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None


class _Batcher:
    """Per-(cache key × key_var × aggs) probe rendezvous."""

    __slots__ = ("lock", "leader", "pending")

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.leader: Optional[_Slot] = None
        self.pending: List[_Slot] = []


def _aggs_signature(aggs: Dict[str, Any]) -> Tuple:
    return tuple(sorted(
        (name, spec if isinstance(spec, str) else tuple(spec))
        for name, spec in aggs.items()))


class JoinServer:
    """Thread-safe serving front-end: collapse, batch, admit.

        svc = JoinService(catalog)
        server = JoinServer(svc, cost_ceiling=1e9, default_deadline=2.0)
        reply = server.frame(query)                 # collapsed under races
        rows = server.lookup(query, "U1", user_ids,
                             {"n": "count", "s": ("sum", "A2")})

    Wraps — never replaces — the service: ``server.frame`` returns the
    same :class:`ServiceReply` the service would (waiters' replies carry
    ``source="collapsed"`` and the leader's frame/key/plan), and every
    aggregate stays bit-identical to a direct ``JoinService`` call
    (``benchmarks/serve_bench.py --smoke`` gates exactly that).

    ``deadline`` (per request, or ``default_deadline``) bounds the time a
    request may spend *waiting* — on a collapse latch, a probe batch, or
    the admission queue.  It does not abort a build the request itself
    leads: the leader chose to build, and aborting mid-elimination would
    strand every waiter behind it.
    """

    def __init__(self, service, *,
                 cost_ceiling: Optional[float] = None,
                 admission: str = "reject",
                 max_expensive_builds: int = 1,
                 default_deadline: Optional[float] = None,
                 batch_window: float = 0.0,
                 max_tables: int = 64,
                 table_byte_budget: Optional[int] = None,
                 tracer=None) -> None:
        if admission not in ("reject", "queue"):
            raise ValueError(f"admission must be 'reject' or 'queue', "
                             f"got {admission!r}")
        if max_expensive_builds < 1:
            raise ValueError("max_expensive_builds must be >= 1")
        if batch_window < 0.0:
            raise ValueError("batch_window must be >= 0")
        self.service = service
        self.cost_ceiling = cost_ceiling
        self.admission = admission
        self.default_deadline = default_deadline
        self.batch_window = float(batch_window)
        self.max_tables = int(max_tables)
        # resident group-by tables are bounded by BYTES as well as entry
        # count: a handful of wide tables can dwarf the summary cache the
        # service itself budgets, so the default ties the resident set to
        # the same ceiling (the service's SummaryCache byte budget)
        if table_byte_budget is None:
            table_byte_budget = getattr(
                getattr(service, "cache", None), "byte_budget", None)
        if table_byte_budget is not None and table_byte_budget <= 0:
            raise ValueError("table_byte_budget must be positive")
        self.table_byte_budget = (int(table_byte_budget)
                                  if table_byte_budget is not None else None)
        # explicit tracer for request spans opened on serving threads
        # (ambient context does not cross thread boundaries); None falls
        # back to the ambient tracer of the calling thread, if any
        self._tracer = tracer
        self._lock = threading.Lock()
        # the counters the serving tier is judged on, as plain
        # ints (race-free under _lock) AND mirrored into REGISTRY
        self.requests = 0
        self.collapsed = 0
        self.rejected = 0
        self.deadline_expired = 0
        self.batched = 0               # probe requests served from a batch
        self.probes = 0                # probe batches executed
        self.table_recomputes = 0      # resident per-key table rebuilds
        self.inflight = 0              # builds running right now
        self.queue_depth = 0           # requests parked in the admission queue
        self._flights = SingleFlight()
        self._table_flight = SingleFlight()
        self._build_slots = threading.Semaphore(max_expensive_builds)
        self._tables: "OrderedDict[Tuple, Dict[str, np.ndarray]]" = \
            OrderedDict()
        self._table_bytes: Dict[Tuple, int] = {}
        self.resident_table_bytes = 0
        self._tables_lock = threading.Lock()
        self._batchers: Dict[Tuple, _Batcher] = {}

    # -- bookkeeping --------------------------------------------------------
    def _count(self, name: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + n)
        REGISTRY.counter(f"server.{name}").inc(n)

    def _gauge(self, name: str, delta: int) -> None:
        with self._lock:
            v = getattr(self, name) + delta
            setattr(self, name, v)
        REGISTRY.gauge(f"server.{name}").set(v)

    def _span(self, name: str, **args: Any):
        if self._tracer is not None:
            return self._tracer.span(name, cat="server", **args)
        return _ambient_span(name, cat="server", **args)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "requests": self.requests,
                "collapsed": self.collapsed,
                "rejected": self.rejected,
                "deadline_expired": self.deadline_expired,
                "batched": self.batched,
                "probes": self.probes,
                "table_recomputes": self.table_recomputes,
                "inflight": self.inflight,
                "queue_depth": self.queue_depth,
                "resident_tables": len(self._tables),
                "resident_table_bytes": self.resident_table_bytes,
            }

    # -- keys ---------------------------------------------------------------
    def _key(self, query, plan) -> str:
        versions = {qt.table: self.service.catalog[qt.table].version()
                    for qt in query.tables}
        return cache_key_for_versions(query, versions, plan=plan)

    # -- request collapsing -------------------------------------------------
    def frame(self, query, *, plan=None,
              deadline: Optional[float] = None) -> ServiceReply:
        """The summary for ``query`` — one build per key, however many ask.

        Fast path (cache hit) is a straight ``service.frame``-equivalent;
        on a miss, concurrent callers collapse onto one in-flight build.
        """
        deadline = self.default_deadline if deadline is None else deadline
        t0 = time.perf_counter()
        with self._span("server:request", kind="frame",
                        query=query.name) as sp:
            if plan is None:
                plan = self.service.compile(query)
            key = self._key(query, plan)

            def build(fl: _Flight) -> ServiceReply:
                return self._build(query, plan, key, deadline, t0, fl)

            try:
                reply, leader, fl = self._flights.do(
                    key, build, timeout=self._remaining(deadline, t0))
            except DeadlineExceeded as e:
                # count once per *expiry*: a latch-wait timeout is fresh
                # here, but a leader's queue timeout was already counted in
                # _admit (and is shared — re-raised — by every waiter)
                if not getattr(e, "_counted", False):
                    e._counted = True
                    self._count("deadline_expired")
                sp.set(source="deadline_expired")
                raise
            if not leader:
                wait = time.perf_counter() - t0
                self._count("collapsed")
                reply = ServiceReply(reply.frame, "collapsed", reply.key,
                                     {"collapse_wait": wait}, reply.plan)
                sp.set(collapsed=True,
                       build_span_id=fl.meta.get("build_span_id"))
            dt = time.perf_counter() - t0
            reply.timings["server"] = dt
            sp.set(source=reply.source)
            self._count("requests")
            REGISTRY.histogram(
                f"server.latency_seconds.{reply.source}",
                unit="s").observe(dt)
            return reply

    @staticmethod
    def _remaining(deadline: Optional[float], t0: float) -> Optional[float]:
        if deadline is None:
            return None
        return max(deadline - (time.perf_counter() - t0), 0.001)

    def _build(self, query, plan, key: str, deadline: Optional[float],
               t0: float, fl: _Flight) -> ServiceReply:
        """Leader path: admit (cold only), run the service, publish."""
        cold = (self.service.cache.probe(key) == "miss"
                and not self.service.can_refresh(query, plan))
        slot = self._admit(plan, deadline, t0) if cold else False
        self._gauge("inflight", +1)
        try:
            with self._span("server:build", key=key[:16], cold=cold) as bsp:
                reply = self.service.frame(query, plan=plan)
                bsp.set(source=reply.source)
                fl.meta["build_span_id"] = bsp.span_id
            return reply
        finally:
            self._gauge("inflight", -1)
            if slot:
                self._build_slots.release()

    # -- admission control --------------------------------------------------
    def _admit(self, plan, deadline: Optional[float], t0: float) -> bool:
        """Gate a cold build on the plan's cost estimate.

        Returns True iff a build slot was taken (caller must release).
        Sub-ceiling builds — and everything when no ceiling is set — pass
        for free: refreshes, disk promotions, and cheap builds never queue
        behind an expensive one.
        """
        if self.cost_ceiling is None:
            return False
        est = plan.admission_cost()
        if est <= self.cost_ceiling:
            return False
        if self.admission == "reject":
            self._count("rejected")
            raise AdmissionRejected(
                f"estimated build cost {est:.3g} exceeds the admission "
                f"ceiling {self.cost_ceiling:.3g} "
                f"(plan {plan.query_name!r}, {plan.partitions} partition(s))")
        self._gauge("queue_depth", +1)
        try:
            ok = self._build_slots.acquire(
                timeout=self._remaining(deadline, t0))
        finally:
            self._gauge("queue_depth", -1)
        if not ok:
            self._count("deadline_expired")
            e = DeadlineExceeded(
                f"deadline expired queued for a build slot "
                f"(est cost {est:.3g} > ceiling {self.cost_ceiling:.3g})")
            e._counted = True       # don't re-count in frame()'s handler
            raise e
        return True

    # -- batched per-key probes ---------------------------------------------
    def lookup(self, query, key_var: str, keys, aggs: Dict[str, Any], *,
               plan=None, deadline: Optional[float] = None) -> np.ndarray:
        """``[len(keys), len(aggs)]`` float32 feature rows for ``keys``.

        The serve-path probe: group ``query``'s summary by ``key_var``
        under ``aggs`` (memoized per cache key — versions fold in, so an
        append mints a new table) and gather the requested keys' rows.
        Concurrent probes against the same resident table batch into one
        frame pull + one vectorized lookup; keys absent from the join get
        zeros, matching ``RelationalFeatureProvider`` semantics.
        """
        deadline = self.default_deadline if deadline is None else deadline
        t0 = time.perf_counter()
        keys = np.asarray(keys)
        agg_names = list(aggs)
        with self._span("server:request", kind="lookup",
                        query=query.name, keys=len(keys)) as sp:
            if len(keys) == 0:
                sp.set(source="empty")
                self._count("requests")
                return np.zeros((0, len(agg_names)), np.float32)
            if plan is None:
                plan = self.service.compile(query)
            bkey = (self._key(query, plan), key_var, _aggs_signature(aggs))
            b = self._batcher(bkey)
            slot = _Slot(keys)
            with b.lock:
                lead = b.leader is None
                if lead:
                    b.leader = slot
                else:
                    b.pending.append(slot)
            if lead:
                out = self._lead_probe(b, bkey, slot, query, key_var, aggs,
                                       agg_names, plan, deadline, t0)
                sp.set(source="probe")
            else:
                if not slot.event.wait(self._remaining(deadline, t0)):
                    self._count("deadline_expired")
                    sp.set(source="deadline_expired")
                    raise DeadlineExceeded(
                        f"deadline expired after {deadline:.3f}s waiting "
                        "on a probe batch")
                if slot.error is not None:
                    raise slot.error
                out = slot.out
                self._count("batched")
                sp.set(source="batched")
            self._count("requests")
            REGISTRY.histogram(
                "server.latency_seconds.probe", unit="s").observe(
                    time.perf_counter() - t0)
            return out

    def _batcher(self, bkey: Tuple) -> _Batcher:
        with self._tables_lock:
            b = self._batchers.get(bkey)
            if b is None:
                # batchers for dead keys (version churn) are tiny; prune
                # opportunistically alongside the table LRU bound
                if len(self._batchers) > 4 * self.max_tables:
                    self._batchers = {k: v for k, v in self._batchers.items()
                                      if v.leader is not None or v.pending}
                b = self._batchers.setdefault(bkey, _Batcher())
            return b

    def _lead_probe(self, b: _Batcher, bkey: Tuple, slot: _Slot, query,
                    key_var: str, aggs: Dict[str, Any],
                    agg_names: List[str], plan, deadline: Optional[float],
                    t0: float) -> np.ndarray:
        """Leader: linger, resolve the table once, answer the whole batch."""
        batch: Optional[List[_Slot]] = None
        try:
            if self.batch_window > 0.0:
                time.sleep(self.batch_window)      # collect followers
            table = self._resident_table(bkey, query, key_var, aggs, plan,
                                         deadline, t0)
            with b.lock:
                batch = [slot] + b.pending
                b.pending = []
                b.leader = None
            allk = np.concatenate([s.keys for s in batch])
            rows = lookup_rows(table, key_var, agg_names, allk)
            self._count("probes")
            REGISTRY.histogram("server.batch_size").observe(len(batch))
            REGISTRY.counter("server.probe_keys").inc(len(allk))
            off = 0
            for s in batch:
                s.out = rows[off:off + len(s.keys)]
                off += len(s.keys)
                if s is not slot:
                    s.event.set()
            return slot.out
        except BaseException as e:
            if batch is None:          # failed before the drain
                with b.lock:
                    batch = list(b.pending)
                    b.pending = []
                    b.leader = None
            for s in batch:
                if s is not slot:
                    s.error = e
                    s.event.set()
            raise

    def _resident_table(self, bkey: Tuple, query, key_var: str,
                        aggs: Dict[str, Any], plan,
                        deadline: Optional[float],
                        t0: float) -> Dict[str, np.ndarray]:
        """The memoized group-by table for ``bkey`` (single-flighted)."""
        with self._tables_lock:
            hit = self._tables.get(bkey)
            if hit is not None:
                self._tables.move_to_end(bkey)
                return hit

        def build(_fl: _Flight) -> Dict[str, np.ndarray]:
            reply = self.frame(query, plan=plan,
                               deadline=self._remaining(deadline, t0))
            table = reply.frame.group_by([key_var], **aggs)
            nbytes = _table_nbytes(table)
            with self._tables_lock:
                old = self._table_bytes.pop(bkey, 0)
                self._tables[bkey] = table
                self._table_bytes[bkey] = nbytes
                self.resident_table_bytes += nbytes - old
                self._tables.move_to_end(bkey)
                # evict LRU-first while over EITHER bound — entry count or
                # resident bytes (never past the just-inserted entry: a
                # single over-budget table still serves its own request)
                while len(self._tables) > 1 and (
                        len(self._tables) > self.max_tables
                        or (self.table_byte_budget is not None
                            and self.resident_table_bytes
                            > self.table_byte_budget)):
                    ekey, _ = self._tables.popitem(last=False)
                    self.resident_table_bytes -= \
                        self._table_bytes.pop(ekey, 0)
                resident = self.resident_table_bytes
            REGISTRY.gauge("server.resident_table_bytes",
                           unit="B").set(resident)
            self._count("table_recomputes")
            return table

        table, _, _ = self._table_flight.do(
            bkey, build, timeout=self._remaining(deadline, t0))
        return table
