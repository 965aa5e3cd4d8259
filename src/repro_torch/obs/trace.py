"""Process-wide span tracing for the GJ pipeline (DESIGN.md §16).

One :class:`Tracer` collects nested, thread-safe spans across every
pipeline stage — plan search, model build, per-step elimination, GFJS
generation levels, kernel launches, cache traffic, shard pipelines — and
exports them as Chrome trace-event JSON (load the file at
https://ui.perfetto.dev or chrome://tracing).

Two ways into a span:

* **Handle** — a component holding a tracer calls ``tracer.span(name)``.
  Entering the span installs it as the *ambient* span for the dynamic
  extent, so nested code needs no plumbing.
* **Ambient** — library code (core elimination, kernels, cache) calls the
  module-level :func:`span`.  When no tracer is active this returns a
  shared no-op context whose entire cost is one ``ContextVar.get`` — the
  near-zero-overhead short-circuit that keeps untraced runs at untraced
  speed.

Ambient context does NOT cross thread boundaries (each worker thread of a
pool starts with no active span): cross-thread nesting is an **explicit
parent handoff** — the coordinator captures its span object and workers
open their spans with ``tracer.span(name, parent=that_span)``.  The
sharded-build pool in ``plan/executor.py`` is the canonical example.

Every span carries a ``trace_id``: a root span's own ``span_id``,
inherited by each of its descendants however their parent was found
(ambient, handed across a thread, or grafted from another process), so
the spans of one request or query share one id.

Spans opened with ``device=True`` additionally enter a
``torch.profiler.record_function`` of the same name *if torch is already
imported* (never importing it — this module stays stdlib-only), so host
spans line up with device traces captured by ``torch.profiler``.
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

# (tracer, span) of the innermost active span in this context; None when
# tracing is off — the single check every no-op span call pays
_STATE: "contextvars.ContextVar[Optional[Tuple[Tracer, Span]]]" = \
    contextvars.ContextVar("repro_obs_state", default=None)

_IDS = itertools.count(1)          # CPython-atomic span id source


@dataclass
class Span:
    """One timed region.  ``args`` may be annotated until export."""

    name: str
    cat: str
    span_id: int
    parent_id: Optional[int]
    tid: int
    t0: float = 0.0                # perf_counter seconds
    t1: float = 0.0
    args: Dict[str, Any] = field(default_factory=dict)
    trace_id: Optional[int] = None  # the root's span_id

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def set(self, **kw: Any) -> "Span":
        """Attach attributes (drift, product sizes, shard ids, ...)."""
        self.args.update(kw)
        return self


class _NullSpan:
    """Shared do-nothing span + context manager (tracing disabled)."""

    __slots__ = ()
    name = cat = ""
    span_id = None
    parent_id = None
    trace_id = None
    seconds = 0.0

    def set(self, **kw: Any) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None


NULL_SPAN = _NullSpan()

_AMBIENT = object()                # sentinel: resolve parent from context


class _SpanCtx:
    """Context manager that opens/closes one span on a tracer."""

    __slots__ = ("_tracer", "_span", "_token", "_device", "_annot")

    def __init__(self, tracer: "Tracer", span: Span, device: bool) -> None:
        self._tracer = tracer
        self._span = span
        self._token = None
        self._device = device
        self._annot = None

    def __enter__(self) -> Span:
        sp = self._span
        sp.tid = threading.get_ident()
        self._token = _STATE.set((self._tracer, sp))
        if self._device:
            annot = _device_annotation(sp.name)
            if annot is not None:
                annot.__enter__()
                self._annot = annot
        sp.t0 = self._tracer.clock()
        return sp

    def __exit__(self, *exc) -> None:
        sp = self._span
        sp.t1 = self._tracer.clock()
        if self._annot is not None:
            self._annot.__exit__(*exc)
            self._annot = None
        _STATE.reset(self._token)
        self._tracer._record(sp)


def _device_annotation(name: str):
    """A ``torch.profiler.record_function`` if torch is already loaded.

    Deliberately ``sys.modules``-gated, as in the reference: tracing must
    not drag the framework import in on its own.
    """
    th = sys.modules.get("torch")
    if th is None:
        return None
    return th.profiler.record_function(name)


class Tracer:
    """Collects finished spans; thread-safe; exports Chrome trace JSON."""

    def __init__(self, clock=time.perf_counter) -> None:
        self.clock = clock
        self.epoch = clock()
        self._lock = threading.Lock()
        self._spans: List[Span] = []

    # -- span lifecycle ----------------------------------------------------
    def span(self, name: str, *, cat: str = "op", parent: Any = _AMBIENT,
             device: bool = False, **args: Any) -> _SpanCtx:
        """Open a span (use as a context manager).

        ``parent`` defaults to the ambient span of *this* tracer in the
        current context; pass a :class:`Span` explicitly to hand a parent
        across a thread boundary (shard pools), or ``None`` to force a
        root span.
        """
        if parent is _AMBIENT:
            state = _STATE.get()
            parent = state[1] if state is not None and state[0] is self \
                else None
        sid = next(_IDS)
        if isinstance(parent, Span):
            pid, trace = parent.span_id, parent.trace_id or parent.span_id
        else:
            pid, trace = None, sid
        sp = Span(name=name, cat=cat, span_id=sid, parent_id=pid,
                  tid=0, args=dict(args), trace_id=trace)
        return _SpanCtx(self, sp, device)

    def _record(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    # -- introspection -----------------------------------------------------
    @property
    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._spans)

    def find(self, name: str) -> List[Span]:
        """Finished spans whose name equals ``name`` or starts with
        ``name`` up to a ``:`` separator (``find("shard")`` -> shard:0...)."""
        return [s for s in self.spans
                if s.name == name or s.name.startswith(name + ":")]

    # -- export ------------------------------------------------------------
    def to_chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON (complete "X" events, us timestamps).

        Spans nest visually in Perfetto by time containment per (pid,
        tid) track; parent/child identity additionally rides in ``args``
        (``span_id`` / ``parent_id`` / ``trace_id``) for programmatic
        consumers.
        """
        pid = os.getpid()
        spans = self.spans
        events: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "graphical-join"},
        }]
        for tid in sorted({s.tid for s in spans}):
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": f"thread-{tid}"},
            })
        for s in sorted(spans, key=lambda s: s.t0):
            args = {k: _jsonable(v) for k, v in s.args.items()}
            args["span_id"] = s.span_id
            args["trace_id"] = s.trace_id
            if s.parent_id is not None:
                args["parent_id"] = s.parent_id
            events.append({
                "name": s.name, "cat": s.cat, "ph": "X",
                "ts": (s.t0 - self.epoch) * 1e6,
                "dur": max((s.t1 - s.t0) * 1e6, 0.0),
                "pid": pid, "tid": s.tid, "args": args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path

    # -- cross-process stitching -------------------------------------------
    def records(self) -> List[Dict[str, Any]]:
        """Finished spans as plain JSON-able dicts (the shard-action wire
        format's span payload).  Times are this tracer's ``perf_counter``
        values — meaningless in another process until :meth:`graft`
        rebases them."""
        return [{"name": s.name, "cat": s.cat, "span_id": s.span_id,
                 "parent_id": s.parent_id, "trace_id": s.trace_id,
                 "tid": s.tid,
                 "t0": s.t0, "t1": s.t1,
                 "args": {k: _jsonable(v) for k, v in s.args.items()}}
                for s in self.spans]

    def graft(self, records: List[Dict[str, Any]], *, parent: Any = None,
              offset: float = 0.0) -> List[Span]:
        """Re-home span records from another process under ``parent``.

        Every record gets a fresh span id from this process's counter;
        parent links *within* the record set are remapped, records whose
        parent is unknown (the worker's root) attach to ``parent``
        (a :class:`Span`, or None for top-level).  Every grafted span
        takes ``parent``'s ``trace_id``; without a parent, its own
        grafted root's.  ``offset`` is added to
        every timestamp — the coordinator computes it so the worker's
        clock lands inside the observed dispatch window (the two
        ``perf_counter`` epochs are otherwise incomparable).

        Returns the grafted spans in record order (callers typically keep
        the worker's root to annotate wall/straggler facts onto).
        """
        base = parent.span_id if isinstance(parent, Span) else None
        idmap: Dict[int, int] = {}
        out: List[Span] = []
        for r in records:
            sp = Span(name=r["name"], cat=r.get("cat", "op"),
                      span_id=next(_IDS), parent_id=None,
                      tid=int(r.get("tid", 0)),
                      t0=float(r["t0"]) + offset, t1=float(r["t1"]) + offset,
                      args=dict(r.get("args", {})))
            if r.get("span_id") is not None:
                idmap[r["span_id"]] = sp.span_id
            out.append(sp)
        for r, sp in zip(records, out):
            pid = r.get("parent_id")
            sp.parent_id = idmap.get(pid, base) if pid is not None else base
        if isinstance(parent, Span):
            for sp in out:
                sp.trace_id = parent.trace_id or parent.span_id
        else:
            by_id = {sp.span_id: sp for sp in out}
            for sp in out:
                root = sp
                while root.parent_id in by_id:
                    root = by_id[root.parent_id]
                sp.trace_id = root.span_id
        for sp in out:
            self._record(sp)
        return out


def _jsonable(v: Any) -> Any:
    """Coerce numpy scalars etc. so ``json.dump`` never chokes on args."""
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    item = getattr(v, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:  # pragma: no cover - non-scalar .item()
            pass
    return str(v)


# ---------------------------------------------------------------------------
# Ambient API — what library code calls.
# ---------------------------------------------------------------------------

def span(name: str, *, cat: str = "op", device: bool = False, **args: Any):
    """A span on the ambient tracer; the shared no-op when tracing is off."""
    state = _STATE.get()
    if state is None:
        return NULL_SPAN
    return state[0].span(name, cat=cat, device=device, **args)


def current_span() -> Optional[Span]:
    """The innermost active span (for explicit cross-thread handoff)."""
    state = _STATE.get()
    return state[1] if state is not None else None


def ambient_tracer() -> Optional["Tracer"]:
    """The active tracer, if any (components capture it at entry so
    worker threads — which see no ambient context — can still open
    spans with an explicit parent)."""
    state = _STATE.get()
    return state[0] if state is not None else None


def span_in(tracer: Optional["Tracer"], parent: Any, name: str, *,
            cat: str = "op", device: bool = False, **args: Any):
    """``tracer.span`` with an explicit parent, or the no-op when
    ``tracer`` is None — the one-liner worker threads use."""
    if tracer is None:
        return NULL_SPAN
    if isinstance(parent, _NullSpan):
        parent = None
    return tracer.span(name, cat=cat, parent=parent, device=device, **args)
