"""Counters, gauges, histograms — the metrics half of `repro.obs`.

A :class:`MetricsRegistry` replaces the scattered stat dicts
(``Executor.timings``, ``CacheStats`` increments, per-bench derived
numbers) as the substrate: components bump named instruments, and
``snapshot()`` returns one JSON-able dict for benchmarks, the service
``stats()`` endpoint, and ``explain(analyze=True)``.

Legacy surfaces stay intact: :class:`TimingsView` is a real ``dict``
subclass that mirrors phase timings into the registry's histograms, so
``Executor.timings["summarize"]`` keeps working unchanged while the same
number lands in ``executor.phase_seconds.summarize``.

Everything here is stdlib-only (the planning path must stay jax-free)
and thread-safe (the sharded build pool bumps counters concurrently).
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, Optional


class Counter:
    """Monotonic count (events, bytes)."""

    __slots__ = ("name", "unit", "_value", "_lock")

    def __init__(self, name: str, unit: str = "") -> None:
        self.name = name
        self.unit = unit
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "counter", "unit": self.unit, "value": self._value}


class Gauge:
    """Last-written value (skew ratio, resident bytes)."""

    __slots__ = ("name", "unit", "_value", "_lock")

    def __init__(self, name: str, unit: str = "") -> None:
        self.name = name
        self.unit = unit
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> Dict[str, Any]:
        return {"type": "gauge", "unit": self.unit, "value": self._value}


class Histogram:
    """Power-of-two exponential buckets, stored sparsely.

    Bucket ``i`` counts observations in ``(2^(i-1), 2^i]`` (bucket 0
    holds everything ``<= 1`` ulp above zero's bucket floor); fine
    enough to separate a 2ms kernel from a 200ms shard wall without
    preconfiguring bounds per metric.
    """

    __slots__ = ("name", "unit", "count", "sum", "min", "max",
                 "_buckets", "_lock")

    def __init__(self, name: str, unit: str = "") -> None:
        self.name = name
        self.unit = unit
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._buckets: Dict[int, int] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _bucket(v: float) -> int:
        if v <= 0.0:
            return -1075          # below the smallest positive double
        return math.frexp(v)[1]   # exponent e with v in (2^(e-1), 2^e]

    def observe(self, v: float) -> None:
        v = float(v)
        b = self._bucket(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            self._buckets[b] = self._buckets.get(b, 0) + 1

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "type": "histogram", "unit": self.unit,
                "count": self.count, "sum": self.sum,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "buckets": {str(k): v for k, v in sorted(self._buckets.items())},
            }


class MetricsRegistry:
    """Named get-or-create home for instruments + JSON snapshot API."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[str, Any] = {}

    def _get(self, cls, name: str, unit: str):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, unit)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}")
            return inst

    def counter(self, name: str, unit: str = "") -> Counter:
        return self._get(Counter, name, unit)

    def gauge(self, name: str, unit: str = "") -> Gauge:
        return self._get(Gauge, name, unit)

    def histogram(self, name: str, unit: str = "") -> Histogram:
        return self._get(Histogram, name, unit)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            instruments = dict(self._instruments)
        return {name: inst.snapshot() for name, inst in sorted(instruments.items())}

    @staticmethod
    def from_snapshot(snap: Dict[str, Dict[str, Any]]) -> "MetricsRegistry":
        """Rebuild a registry from ``snapshot()`` output (round-trip for
        persistence / cross-process aggregation of bench runs)."""
        reg = MetricsRegistry()
        for name, s in snap.items():
            kind = s.get("type")
            if kind == "counter":
                reg.counter(name, s.get("unit", "")).inc(s["value"])
            elif kind == "gauge":
                reg.gauge(name, s.get("unit", "")).set(s["value"])
            elif kind == "histogram":
                h = reg.histogram(name, s.get("unit", ""))
                h.count = s["count"]
                h.sum = s["sum"]
                h.min = s["min"] if s["min"] is not None else math.inf
                h.max = s["max"] if s["max"] is not None else -math.inf
                h._buckets = {int(k): v for k, v in s["buckets"].items()}
            else:
                raise ValueError(f"unknown instrument type {kind!r} for {name!r}")
        return reg

    def merge(self, snap: Dict[str, Dict[str, Any]]) -> None:
        """Fold another registry's ``snapshot()`` into this one.

        The cross-process half of observability: shard workers snapshot
        their (freshly reset) registry and the coordinator merges every
        reply, so ``kernels.*`` / ``gfjs.*`` numbers look the same whether
        shards ran on threads or processes.  Counters add, gauges take the
        incoming value (last writer wins, same as ``set``), histograms
        merge bucket-wise.
        """
        for name, s in snap.items():
            kind = s.get("type")
            if kind == "counter":
                self.counter(name, s.get("unit", "")).inc(s["value"])
            elif kind == "gauge":
                self.gauge(name, s.get("unit", "")).set(s["value"])
            elif kind == "histogram":
                h = self.histogram(name, s.get("unit", ""))
                with h._lock:
                    h.count += s["count"]
                    h.sum += s["sum"]
                    if s["min"] is not None and s["min"] < h.min:
                        h.min = s["min"]
                    if s["max"] is not None and s["max"] > h.max:
                        h.max = s["max"]
                    for b, n in s["buckets"].items():
                        b = int(b)
                        h._buckets[b] = h._buckets.get(b, 0) + n
            else:
                raise ValueError(
                    f"unknown instrument type {kind!r} for {name!r}")

    def reset(self) -> None:
        with self._lock:
            self._instruments.clear()


#: Process-wide default registry.  Components take an optional
#: ``metrics=`` override but fall back here, so a bare
#: ``GraphicalJoin(...).run()`` is still observable after the fact.
REGISTRY = MetricsRegistry()


class TimingsView(dict):
    """``Executor.timings`` compatible dict that mirrors writes into
    per-phase latency histograms (``executor.phase_seconds.<phase>``).

    Subclassing ``dict`` keeps every legacy access pattern — key tests,
    ``.get``, external mutation like ``gj.timings["aggregate"] = dt`` —
    byte-for-byte identical while the measurement substrate moves to the
    registry.  A fresh view is assigned wherever the old code assigned a
    fresh ``{}`` so reset semantics are unchanged.
    """

    __slots__ = ("_registry", "_prefix")

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 prefix: str = "executor.phase_seconds", *args, **kw):
        super().__init__(*args, **kw)
        self._registry = registry if registry is not None else REGISTRY
        self._prefix = prefix

    def __setitem__(self, key: str, value: float) -> None:
        super().__setitem__(key, value)
        try:
            v = float(value)
        except (TypeError, ValueError):
            return  # non-numeric write: keep dict semantics, skip the mirror
        self._registry.histogram(f"{self._prefix}.{key}", unit="s").observe(v)
