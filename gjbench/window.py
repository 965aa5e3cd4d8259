"""What one run measured: the units of work in the window and their spans.

A unit is one query (query to rows) or one aggregate request.  The window
runs from its start to the end of the last round of units started within
``--seconds``; every rate is over all of it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class Unit:
    kind: str
    t0: float
    t1: float
    rows: int = 0
    failed: bool = False
    timings: Dict[str, float] = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclass
class Window:
    t0: float
    t1: float
    units: List[Unit]
    setup_s: float
    peak_bytes: Optional[int] = None          # the card's, over the window
    spans: List[Any] = field(default_factory=list)   # traced runs only
    device: Any = None                         # devtrace.DeviceTrace

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    @property
    def done(self) -> List[Unit]:
        return [u for u in self.units if not u.failed]

    def spans_named(self, name: str) -> List[Any]:
        return [s for s in self.spans if s.name == name]

    def span_seconds(self, *names: str) -> float:
        return sum(s.seconds for s in self.spans if s.name in names)

    def mean(self, values: List[float]) -> Optional[float]:
        return sum(values) / len(values) if values else None
