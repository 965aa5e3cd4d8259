"""The card's activity over the traced window, from ``torch.profiler``.

The profiler's Chrome trace holds the card's kernels and copies (CUPTI
records; the program's kernels, launched through ``ctypes``, appear only
there).  The window is the span of the ``gjbench:window`` annotation; the
host's own spans are placed on the same clock through it.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict
from typing import List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "gjbench:window"


def short_name(name: str) -> str:
    """A kernel's name without its mangling, template or arguments."""
    if name.startswith("_Z"):
        ids, i = [], 3 if name.startswith("_ZN") else 2
        while i < len(name) and name[i].isdigit():
            j = i
            while name[j].isdigit():
                j += 1
            n = int(name[i:j])
            ids.append(name[j:j + n])
            i = j + n
        return ids[-1] if ids else name[:64]
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0][:64]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class DeviceTrace:
    """Device intervals (microseconds, the profiler's clock) in the window."""

    def __init__(self, events: List[dict], host_t0: float) -> None:
        win = [e for e in events if e.get("name") == WINDOW
               and e.get("ph") == "X"]
        if not win:
            raise RuntimeError("the profiler's trace lacks the window mark")
        w = max(win, key=lambda e: e.get("dur", 0))
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.host_t0 = host_t0
        self.ops: List[Tuple[str, float, float]] = []
        for e in events:
            if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
                continue
            a = max(float(e["ts"]), self.t0)
            b = min(float(e["ts"]) + float(e.get("dur", 0)), self.t1)
            if b > a:
                name = short_name(e["name"]) if e["cat"] == "kernel" \
                    else e["name"]
                self.ops.append((name, a, b))
        self.busy = _union([(a, b) for _, a, b in self.ops])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def kernel_seconds(self, name: str) -> float:
        return sum(b - a for n, a, b in self.ops if n == name) / 1e6

    def to_trace(self, host_t: float) -> float:
        return self.t0 + (host_t - self.host_t0) * 1e6

    def device_ops(self, top: int = 10) -> List[list]:
        by = defaultdict(float)
        for n, a, b in self.ops:
            by[n] += (b - a) / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])
                [:top]]

    def idle_gaps(self, spans, top: int = 10) -> List[list]:
        """Idle time summed by the innermost host span open at the middle
        of each gap (``host`` where none is)."""
        placed = [(self.to_trace(s.t0), self.to_trace(s.t1),
                   re.sub(r"(:\d+)+$", "", s.name)) for s in spans]
        edges = [self.t0] + [x for ab in self.busy for x in ab] + [self.t1]
        by = defaultdict(float)
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            open_ = [(s1 - s0, n) for s0, s1, n in placed if s0 <= mid <= s1]
            by[min(open_)[1] if open_ else "host"] += (b - a) / 1e6
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])
                [:top]]


class Profiler:
    """``torch.profiler`` over the window; :meth:`read` parses its trace."""

    def __init__(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA],
                             acc_events=True)

    def __enter__(self) -> "Profiler":
        self._prof.__enter__()
        return self

    def window(self):
        from torch.profiler import record_function
        return record_function(WINDOW)

    def __exit__(self, *exc) -> None:
        self._prof.__exit__(*exc)

    def read(self, host_t0: float) -> Optional[DeviceTrace]:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        return DeviceTrace(events, host_t0)
