"""The readers of the program's spans, on hand-built windows: each groups
spans by the ``trace_id`` of its unit's root span (the harness's
``gjbench:<kind>``), and reads None where its spans are absent."""

from types import SimpleNamespace

import pytest

from gjbench import bench
from gjbench.window import Unit, Window
from repro_torch.obs.trace import Span

MEAN_PER_QUERY = {"download_ready_ms": "engine:download:ready",
                  "download_d2h_ms": "engine:download:d2h",
                  "download_host_ms": "engine:download:host",
                  "plan_stats_ms": "plan:stats",
                  "plan_orders_ms": "plan:orders"}
READERS = sorted(MEAN_PER_QUERY) + ["download_host_gbps", "eliminate_ms",
                                    "frame_build_ms", "group_host_ms"]


class Spans:
    """Spans on a fake clock: ``add`` opens one under ``parent`` (a root
    where None) lasting ``ms``."""

    def __init__(self):
        self.spans, self.next_id = [], 1

    def add(self, name, ms, parent=None, t0=0.0, cat="op", **args):
        sid, self.next_id = self.next_id, self.next_id + 1
        trace = parent.trace_id if parent is not None else sid
        s = Span(name=name, cat=cat, span_id=sid,
                 parent_id=parent.span_id if parent is not None else None,
                 tid=0, t0=t0, t1=t0 + ms / 1e3, args=args, trace_id=trace)
        self.spans.append(s)
        return s


def window(sp, kinds):
    """Every unit over all of the fake clock, so each root lies in it."""
    units = [Unit(k, 0.0, 100.0) for k in kinds]
    return Window(0.0, 100.0, units, 1.0, None, sp.spans)


@pytest.mark.parametrize("metric", sorted(MEAN_PER_QUERY))
def test_mean_per_query_sums_each_query_then_averages(metric):
    name = MEAN_PER_QUERY[metric]
    sp = Spans()
    q1, q2, q3 = (sp.add("gjbench:query", 1000) for _ in range(3))
    dl = sp.add("engine:download", 50, q1)
    sp.add(name, 10, dl)
    sp.add(name, 20, sp.add("phase:plan", 40, q1))
    sp.add(name, 30, q2)                          # q3 has none: counts 0
    sp.add(name, 500, sp.add("gjbench:build", 900))   # no unit's trace
    w = window(sp, ["query"] * 3)
    assert bench.reader(metric)(w) == pytest.approx((10 + 20 + 30) / 3)


def test_eliminate_counts_the_steps_not_their_children():
    sp = Spans()
    q = sp.add("gjbench:query", 1000)
    for v, ms in (("A", 40), ("B", 60)):
        step = sp.add(f"eliminate:{v}", ms, q, cat="step", product=1)
        sp.add(f"eliminate:{v}:product", ms * 0.75, step, cat="substep")
        sp.add(f"eliminate:{v}:marginal", ms * 0.25, step, cat="substep")
    sp.add("eliminate:bag[A,B]", 25, q, cat="step")
    w = window(sp, ["query"])
    assert bench.reader("eliminate_ms")(w) == pytest.approx(125.0)


def test_group_host_subtracts_the_outermost_engine_and_kernel_spans():
    sp = Spans()
    by_u1, by_a2, count = (sp.add(f"gjbench:{k}", 1000)
                           for k in ("by_U1", "by_A2", "count"))
    g = sp.add("frame:group_by", 100, by_u1)
    keys = sp.add("frame:keys", 10, g)
    sp.add("engine:upload", 2, keys)              # under a frame child
    runs = sp.add("engine:group_runs", 30, g)
    sp.add("kernel:run_boundaries", 20, runs)     # inside one: not again
    sp.add("kernel:mul_segsum", 5, g)
    sp.add("frame:group_by", 50, by_a2)
    sp.add("frame:of", 7, count)                  # COUNT(*) does not group
    w = window(sp, ["by_U1", "by_A2", "count"])
    assert bench.reader("group_host_ms")(w) == \
        pytest.approx(((100 - 2 - 30 - 5) + 50) / 2)
    assert bench.reader("frame_build_ms")(w) == pytest.approx(7 / 3)


def test_download_host_rate_is_bytes_over_seconds():
    sp = Spans()
    q1, q2 = sp.add("gjbench:query", 5000), sp.add("gjbench:query", 5000)
    sp.add("engine:download:host", 1000, q1, bytes=2_000_000_000)
    sp.add("engine:download:host", 500, q2, bytes=1_000_000_000)
    sp.add("engine:download:host", 500, sp.add("gjbench:build", 900),
           bytes=9_000_000_000)                   # set-up: not a query's
    w = window(sp, ["query", "query"])
    assert bench.reader("download_host_gbps")(w) == pytest.approx(2.0)


def test_failed_units_and_aggregate_requests_are_not_queries():
    sp = Spans()
    q = sp.add("gjbench:query", 1000, t0=0.0)
    sp.add("plan:stats", 8, q, t0=0.1)
    bad = sp.add("gjbench:query", 1000, t0=2.0)
    sp.add("plan:stats", 800, bad, t0=2.1)
    sp.add("plan:stats", 80, sp.add("gjbench:count", 1000, t0=4.0), t0=4.1)
    units = [Unit("query", 0.0, 1.0), Unit("query", 2.0, 3.0, failed=True),
             Unit("count", 4.0, 5.0)]
    w = Window(0.0, 10.0, units, 1.0, None, sp.spans)
    assert bench.reader("plan_stats_ms")(w) == pytest.approx(8.0)
    assert bench.reader("frame_build_ms")(w) is None


@pytest.mark.parametrize("metric", READERS)
def test_none_where_the_spans_are_absent(metric):
    read = bench.reader(metric)
    kinds = ["query", "by_U1"]
    assert read(window(Spans(), kinds)) is None       # untraced
    sp = Spans()
    for k in kinds:                                   # roots, nothing under
        sp.add("phase:plan", 5, sp.add(f"gjbench:{k}", 1000))
    assert read(window(sp, kinds)) is None
    # a program whose spans carry no trace id, every name present
    old = [SimpleNamespace(name=n, cat="step", span_id=i, parent_id=None,
                           t0=0.0, t1=0.01, seconds=0.01, args={"bytes": 1})
           for i, n in enumerate(["gjbench:query", "gjbench:by_U1",
                                  "eliminate:A", "frame:of",
                                  "frame:group_by"] + list(
                                      MEAN_PER_QUERY.values()))]
    assert read(Window(0.0, 1.0, [Unit(k, 0.0, 1.0) for k in kinds], 1.0,
                       None, old)) is None
