"""The window's arithmetic on a fake clock: whole rounds, rates over all
of the window, the tail over every query."""

import pytest

from gjbench import bench, load, run
from gjbench.window import Unit, Window


def window(latencies, rows=1000, seconds=None, failed=()):
    t, units = 0.0, []
    for i, s in enumerate(latencies):
        units.append(Unit("query", t, t + s, rows=rows, failed=i in failed))
        t += s
    return Window(0.0, t if seconds is None else seconds, units, 2.5, 7e9)


def test_rows_per_s_counts_every_row_over_the_whole_window():
    w = window([0.5] * 10, seconds=5.5)
    assert bench.reader("rows_per_s")(w) == pytest.approx(10_000 / 5.5)


def test_query_p90_is_the_nearest_rank():
    w = window([float(i) for i in range(1, 101)])
    assert bench.reader("query_p90_s")(w) == 90.0
    w = window([float(i) for i in range(1, 11)])
    assert bench.reader("query_p90_s")(w) == 9.0


def test_a_failed_query_is_the_slowest_and_delivers_nothing():
    w = window([1.0] * 10, failed={3})
    assert bench.reader("query_p90_s")(w) == 1.0
    assert bench.reader("rows_per_s")(w) == pytest.approx(9000 / 10.0)
    w = window([1.0] * 5, failed={3})
    assert bench.reader("query_p90_s")(w) == float("inf")


def test_peak_and_setup():
    w = window([1.0])
    assert bench.reader("peak_gb")(w) == 7.0
    assert bench.reader("setup_s")(w) == 2.5
    assert bench.reader("aggs_per_s")(w) is None


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class FakeLoop:
    """Each round takes 0.4 s on the fake clock and delivers 1,000 rows."""

    clock = None

    def __init__(self, cfg, traffic, data, dev, seed, tracer=None):
        self.rounds = 0

    def warm(self):
        self.clock.t += 3.0

    def round(self):
        t0 = self.clock.t
        self.clock.t += 0.4
        self.rounds += 1
        return [Unit("query", t0, self.clock.t, rows=1000)]

    def release(self):
        pass

    def checks(self, window):
        return {"row_count_gap": (0, 0)}


def test_the_window_ends_with_the_last_round_started_inside_it(monkeypatch):
    clock = FakeClock()
    FakeLoop.clock = clock
    monkeypatch.setattr(load, "now", clock)
    monkeypatch.setattr(load, "LOOPS", {"fresh_query": FakeLoop})
    cell = bench.cell("lastfm.a2_rows")
    out = run.drive(cell, 1, 1.0, False, "cpu", t_start=99.0,
                    sizes={"n_users": 20, "n_artists": 30,
                           "user_artists": 60, "friends_per_user": 2})
    # rounds start at 0, 0.4 and 0.8 s; the third ends the window at 1.2 s
    assert out["attempted"] == 3
    m = out["metrics"]
    assert m["rows_per_s"]["value"] == pytest.approx(3000 / 1.2)
    w = Window(0.0, 1.2, out["units"], 4.0)
    assert bench.reader("query_p90_s")(w) == pytest.approx(0.4)
    assert m["setup_s"]["value"] == pytest.approx(4.0)
    assert out["correct"] is True
