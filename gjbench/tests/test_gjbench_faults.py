"""A whole run on the CPU, past the look for a card, with the timed path
broken underneath: ``correct`` comes out false for every fault the cell
can have (one chip, so no exchange between chips to leave out)."""

import pytest
import torch

import repro_torch
from repro_torch.summary import JoinService
from gjbench import bench, run
from gjbench.tests.conftest import SMALL


def drive(name, seed=2**31 + 9):
    cell = bench.cell(name)
    return run.drive(cell, seed, 0.3, False, "cpu",
                     sizes=SMALL[cell.config["name"]])


def rows_fault(how):
    real = repro_torch.GraphicalJoin.desummarize

    def broken(self, gfjs, **kw):
        cols = real(self, gfjs, **kw)
        v = sorted(cols)[0]
        if how == "alter":                   # one code altered where made
            c = cols[v].clone()
            c[len(c) // 2] = (c[len(c) // 2] + 1) % len(gfjs.domains[v].values)
            cols[v] = c
        elif how == "half":                  # half of the rows left out
            cols = {k: c[: len(c) // 2] for k, c in cols.items()}
        elif how == "stale":                 # the state returned unchanged
            cols = {k: torch.zeros_like(c) for k, c in cols.items()}
        return cols
    return broken


@pytest.mark.parametrize("name", ["lastfm.a2_rows", "tpch_sf1.fk_rows"])
@pytest.mark.parametrize("how", ["alter", "half", "stale"])
def test_a_broken_rows_path_is_not_correct(monkeypatch, name, how):
    assert drive(name)["correct"] is True
    monkeypatch.setattr(repro_torch.GraphicalJoin, "desummarize",
                        rows_fault(how))
    out = drive(name)
    assert out["correct"] is False and out["failed"] == 0


def test_a_query_that_raises_is_counted_failed(monkeypatch):
    def boom(self, gfjs, **kw):
        raise RuntimeError("planted")
    monkeypatch.setattr(repro_torch.GraphicalJoin, "desummarize", boom)
    out = drive("lastfm.a2_rows")
    assert out["failed"] == out["attempted"] > 0 and out["correct"] is False


@pytest.mark.parametrize("how", ["count", "groups", "group_count"])
def test_a_broken_aggregate_is_not_correct(monkeypatch, how):
    assert drive("lastfm.a2_aggs")["correct"] is True
    count, group_by = JoinService.count, JoinService.group_by
    if how == "count":                       # an answer altered
        monkeypatch.setattr(JoinService, "count",
                            lambda self, *a, **k: count(self, *a, **k) + 1)
    else:
        def broken(self, *a, **k):
            g = group_by(self, *a, **k)
            if how == "groups":              # half of the groups left out
                return {c: v[: len(v) // 2] for c, v in g.items()}
            g["count"] = g["count"].copy()
            g["count"][0] += 1
            return g
        monkeypatch.setattr(JoinService, "group_by", broken)
    out = drive("lastfm.a2_aggs")
    assert out["correct"] is False
