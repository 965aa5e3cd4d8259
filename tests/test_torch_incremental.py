"""The port's incremental refresh against the reference's.

The differential harness of tests/test_incremental.py (its query shapes,
seeds 0-2, four random appends each, values past the domain so that
domains grow) runs the same appends through ``repro`` and through
``repro_torch`` (``device="cpu"``).  After every append the port's
refreshed GFJS equals the reference's level for level and equals the
port's own rebuild under ``state.plan``; the port's rows and aggregates
of the refreshed summary equal those of the rebuild.  Around it: the
refresh report, the executor's three ``record_trace`` refusals, batched
and stale delta chains, and the service's lazy refresh.
"""

import numpy as np
import pytest

from repro.core.api import GraphicalJoin as RefGraphicalJoin
from repro.relational.synth import lastfm_like as ref_lastfm_like
from repro.summary.incremental import refresh_state as ref_refresh_state
from repro.summary.service import JoinService as RefService

from repro_torch.core.api import GraphicalJoin
from repro_torch.relational.synth import figure1, lastfm_like
from repro_torch.summary import (DeltaError, IncrementalState, JoinService,
                                 StaleDeltaError, capture_state,
                                 refresh_state)
from repro_torch.summary.algebra import SummaryFrame

from test_incremental import SHAPES, random_block, random_instance
from test_torch_algebra import assert_same
from torch_cases import assert_gfjs_equal, port_catalog, port_query
import torch_threads  # noqa: F401

CASES = [(s, seed) for s in SHAPES for seed in range(3)]


def frame_answers(gfjs):
    """Every aggregate the algebra answers, over a port summary."""
    frame = SummaryFrame.of(gfjs, "cpu")
    out = [frame.count()]
    for v in gfjs.column_order:
        out += [frame.sum(v), frame.min(v), frame.max(v),
                frame.count_distinct(v)]
        if gfjs.join_size:
            out.append(frame.mean(v))
    if gfjs.join_size:
        key, val = gfjs.column_order[0], gfjs.column_order[-1]
        out.append(frame.group_by(key, n="count", total=("sum", val)))
    return out


@pytest.mark.parametrize("shape,seed", CASES)
def test_refresh_equals_reference_and_rebuild(shape, seed):
    ref_cat, ref_q, domain, rng = random_instance(shape, seed)
    cat, q = port_catalog(ref_cat), port_query(ref_q)
    ref_gj = RefGraphicalJoin(ref_cat, ref_q, record_trace=True)
    ref_state = ref_gj.capture_state(ref_gj.run())
    gj = GraphicalJoin(cat, q, record_trace=True, device="cpu")
    state = gj.capture_state(gj.run())
    assert isinstance(state, IncrementalState)
    assert state.plan.order == ref_state.plan.order
    assert not state.gfjs._launch          # traced: numpy generation
    assert_gfjs_equal(state.gfjs, ref_state.gfjs)

    tables = list(ref_cat.names())
    for _ in range(4):
        tname = tables[int(rng.integers(0, len(tables)))]
        block = random_block(rng, ref_cat[tname], domain)
        ref_state = ref_gj.refresh(ref_state,
                                   ref_cat.append(tname, dict(block)))
        state = gj.refresh(state, cat.append(tname, dict(block)))
        assert state.table_versions == ref_state.table_versions
        assert "refresh" in gj.timings
        assert gj._executor.refresh_report["dirty_steps"] == \
            ref_gj._executor.refresh_report["dirty_steps"]
        assert_gfjs_equal(state.gfjs, ref_state.gfjs)

        rebuilt = GraphicalJoin(cat, q, plan=state.plan, device="cpu").run()
        assert_gfjs_equal(state.gfjs, rebuilt)
        got = gj.desummarize(state.gfjs, decode=True)
        want = gj.desummarize(rebuilt, decode=True)
        for v in rebuilt.column_order:
            np.testing.assert_array_equal(got[v], want[v])
        for a, b in zip(frame_answers(state.gfjs), frame_answers(rebuilt)):
            assert_same(a, b)


@pytest.mark.parametrize("shape,seed", [("chain3", 11), ("triangle", 12)])
def test_batched_deltas_match_reference(shape, seed):
    ref_cat, ref_q, domain, rng = random_instance(shape, seed)
    cat, q = port_catalog(ref_cat), port_query(ref_q)
    ref_gj = RefGraphicalJoin(ref_cat, ref_q, record_trace=True)
    ref_state = ref_gj.capture_state(ref_gj.run())
    gj = GraphicalJoin(cat, q, record_trace=True, device="cpu")
    state = gj.capture_state(gj.run())
    ref_deltas, deltas = [], []
    for tname in ref_cat.names():
        for _ in range(2):
            block = random_block(rng, ref_cat[tname], domain)
            ref_deltas.append(ref_cat.append(tname, dict(block)))
            deltas.append(cat.append(tname, dict(block)))
    ref_state, ref_report = ref_refresh_state(ref_state, ref_deltas)
    state, report = refresh_state(state, deltas)
    assert report["dirty_steps"] == ref_report["dirty_steps"]
    assert_gfjs_equal(state.gfjs, ref_state.gfjs)


def test_stale_chain_and_zero_row_append():
    cat, q = figure1()
    gj = GraphicalJoin(cat, q, record_trace=True, device="cpu")
    state = gj.capture_state(gj.run())
    noop = cat["table1"].append({"A": [], "B": []})
    same, report = refresh_state(state, [noop])
    assert report["dirty_steps"] == 0
    assert_gfjs_equal(same.gfjs, state.gfjs)
    d1 = cat.append("table1", {"A": ["a0"], "B": ["b0"]})
    d2 = cat.append("table1", {"A": ["a1"], "B": ["b1"]})
    with pytest.raises(StaleDeltaError):
        refresh_state(state, [d2])
    assert issubclass(StaleDeltaError, DeltaError)
    state = gj.refresh(state, [d1, d2])
    rebuilt = GraphicalJoin(cat, q, plan=state.plan, device="cpu").run()
    assert_gfjs_equal(state.gfjs, rebuilt)


def test_record_trace_refusals_match_reference():
    cat, q = figure1()
    with pytest.raises(ValueError, match="hybrid=True"):
        GraphicalJoin(cat, q, record_trace=True, hybrid=True, device="cpu")
    with pytest.raises(ValueError, match="partitioned plan"):
        GraphicalJoin(cat, q, record_trace=True, partitions=2, device="cpu")
    tri = lastfm_like(n_users=30, n_artists=20, artists_per_user=3,
                      friends_per_user=3)
    tcat, tq = tri[0], tri[1]["lastfm_tri"]
    plan = GraphicalJoin(tcat, tq, hybrid=True, device="cpu").plan()
    assert plan.bags
    with pytest.raises(ValueError, match="bag steps"):
        GraphicalJoin(tcat, tq, plan=plan, record_trace=True, device="cpu")
    # an untraced run has nothing to capture
    gj = GraphicalJoin(cat, q, device="cpu")
    with pytest.raises(ValueError, match="record_trace"):
        capture_state(gj, gj.run())


def test_traced_summarize_is_numpy_and_untraced_is_torch():
    from repro_torch.obs.trace import Tracer
    cat, q = figure1()
    for traced, backend in ((True, "numpy"), (False, "torch")):
        tr = Tracer()
        gj = GraphicalJoin(cat, q, record_trace=traced, tracer=tr,
                           device="cpu")
        gfjs = gj.run()
        assert tr.find("phase:summarize")[0].args["backend"] == backend
        assert bool(gfjs._launch) == (not traced)
        assert (gj._executor.expansion_cache is not None) == traced


def test_service_refreshes_as_the_reference_does():
    """Service-level differential with growing domains (the reference's
    test_service_refresh_differential_with_growth), held to the
    reference's sources and counts."""
    kw = dict(n_users=30, n_artists=20, artists_per_user=3,
              friends_per_user=2)
    (ref_cat, ref_qs), (cat, qs) = ref_lastfm_like(**kw), lastfm_like(**kw)
    ref, svc = RefService(ref_cat), JoinService(cat, device="cpu")
    ref.frame(ref_qs["lastfm_B"])
    svc.frame(qs["lastfm_B"])
    rng = np.random.default_rng(9)
    for _ in range(3):
        for table, cols, hi in (("user_artists", ("userID", "artistID"),
                                 (35, 40)),
                                ("user_friends", ("userID", "friendID"),
                                 (35, 35))):
            rows = {c: rng.integers(0, h, 4) for c, h in zip(cols, hi)}
            ref.append(table, dict(rows))
            svc.append(table, dict(rows))
        want, got = ref.frame(ref_qs["lastfm_B"]), svc.frame(qs["lastfm_B"])
        assert got.source == want.source == "refreshed"
        assert "refresh" in got.timings
        assert_gfjs_equal(got.frame.gfjs, want.frame.gfjs)
        assert got.frame.count() == want.frame.count()
        cold = JoinService(cat, incremental=False, device="cpu")
        assert got.frame.count() == cold.count(qs["lastfm_B"])
    st, ref_st = svc.stats(), ref.stats()
    assert st["refreshed_requests"] == ref_st["refreshed_requests"] == 3
    assert st == ref_st
