"""The port's JoinServer and trace validator against the reference's.

The cases of tests/test_server.py run through ``repro.serve.JoinServer``
over ``repro``'s service and through ``repro_torch.serve.JoinServer`` over
the port's service (``device="cpu"``) on the same Last.fm-like catalog:
a gated cold stampede collapses to one build in both, with the same
server counters; batched ``lookup`` rows equal the reference's; the
admission ceiling and the deadlines raise the same errors at the same
points.  The port's ``obs.check.validate`` gives the reference's verdict
on the traces tests/test_obs.py and tests/test_server.py build, on
broken variants of them, and on the port's own service trace.
"""

import threading
import time

import numpy as np
import pytest

from repro.core.api import GraphicalJoin as RefGraphicalJoin
from repro.obs.check import validate as ref_validate
from repro.obs.trace import Tracer as RefTracer
from repro.relational.synth import figure1 as ref_figure1
from repro.relational.synth import lastfm_like as ref_lastfm_like
from repro.serve import server as ref_server
from repro.summary.msgcache import MessageCache as RefMessageCache
from repro.summary.service import JoinService as RefService

import repro_torch.serve as port_serve
from repro_torch.obs import check
from repro_torch.obs.trace import Tracer
from repro_torch.relational.synth import lastfm_like
from repro_torch.serve import server as port_server
from repro_torch.summary import JoinService

from test_msgcache import snowflake_catalog, snowflake_query
from test_server import _gate_frames
from torch_cases import port_query
import torch_threads  # noqa: F401

LASTFM = dict(n_users=50, n_artists=40, artists_per_user=4,
              friends_per_user=3)
PACKAGES = {
    "reference": (ref_lastfm_like, RefService, ref_server, {}),
    "port": (lastfm_like, JoinService, port_server, {"device": "cpu"}),
}


def make(package, **server_kw):
    synth, service, server_mod, kw = PACKAGES[package]
    cat, qs = synth(**LASTFM)
    svc = service(cat, **kw)
    return qs, svc, server_mod.JoinServer(svc, **server_kw), server_mod


def stampede(package, n=8, tracer=None):
    """``n`` racers on one cold key, the build gated until every waiter
    has parked; returns (build calls, replies, server stats)."""
    qs, svc, server, _ = make(package, tracer=tracer)
    q = qs["lastfm_B"]
    plan = svc.compile(q)
    entered, release = threading.Event(), threading.Event()
    calls = _gate_frames(svc, entered, release)
    replies = [None] * n

    def worker(i):
        replies[i] = server.frame(q, plan=plan)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    ts[0].start()
    assert entered.wait(10.0)
    for t in ts[1:]:
        t.start()
    while sum(fl.waiters
              for fl in server._flights._flights.values()) < n - 1:
        time.sleep(0.001)
    release.set()
    for t in ts:
        t.join()
    return calls, replies, server.stats()


def test_cold_stampede_collapses_as_in_reference():
    want = stampede("reference")
    calls, replies, stats = stampede("port")
    assert calls == want[0] == ["lastfm_B"]
    assert sorted(r.source for r in replies) == \
        sorted(r.source for r in want[1])
    assert [r.source for r in replies].count("collapsed") == 7
    assert stats == want[2]
    assert {r.frame.count() for r in replies} == {want[1][0].frame.count()}


def lookup_rows_of(package):
    qs, svc, server, _ = make(package)
    q = qs["lastfm_A1"]
    aggs = {"n": "count", "s": ("sum", "A1"), "m": ("mean", "A2")}
    keys = np.concatenate([np.arange(0, 50, 3), [10 ** 9]])
    out = [server.lookup(q, "U1", keys, aggs)]
    svc.append("user_friends", {"userID": np.asarray([0, 1, 52]),
                                "friendID": np.asarray([2, 51, 0])})
    out.append(server.lookup(q, "U1", keys, aggs))
    return out, server.stats(), svc.frame(q).frame


def test_lookup_rows_match_reference_and_group_by():
    want, want_stats, _ = lookup_rows_of("reference")
    got, stats, frame = lookup_rows_of("port")
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    assert stats == want_stats
    keys = np.concatenate([np.arange(0, 50, 3), [10 ** 9]])
    aggs = {"n": "count", "s": ("sum", "A1"), "m": ("mean", "A2")}
    table = frame.group_by(["U1"], **aggs)
    np.testing.assert_array_equal(
        got[1], port_server.lookup_rows(table, "U1", list(aggs), keys))


def test_concurrent_lookups_batch_as_in_reference():
    def run(package):
        qs, svc, server, _ = make(package)
        q = qs["lastfm_B"]
        plan = svc.compile(q)
        entered, release = threading.Event(), threading.Event()
        _gate_frames(svc, entered, release)
        outs = {}

        def prober(i):
            outs[i] = server.lookup(q, "U1", np.arange(i, i + 3),
                                    {"n": "count"}, plan=plan)

        ts = [threading.Thread(target=prober, args=(i,)) for i in range(4)]
        ts[0].start()
        assert entered.wait(10.0)
        for t in ts[1:]:
            t.start()
        while sum(len(b.pending) for b in server._batchers.values()) < 3:
            time.sleep(0.001)
        release.set()
        for t in ts:
            t.join()
        return outs, server.stats()

    (want, want_stats), (got, stats) = run("reference"), run("port")
    for i in range(4):
        np.testing.assert_array_equal(got[i], want[i])
    assert stats == want_stats
    assert stats["probes"] == 1 and stats["batched"] == 3


@pytest.mark.parametrize("package", ["reference", "port"])
def test_admission_and_deadlines(package):
    qs, svc, _, mod = make(package)
    q = qs["lastfm_A1"]
    plan = svc.compile(q)
    server = mod.JoinServer(svc, cost_ceiling=plan.admission_cost() / 2)
    with pytest.raises(mod.AdmissionRejected):
        server.frame(q, plan=plan)
    svc.frame(q, plan=plan)
    assert server.frame(q, plan=plan).source == "memory"
    # a queued build whose deadline passes raises DeadlineExceeded
    tri = qs["lastfm_tri"]
    tplan = svc.compile(tri)
    queued = mod.JoinServer(svc, cost_ceiling=tplan.admission_cost() / 2,
                            admission="queue", max_expensive_builds=1)
    queued._build_slots.acquire()
    try:
        with pytest.raises(mod.DeadlineExceeded):
            queued.frame(tri, plan=tplan, deadline=0.05)
    finally:
        queued._build_slots.release()
    assert queued.frame(tri, plan=tplan, deadline=30.0).source == "computed"
    # waiters on a gated build expire cleanly; the leader completes
    svc2 = type(svc)(svc.catalog, **PACKAGES[package][3])
    waiting = mod.JoinServer(svc2)
    bplan = svc2.compile(qs["lastfm_B"])
    entered, release = threading.Event(), threading.Event()
    _gate_frames(svc2, entered, release)
    errs, lead = [], []
    tl = threading.Thread(target=lambda: lead.append(
        waiting.frame(qs["lastfm_B"], plan=bplan)))
    tl.start()
    assert entered.wait(10.0)

    def waiter():
        try:
            waiting.frame(qs["lastfm_B"], plan=bplan, deadline=0.05)
        except mod.DeadlineExceeded as e:
            errs.append(e)

    tw = [threading.Thread(target=waiter) for _ in range(3)]
    for t in tw:
        t.start()
    for t in tw:
        t.join()
    release.set()
    tl.join()
    assert len(errs) == 3 and lead[0].source == "computed"
    st = (server.stats(), queued.stats(), waiting.stats())
    assert [s["rejected"] for s in st] == [1, 0, 0]
    assert [s["deadline_expired"] for s in st] == [0, 1, 3]
    assert plan.admission_cost() > 0


def test_admission_costs_equal_the_reference():
    (ref_qs, ref_svc, _, _), (qs, svc, _, _) = make("reference"), make("port")
    for name in ("lastfm_A1", "lastfm_A2", "lastfm_B", "lastfm_tri"):
        assert svc.compile(qs[name]).admission_cost() == \
            ref_svc.compile(ref_qs[name]).admission_cost()


def test_serve_package_names():
    import repro.serve as ref_serve
    from repro_torch.serve import engine as port_engine
    assert port_serve.JoinServer is port_server.JoinServer
    assert set(port_serve.__all__) == set(ref_serve.__all__) == {
        "AdmissionRejected", "DeadlineExceeded", "JoinServer",
        "SingleFlight", "lookup_rows", "RelationalFeatureProvider",
        "ServeConfig", "ServeEngine", "make_serve_step"}
    for name in ("RelationalFeatureProvider", "ServeConfig", "ServeEngine",
                 "make_serve_step"):
        assert getattr(port_serve, name) is getattr(port_engine, name)
    with pytest.raises(AttributeError, match="no attribute"):
        port_serve.TrainEngine


# -- the validator ------------------------------------------------------------

def reference_traces():
    """name -> Chrome trace doc, built by the reference as its tests do."""
    docs = {}
    cat, query = ref_figure1()
    tr = RefTracer()
    gj = RefGraphicalJoin(cat, query, tracer=tr)
    gj.desummarize(gj.run())
    docs["monolithic"] = tr.to_chrome_trace()
    lf, lqs = ref_lastfm_like(n_users=40, n_artists=30, artists_per_user=4,
                              friends_per_user=3, seed=1)
    tr = RefTracer()
    RefGraphicalJoin(lf, lqs["lastfm_A1"], partitions=2, tracer=tr).run()
    docs["sharded"] = tr.to_chrome_trace()
    tr = RefTracer()
    stampede_traced(tr)
    docs["server"] = tr.to_chrome_trace()
    tr = RefTracer()
    mc = RefMessageCache()
    scat = snowflake_catalog(seed=0)
    for q in (snowflake_query("a", "fact0", (0, 1)),
              snowflake_query("b", "fact1", (0, 1))):
        RefGraphicalJoin(scat, q, message_cache=mc, tracer=tr).run()
    docs["msgcache"] = tr.to_chrome_trace()
    phases = [{"name": f"phase:{p}", "ph": "X", "ts": 0, "dur": 1,
               "pid": 1, "tid": 1, "args": {"span_id": i}}
              for i, p in enumerate(("build_model", "plan",
                                     "build_generator", "summarize"))]
    docs["no-eliminate"] = {"traceEvents": phases}
    docs["est-without-drift"] = {"traceEvents": phases + [
        {"name": "eliminate:X", "ph": "X", "ts": 0, "dur": 1, "pid": 1,
         "tid": 1, "args": {"span_id": 99, "product": 3, "est": 4.0}}]}
    stripped = {"traceEvents": [dict(ev, args={
        k: v for k, v in ev.get("args", {}).items() if k != "source"})
        for ev in docs["server"]["traceEvents"]]}
    docs["server-without-sources"] = stripped
    docs["not-a-trace"] = {"nope": 1}
    docs["empty"] = {"traceEvents": []}
    return docs


def stampede_traced(tracer):
    """The reference's traced collapse plus a lookup (test_server.py)."""
    cat, qs = ref_lastfm_like(**LASTFM)
    svc = RefService(cat)
    server = ref_server.JoinServer(svc, tracer=tracer)
    q = qs["lastfm_A1"]
    plan = svc.compile(q)
    entered, release = threading.Event(), threading.Event()
    _gate_frames(svc, entered, release)
    tl = threading.Thread(target=lambda: server.frame(q, plan=plan))
    tw = threading.Thread(target=lambda: (entered.wait(10.0),
                                          server.frame(q, plan=plan)))
    tl.start()
    assert entered.wait(10.0)
    tw.start()
    while sum(fl.waiters for fl in server._flights._flights.values()) < 1:
        time.sleep(0.001)
    release.set()
    tl.join()
    tw.join()
    server.lookup(q, "U1", np.asarray([1, 2, 3]), {"n": "count"}, plan=plan)


FLAGS = [dict(), dict(expect_shards=True), dict(expect_server=True),
         dict(expect_msgcache=True),
         dict(expect_server=True, expect_msgcache=True)]


@pytest.fixture(scope="module")
def traces():
    return reference_traces()


@pytest.mark.parametrize("flags", FLAGS,
                         ids=lambda f: "+".join(f) or "plain")
def test_validator_verdicts_equal_the_reference(traces, flags):
    verdicts = {}
    for name, doc in traces.items():
        got, want = check.validate(doc, **flags), ref_validate(doc, **flags)
        assert got == want, name
        verdicts[name] = not got
    assert verdicts["monolithic"] == (not flags)
    assert not verdicts["empty"] and not verdicts["not-a-trace"]


def test_port_service_trace_validates(tmp_path):
    """The port's own serving trace: a server in front of a service with
    message reuse; the second query's build reuses the first's messages."""
    import json
    from torch_cases import port_catalog
    tr = Tracer()
    cat = port_catalog(snowflake_catalog(seed=0))
    svc = JoinService(cat, incremental=False, device="cpu")
    server = port_server.JoinServer(svc, tracer=tr)
    for name, fact in (("a", "fact0"), ("b", "fact1")):
        server.frame(port_query(snowflake_query(name, fact, (0, 1))))
    path = tr.write_chrome_trace(str(tmp_path / "svc.trace.json"))
    with open(path) as f:
        doc = json.load(f)
    # the reference knows no ``substep`` spans (an elimination step's
    # product and marginal): the verdicts agree on the trace without them
    steps = {"traceEvents": [e for e in doc["traceEvents"]
                             if e.get("cat") != "substep"]}
    assert len(steps["traceEvents"]) < len(doc["traceEvents"])
    for flags in FLAGS:
        assert check.validate(doc, **flags) == check.validate(steps, **flags)
        assert check.validate(steps, **flags) == \
            ref_validate(steps, **flags)
    assert check.validate(doc, expect_server=True,
                          expect_msgcache=True) == []
    assert check.main([path, "--expect-server", "--expect-msgcache"]) == 0
