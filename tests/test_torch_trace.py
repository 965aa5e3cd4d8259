"""The port's spans: one ``trace_id`` per request, and the spans inside
the planner, the elimination steps, the summary algebra and the download.

All on the CPU at the paper's Figure 1 sizes; the staged download's
chunks and the profiler's clock are checked on the card in
``test_torch_gpu.py``.
"""

import json
import threading

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import elimination, engine
from repro_torch.obs import trace
from repro_torch.obs.trace import NULL_SPAN, Tracer, span, span_in
from repro_torch.plan import search
from repro_torch.relational.synth import figure1
from repro_torch.summary import JoinService, algebra

import torch_threads  # noqa: F401


def test_trace_id_is_inherited_through_the_ambient_context():
    tr = Tracer()
    with tr.span("root") as root:
        with span("child") as child:
            with span("grandchild") as grand:
                pass
    with tr.span("other") as other:
        pass
    assert root.trace_id == root.span_id
    assert child.trace_id == grand.trace_id == root.span_id
    assert grand.parent_id == child.span_id
    assert other.trace_id == other.span_id != root.trace_id


def test_trace_id_crosses_threads_with_an_explicit_parent():
    tr = Tracer()
    got = {}

    def worker():
        with tr.span("worker", parent=root) as w:
            with span("inner") as inner:
                got["w"], got["inner"] = w, inner
        with span_in(tr, root, "handed") as handed:
            got["handed"] = handed

    with tr.span("root") as root:
        with span("child") as child:
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
    assert {s.trace_id for s in got.values()} == {root.span_id}
    assert got["w"].parent_id == got["handed"].parent_id == root.span_id
    assert child.trace_id == root.span_id


def test_trace_id_survives_records_graft_and_the_chrome_export():
    worker = Tracer()
    with worker.span("shard:0"):
        with span("eliminate:B"):
            pass
    records = worker.records()
    assert {r["trace_id"] for r in records} == \
        {s.span_id for s in worker.spans if s.parent_id is None}

    tr = Tracer()
    with tr.span("phase:summarize") as parent:
        grafted = tr.graft(records, parent=parent)
    assert {s.trace_id for s in grafted} == {parent.span_id}
    loose = tr.graft(records)                      # no parent: own root
    root = [s for s in loose if s.parent_id is None]
    assert len(root) == 1 and {s.trace_id for s in loose} == {root[0].span_id}

    doc = json.loads(json.dumps(tr.to_chrome_trace()))
    by_id = {e["args"]["span_id"]: e["args"]["trace_id"]
             for e in doc["traceEvents"] if e["ph"] == "X"}
    assert by_id == {s.span_id: s.trace_id for s in tr.spans}


def _by_name(tr):
    out = {}
    for s in tr.spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_planner_and_elimination_spans_nest_in_their_phases():
    cat, q = figure1()
    tr = Tracer()
    with tr.span("query") as root:
        gj = repro_torch.GraphicalJoin(cat, q, device="cpu", tracer=tr)
        gj.run()
    names, ids = _by_name(tr), {s.span_id: s for s in tr.spans}
    (search_sp,) = names["plan:search"]
    (stats,) = names["plan:stats"]
    (orders,) = names["plan:orders"]
    assert stats.parent_id == orders.parent_id == search_sp.span_id
    assert stats.args["rows"] == sum(t.num_rows for t in cat.tables.values())
    assert orders.args["orders"] >= 1
    steps = [s for s in tr.spans if s.cat == "step"]
    assert len(steps) == len(gj.plan().order) - 1
    for step in steps:
        kids = sorted(s.name for s in tr.spans if s.parent_id == step.span_id)
        assert kids == [f"{step.name}:marginal", f"{step.name}:product"]
        product = names[f"{step.name}:product"][0]
        assert product.args["entries"] == step.args["product"]
        assert ids[product.parent_id].cat == "step"
    assert {s.trace_id for s in tr.spans} == {root.span_id}


def test_summary_spans_nest_under_the_request():
    cat, q = figure1()
    svc = JoinService(cat, incremental=False, device="cpu")
    svc.frame(q)                                   # built, untraced
    tr = Tracer()
    with tr.span("request") as root:
        got = svc.group_by(q, "B", n="count")
    want = svc.frame(q).frame.group_by("B", n="count")
    np.testing.assert_array_equal(got["n"], want["n"])
    names = _by_name(tr)
    (frame,) = names["service:frame"]
    (of,) = names["frame:of"]
    (group,) = names["frame:group_by"]
    assert of.parent_id == frame.span_id
    assert of.args["bytes"] == sum(lvl.freq.nbytes
                                   for lvl in svc.frame(q).frame.gfjs.levels)
    for part in ("frame:keys", "frame:rank", "frame:gather"):
        (sp,) = names[part]
        assert sp.parent_id == group.span_id
    assert names["frame:rank"][0].args["device"] is False
    assert group.parent_id == root.span_id
    assert {s.trace_id for s in tr.spans} == {root.span_id}


def test_download_spans_split_the_copy_and_carry_bytes():
    t = torch.arange(1000, dtype=torch.int32)
    tr = Tracer()
    with tr.span("root"):
        got = engine._download(t, np.int64)
        same = engine._download(t)
    np.testing.assert_array_equal(got, np.arange(1000))
    assert got.dtype == np.int64 and same.dtype == np.int32
    names = _by_name(tr)
    first, second = names["engine:download"]
    for part in ("ready", "d2h"):
        assert [s.parent_id for s in names[f"engine:download:{part}"]] == \
            [first.span_id, second.span_id]
    (host,) = names["engine:download:host"]       # only the widening one
    assert host.parent_id == first.span_id
    assert host.args["bytes"] == first.args["bytes"] == 4000


def test_no_tracer_every_new_site_is_the_null_span(monkeypatch):
    asked = []

    def recorded(name, **kw):
        sp = span(name, **kw)
        asked.append((name, sp))
        return sp

    for mod in (engine, elimination, search, algebra):
        monkeypatch.setattr(mod, "_span", recorded)
    assert trace.current_span() is None
    cat, q = figure1()
    frame = algebra.SummaryFrame.of(
        repro_torch.GraphicalJoin(cat, q, device="cpu").run(), "cpu")
    frame.group_by("B", n="count")
    names = {n for n, _ in asked}
    assert {"plan:search", "plan:stats", "plan:orders", "frame:of",
            "frame:group_by", "frame:keys", "frame:rank", "frame:gather",
            "eliminate:A:product", "eliminate:A:marginal"} <= names
    assert all(sp is NULL_SPAN for _, sp in asked)
    # untraced, the download asks for its own span only
    assert not any(n.startswith("engine:download:") for n in names)


@pytest.mark.parametrize("n", [0, 1])
def test_an_empty_or_single_download_is_still_split(n):
    tr = Tracer()
    with tr.span("root"):
        got = engine._download(torch.zeros(n, dtype=torch.int32), np.int64)
    assert got.shape == (n,) and got.dtype == np.int64
    assert sum(s.args["bytes"] for s in tr.find("engine:download")
               if s.name == "engine:download:host") == 4 * n
