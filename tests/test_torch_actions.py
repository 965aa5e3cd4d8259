"""The port's shard-action protocol and process pool against the reference.

Wire format: a numpy action encodes to the same bytes in both packages,
and a result's GFJS payload too; each package decodes the other's
containers.  On one module-scoped spawn pool (its workers import
``repro_torch``, and so torch, once): a ``shard_executor="process"``
build equals the thread build and the monolithic build of the port and
the reference's partitioned build, worker spans stitch under
``phase:summarize`` (``obs.check --expect-shards``), worker metrics merge,
a killed worker and a timed-out action degrade to the inline thread
retry, and fault hooks never fire inline.  The port's fault hook reads its
own variable, so the reference's never reaches the port's workers.
"""

import os
import time

import numpy as np
import pytest

from repro.core.api import GraphicalJoin as RefGraphicalJoin
from repro.dist import actions as ref_actions
from repro.plan.search import plan_query as ref_plan_query
from repro.relational.encoding import encode_query as ref_encode_query
from repro.relational.synth import figure1 as ref_figure1

import repro_torch
import repro_torch.dist as dist
from repro_torch.dist import act_sharding, actions, sharding
from repro_torch.dist.actions import (FAULT_ENV, ProcessShardExecutor,
                                      ShardBuildAction, decode_action,
                                      decode_result, encode_action,
                                      encode_result, perform_action,
                                      shared_shard_executor,
                                      shutdown_shared_executor)
from repro_torch.obs.check import validate
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.plan.search import plan_query
from repro_torch.relational.encoding import encode_query
from repro_torch.relational.synth import figure1

from test_plan import SHAPES, _random_instance, _row_multiset
from torch_cases import assert_gfjs_equal, port_catalog, port_query
import torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def pool():
    """The shared spawn pool, two workers, for the whole module."""
    shutdown_shared_executor()
    yield shared_shard_executor(2)
    shutdown_shared_executor()


def figure1_actions(shard=0, **kw):
    """The same Figure 1 action in the port and in the reference."""
    out = []
    for cat_q, enc_of, plan_of, cls in (
            (figure1(), encode_query, plan_query, ShardBuildAction),
            (ref_figure1(), ref_encode_query, ref_plan_query,
             ref_actions.ShardBuildAction)):
        enc = enc_of(*cat_q)
        _, plan = plan_of(enc)
        out.append(cls(shard=shard, enc=enc, order=tuple(plan.order),
                       step_estimates={s.var: s.product_entries
                                       for s in plan.steps}, **kw))
    return out


def process_gj(cat, q, **kw):
    return repro_torch.GraphicalJoin(cat, q, device="cpu", partitions=2,
                                     shard_executor="process",
                                     generation_backend="numpy", **kw)


# ---------------------------------------------------------------------------
# wire format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shard,fault", [(0, None), (3, "kill:3")])
def test_action_bytes_equal_the_reference(shard, fault):
    act, ref_act = figure1_actions(shard=shard, fault=fault)
    data = encode_action(act)
    assert data == ref_actions.encode_action(ref_act)
    for back in (decode_action(data), ref_actions.decode_action(data)):
        assert back.shard == shard and back.fault == fault
        assert back.order == act.order and back.backend == "numpy"
        assert back.step_estimates == pytest.approx(act.step_estimates)
        for a, b in zip(act.enc.encoded_tables, back.enc.encoded_tables):
            assert sorted(a) == sorted(b)
            for v in a:
                np.testing.assert_array_equal(a[v], b[v])


def test_result_bytes_equal_the_reference():
    act, ref_act = figure1_actions()
    res, ref_res = perform_action(act), ref_actions.perform_action(ref_act)
    data, ref_data = encode_result(res), ref_actions.encode_result(ref_res)
    header, payload = actions._unpack(data, actions.KIND_RESULT)
    ref_header, ref_payload = ref_actions._unpack(ref_data,
                                                  actions.KIND_RESULT)
    assert payload == ref_payload             # the shard's GFJS blob
    assert sorted(header) == sorted(ref_header)
    assert header["join_size"] == ref_header["join_size"]
    assert header["step_products"] == ref_header["step_products"]
    # the port's elimination steps carry product / marginal children the
    # reference lacks; every other span is the reference's, in its order
    assert [s["name"] for s in header["spans"] if s["cat"] != "substep"] \
        == [s["name"] for s in ref_header["spans"]]
    assert {s["name"] for s in header["spans"] if s["cat"] == "substep"} \
        == {f"eliminate:{v}:{part}" for v in act.order[:-1]
            for part in ("product", "marginal")}
    for got in (decode_result(data), decode_result(ref_data),
                ref_actions.decode_result(data)):
        assert_gfjs_equal(got.gfjs, ref_res.gfjs)
    root = decode_result(data).spans[-1]
    assert root["name"] == "shard:0"


def test_bad_container_rejected():
    act, _ = figure1_actions()
    with pytest.raises(ValueError):
        decode_action(b"NOPE" + b"\0" * 32)
    with pytest.raises(ValueError):
        decode_action(encode_result(perform_action(act)))


def test_torch_action_raises_without_a_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    act, _ = figure1_actions(backend="torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        perform_action(decode_action(encode_action(act)))


# ---------------------------------------------------------------------------
# on the module's spawn pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,seed", [
    ("chain3", 3), ("star3", 5), ("triangle", 11), ("cycle4", 2),
])
def test_process_equals_thread_equals_monolithic(pool, shape, seed):
    cat, query = _random_instance(shape, seed)
    pcat, pq = port_catalog(cat), port_query(query)
    all_vars = sorted(query.variables)
    mono = repro_torch.GraphicalJoin(pcat, pq, device="cpu")
    thr = repro_torch.GraphicalJoin(pcat, pq, device="cpu", partitions=2)
    prc = process_gj(pcat, pq)
    ref = RefGraphicalJoin(cat, query, partitions=2,
                           shard_executor="process")
    g_thr, g_prc, g_ref = thr.run(), prc.run(), ref.run()
    assert prc._executor.shard_report["executor"] == "process"
    assert prc._executor.shard_report["retries"] == 0
    for a, b, c in zip(g_prc.shards, g_thr.shards, g_ref.shards):
        assert_gfjs_equal(a, b)
        assert_gfjs_equal(a, c)
    m0 = _row_multiset(mono, mono.run(), all_vars).astype(np.int64)
    for gj, g in ((thr, g_thr), (prc, g_prc)):
        m = np.stack([gj.desummarize(g, decode=False)[v].numpy()
                      for v in all_vars], axis=1).astype(np.int64)
        np.testing.assert_array_equal(m[np.lexsort(m.T[::-1])], m0)


def test_torch_backend_keeps_threads(pool):
    cat, q = figure1()
    gj = process_gj(cat, q)
    gj.run()
    assert gj._executor.shard_report["executor"] == "process"
    gj2 = repro_torch.GraphicalJoin(cat, q, device="cpu", partitions=2,
                                    shard_executor="process")
    g2 = gj2.run()
    assert gj2.plan().backends["summarize"] == "torch"
    assert gj2._executor.shard_report["executor"] == "thread"
    assert all(s._launch for s in g2.shards)      # generated by the engine


def test_process_spans_stitch_under_summarize(pool):
    cat, q = figure1()
    tracer = Tracer()
    process_gj(cat, q, tracer=tracer).run()
    assert validate(tracer.to_chrome_trace(), expect_shards=True) == []
    shard_spans = tracer.find("shard")
    assert len(shard_spans) == 2
    summarize = [s for s in tracer.spans if s.name == "phase:summarize"]
    assert len(summarize) == 1
    for sp in shard_spans:
        assert sp.parent_id == summarize[0].span_id
        assert summarize[0].t0 <= sp.t1 <= summarize[0].t1 + 1e-6
        kids = [s for s in tracer.spans if s.parent_id == sp.span_id]
        assert any(s.name.startswith("eliminate:") for s in kids)


def test_thread_spans_stitch_under_summarize():
    cat, q = figure1()
    tracer = Tracer()
    repro_torch.GraphicalJoin(cat, q, device="cpu", partitions=2,
                              tracer=tracer).run()
    assert validate(tracer.to_chrome_trace(), expect_shards=True) == []
    names = {s.name for s in tracer.spans}
    assert {"shard:0", "shard:1", "gfjs:level:0"} <= names


def test_process_metrics_merge_into_coordinator(pool):
    cat, q = figure1()
    reg = MetricsRegistry()
    gj = process_gj(cat, q, metrics=reg)
    gj.run()
    snap = reg.snapshot()
    assert snap["gfjs.runs_per_level"]["count"] > 0
    assert snap["dist.shard_skew"]["type"] == "gauge"
    assert snap["dist.shard_seconds"]["count"] == 2
    gj_t = repro_torch.GraphicalJoin(cat, q, device="cpu", partitions=2,
                                     generation_backend="numpy")
    gj_t.run()
    rt, rp = gj_t._executor.shard_report, gj._executor.shard_report
    assert set(rt) == set(rp) and rt["sizes"] == rp["sizes"]
    assert [sorted(m) for m in rt["step_seconds"]] == \
        [sorted(m) for m in rp["step_seconds"]]


def test_worker_killed_mid_build_degrades_to_thread(pool):
    act0, _ = figure1_actions(shard=0)
    act1, _ = figure1_actions(shard=1, fault="kill:1")
    want = perform_action(act0)
    outs = pool.run([act0, act1])
    by_shard = {o.result.shard: o for o in outs}
    assert by_shard[1].retried and by_shard[1].error
    assert by_shard[1].result.join_size == want.join_size
    assert_gfjs_equal(by_shard[1].result.gfjs, want.gfjs)


def test_action_timeout_degrades_to_thread(pool):
    act0, _ = figure1_actions(shard=0, fault="hang:0:60")
    act1, _ = figure1_actions(shard=1)
    t0 = time.perf_counter()
    outs = pool.run([act0, act1], timeout=3.0)
    assert time.perf_counter() - t0 < 30.0     # never waits out the hang
    by_shard = {o.result.shard: o for o in outs}
    assert by_shard[0].retried
    assert by_shard[0].result.join_size == by_shard[1].result.join_size


def test_fault_hooks_never_fire_inline(monkeypatch):
    act, _ = figure1_actions(shard=0, fault="kill:0")
    assert perform_action(act).join_size >= 0   # not a worker: a no-op
    monkeypatch.setenv(FAULT_ENV, "kill:0")
    assert perform_action(act).join_size >= 0
    assert FAULT_ENV == "REPRO_TORCH_SHARD_FAULT" != ref_actions.FAULT_ENV


def test_degraded_query_still_exact(pool, monkeypatch):
    """A worker killed by the env hook (read at spawn) degrades to the
    thread retry and the answer still equals the reference's."""
    cat, query = _random_instance("triangle", 11)
    pcat, pq = port_catalog(cat), port_query(query)
    ref = RefGraphicalJoin(cat, query, partitions=2)
    monkeypatch.setenv(FAULT_ENV, "kill:1")
    pool._recycle()                     # fresh workers see the hook
    gj = process_gj(pcat, pq)
    g = gj.run()
    monkeypatch.delenv(FAULT_ENV)
    pool._recycle()
    assert gj._executor.shard_report["retries"] >= 1
    for a, b in zip(g.shards, ref.run().shards):
        assert_gfjs_equal(a, b)


def test_shared_executor_persists_and_grows(pool):
    assert shared_shard_executor(1) is pool        # never shrunk
    assert shared_shard_executor(2) is pool        # reused
    assert isinstance(pool, ProcessShardExecutor)


def test_dist_lazy_exports():
    assert dist.ShardBuildAction is ShardBuildAction
    assert dist.ProcessShardExecutor is ProcessShardExecutor
    assert callable(dist.choose_partition_fold)
    assert callable(dist.hash_partition_device)
    for name in ("ShardingRules", "DEFAULT_RULES", "SP_FSDP_RULES",
                 "param_specs"):
        assert getattr(dist, name) is getattr(sharding, name)
    for name in ("constrain", "use"):
        assert getattr(dist, name) is getattr(act_sharding, name)
    with pytest.raises(AttributeError):
        dist.nothing_here


def test_plan_knob_validation():
    cat, q = figure1()
    enc = encode_query(cat, q)
    with pytest.raises(ValueError):
        plan_query(enc, shard_executor="process")
    with pytest.raises(ValueError):
        plan_query(enc, partitions=2, shard_executor="gpu")
    with pytest.raises(ValueError):
        plan_query(enc, partition_fold=2)
    with pytest.raises(ValueError):
        plan_query(enc, partitions=2, partition_fold=0)
    _, plan = plan_query(enc, partitions=2, shard_executor="process",
                         partition_fold=2)
    assert (plan.shard_executor, plan.partition_fold) == ("process", 2)
    assert plan.signature() != plan_query(enc, partitions=2)[1].signature()
    text = plan.explain()
    assert "x2 fold (4 virtual)" in text and "executor=process" in text
