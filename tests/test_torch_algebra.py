"""The port's summary algebra against the reference's, on the same joins.

The catalog and query generator of tests/test_summary_algebra.py (its
``SHAPES`` x seeds) go through ``repro.GraphicalJoin`` +
``repro.summary.SummaryFrame`` and through ``repro_torch`` with
``device="cpu"`` (the kernels' plain PyTorch versions), under the
reference's elimination order.  Integer aggregates must be bit-equal;
float aggregates agree to ``rtol=1e-12`` (both packages sum in float64,
in different orders).
"""

import numpy as np
import pytest

from repro.core import engine_jax
from repro.core.api import GraphicalJoin as RefGraphicalJoin
from repro.relational.synth import lastfm_like as ref_lastfm_like
from repro.relational.table import Catalog as RefCatalog, Table as RefTable
from repro.summary.algebra import SummaryFrame as RefFrame

from repro_torch.core import engine
from repro_torch.core.api import GraphicalJoin
from repro_torch.core.gfjs import ShardedGFJS
from repro_torch.interop import catalog_from_arrays, gfjs_from_arrays
from repro_torch.relational.query import JoinQuery
from repro_torch.summary.algebra import ShardedSummaryFrame, SummaryFrame

from test_summary_algebra import CASES, SHAPES, random_instance
import torch_threads  # noqa: F401

RTOL = 1e-12


def assert_same(a, b):
    """Equal results: ints exactly, floats to RTOL, arrays element-wise."""
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            assert_same(a[k], b[k])
        return
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=0)
    else:
        np.testing.assert_array_equal(a, b)
        assert a.dtype.kind == b.dtype.kind


def as_float(cat):
    """The same catalog with every column as float64 (shifted off the
    integers), so sums and means take the float path."""
    return RefCatalog.of(*(
        RefTable(t.name, {c: np.asarray(v, np.float64) * 1.5 + 0.25
                          for c, v in t.columns.items()})
        for t in cat.tables.values()))


def both(cat, query, spec):
    """Reference and port frames over the same join, same order."""
    ref = RefGraphicalJoin(cat, query)
    ref_gfjs = ref.run()
    pcat = catalog_from_arrays({n: dict(t.columns)
                                for n, t in cat.tables.items()})
    port = GraphicalJoin(pcat, JoinQuery.of(query.name, spec), device="cpu",
                         elimination_order=list(ref.plan().order))
    gfjs = port.run()
    return (RefFrame.of(ref_gfjs), SummaryFrame.of(gfjs, device="cpu"),
            ref, port, gfjs)


def instance(shape, seed, floats):
    cat, query = random_instance(shape, seed)
    return (as_float(cat) if floats else cat), query


SCALAR_OPS = ("sum", "mean", "min", "max", "distinct", "count_distinct")


@pytest.mark.parametrize("floats", [False, True], ids=["int", "float"])
@pytest.mark.parametrize("shape,seed", CASES)
def test_scalar_aggregates_match_reference(shape, seed, floats):
    cat, query = instance(shape, seed, floats)
    ref, port, *_ = both(cat, query, SHAPES[shape])
    assert port.count() == ref.count()
    for v in ref.gfjs.column_order:
        for op in SCALAR_OPS:
            assert_same(getattr(port, op)(v), getattr(ref, op)(v))


@pytest.mark.parametrize("floats", [False, True], ids=["int", "float"])
@pytest.mark.parametrize("shape,seed", CASES)
def test_group_by_matches_reference(shape, seed, floats):
    cat, query = instance(shape, seed, floats)
    ref, port, *_ = both(cat, query, SHAPES[shape])
    cols = ref.gfjs.column_order
    key, val = cols[0], cols[-1]
    aggs = dict(n="count", total=("sum", val), lo=("min", val),
                hi=("max", val), avg=("mean", val))
    assert_same(port.group_by(key, **aggs), ref.group_by(key, **aggs))
    if len(cols) >= 2:
        assert_same(port.group_by(cols[:2], n="count"),
                    ref.group_by(cols[:2], n="count"))
        assert_same(port.group_by(list(reversed(cols)), s=("sum", cols[1])),
                    ref.group_by(list(reversed(cols)), s=("sum", cols[1])))


@pytest.mark.parametrize("shape,seed", CASES)
def test_filters_match_reference(shape, seed):
    cat, query = random_instance(shape, seed)
    ref, port, *_ = both(cat, query, SHAPES[shape])
    cols = ref.gfjs.column_order
    rng = np.random.default_rng(seed + 1000)
    pivot = int(rng.integers(0, 5))
    members = sorted({int(rng.integers(0, 5)) for _ in range(3)})
    preds = {cols[-1]: lambda v: v >= pivot, cols[0]: members}
    fr, fp = ref.filter(preds), port.filter(preds)
    assert fp.device == port.device
    assert fp.count() == fr.count()
    for a, b in zip(fp.weights, fr.weights):
        np.testing.assert_array_equal(a, b)
    mid = cols[len(cols) // 2]
    for op in SCALAR_OPS:
        assert_same(getattr(fp, op)(mid), getattr(fr, op)(mid))
    keys = cols[:2] if len(cols) >= 2 else cols[:1]
    aggs = dict(n="count", s=("sum", mid), lo=("min", mid),
                avg=("mean", mid))
    assert_same(fp.group_by(keys, **aggs), fr.group_by(keys, **aggs))
    # filters compose, and the filtered frame re-materializes identically
    assert fp.filter({mid: lambda v: v != pivot}).count() == \
        fr.filter({mid: lambda v: v != pivot}).count()
    got, want = fp.to_gfjs(), fr.to_gfjs()
    assert got.join_size == want.join_size
    for la, lb in zip(got.levels, want.levels):
        assert tuple(la.vars) == tuple(lb.vars)
        np.testing.assert_array_equal(la.freq, lb.freq)
        for v in la.vars:
            np.testing.assert_array_equal(la.key_cols[v], lb.key_cols[v])


def lastfm_frames(n_users=150, n_artists=120):
    kw = dict(n_users=n_users, n_artists=n_artists, artists_per_user=5,
              friends_per_user=3)
    cat, queries = ref_lastfm_like(**kw)
    spec = [(qt.table, dict(qt.var_map))
            for qt in queries["lastfm_A1"].tables]
    return both(cat, queries["lastfm_A1"], spec)


@pytest.mark.parametrize("case", ["count", "count-by", "sum", "mean",
                                  "min", "distinct", "where-by", "mean-by"])
def test_aggregate_facade_matches_reference(case):
    ref_frame, _, ref, port, gfjs = lastfm_frames()
    ref_gfjs = ref_frame.gfjs
    user = int(ref_frame.group_by("U1")["U1"][0])
    args = {"count": (("count",), {}),
            "count-by": (("count",), dict(by=["U1", "A2"])),
            "sum": (("sum", "U2"), {}),
            "mean": (("mean", "U2"), {}),
            "min": (("min", "A1"), {}),
            "distinct": (("distinct", "A2"), dict(where={"U1": user})),
            "where-by": (("count",), dict(by=["A2"], where={"U1": user})),
            "mean-by": (("mean", "U2"), dict(by=["A1"]))}[case]
    got = port.aggregate(*args[0], gfjs=gfjs, **args[1])
    assert "aggregate" in port.timings
    assert_same(got, ref.aggregate(*args[0], gfjs=ref_gfjs, **args[1]))


def test_device_sort_route_matches_host_route(monkeypatch):
    """The device GROUP BY route (sort + run_boundaries), forced on for
    every run count, equals the host ``group_ranks`` route."""
    _, frame, *_ = lastfm_frames()
    aggs = dict(n="count", lo=("min", "U2"), s=("sum", "A1"),
                avg=("mean", "U2"))
    host = frame.group_by(["U1", "A2"], **aggs)
    calls = []
    real = engine.group_runs_device

    def spy(ranks, *, device):
        calls.append(len(ranks))
        return real(ranks, device=device)

    monkeypatch.setattr(engine, "GROUP_DEVICE_MIN_RUNS", 0)
    monkeypatch.setattr(engine, "group_device_enabled", lambda dev: True)
    monkeypatch.setattr(engine, "group_runs_device", spy)
    dev = frame.group_by(["U1", "A2"], **aggs)
    assert calls
    assert_same(dev, host)


def test_group_runs_device_matches_reference():
    ranks = np.random.default_rng(0).integers(0, 400, 6000)
    got = engine.group_runs_device(ranks, device="cpu")
    want = engine_jax.group_runs_device(ranks)
    assert got[3] == want[3]
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[1].dtype == np.int32
    empty = engine.group_runs_device(np.zeros(0, np.int64), device="cpu")
    assert empty[3] == 0 and all(len(a) == 0 for a in empty[:3])


@pytest.mark.parametrize("kind", ["int", "float"])
def test_segment_weighted_sum_bound_does_not_change_results(kind):
    rng = np.random.default_rng(5)
    seg = np.sort(rng.integers(0, 50, 2000)).astype(np.int32)
    _, seg = np.unique(seg, return_inverse=True)
    v = rng.integers(-100, 100, len(seg)).astype(np.int64)
    if kind == "float":
        v = v * 0.37
    w = rng.integers(0, 100, len(seg)).astype(np.int64)
    ns = int(seg.max()) + 1
    base = engine.segment_weighted_sum(seg, v, w, ns, device="cpu")
    for bound in (float(np.abs(v * w).sum()), float(1 << 40), 1.0):
        np.testing.assert_array_equal(
            engine.segment_weighted_sum(seg, v, w, ns, device="cpu",
                                        bound=bound), base)
    assert_same(base, engine_jax.segment_weighted_sum(seg, v, w, ns))
    assert_same(engine.weighted_total(v, w, device="cpu"),
                engine_jax.weighted_total(v, w))


def test_segment_weighted_sum_is_exact_past_2_24():
    """Counts past the reference kernel's f32 ceiling stay exact."""
    seg = np.zeros(4, np.int32)
    v = np.full(4, (1 << 40) + 3, np.int64)
    w = np.asarray([1, 2, 3, (1 << 20) + 1], np.int64)
    got = engine.segment_weighted_sum(seg, v, w, 1, device="cpu")
    assert int(got[0]) == int(((1 << 40) + 3) * (6 + (1 << 20) + 1))


@pytest.mark.parametrize("op", ["count", "sum", "mean", "min", "distinct",
                                "group_by", "filtered_group_by"])
def test_sharded_frame_matches_reference(op):
    kw = dict(n_users=80, n_artists=60, artists_per_user=4,
              friends_per_user=3)
    cat, queries = ref_lastfm_like(**kw)
    ref = RefGraphicalJoin(cat, queries["lastfm_A1"], partitions=2)
    sharded = ref.run()
    assert len(sharded.shards) == 2
    doms = {v: d.values for v, d in sharded.domains.items()}
    shards = [gfjs_from_arrays([(lvl.vars, lvl.key_cols, lvl.freq)
                                for lvl in s.levels], s.column_order,
                               s.join_size, doms) for s in sharded.shards]
    port = ShardedGFJS(shards, list(sharded.column_order), sharded.join_size,
                       shards[0].domains, sharded.partition_var,
                       sharded.salt)
    pf = SummaryFrame.of(port, device="cpu")
    rf = RefFrame.of(sharded)
    assert isinstance(pf, ShardedSummaryFrame)
    assert pf.device.type == "cpu"
    aggs = dict(n="count", s=("sum", "U2"), avg=("mean", "U2"),
                hi=("max", "U2"))
    if op == "group_by":
        got, want = pf.group_by(["U1"], **aggs), rf.group_by(["U1"], **aggs)
    elif op == "filtered_group_by":
        got = pf.filter(U2=lambda u: u % 3 == 0).group_by("A2", **aggs)
        want = rf.filter(U2=lambda u: u % 3 == 0).group_by("A2", **aggs)
    elif op == "count":
        got, want = pf.count(), rf.count()
    else:
        got, want = getattr(pf, op)("U2"), getattr(rf, op)("U2")
    assert_same(got, want)


def test_frame_without_a_card_raises(monkeypatch):
    import torch
    _, frame, *_ = lastfm_frames(40, 30)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SummaryFrame.of(frame.gfjs)
