"""The port's partitioned builds against the reference's, on the CPU.

The same instances (tests/test_plan.py's random acyclic and cyclic
generator, Figure 1, a small Last.fm-like catalog and the skew cases of
tests/test_partition.py) go through ``repro.GraphicalJoin(...,
partitions=k)`` and ``repro_torch.GraphicalJoin(..., partitions=k,
device="cpu")``.  Held exactly: the plan's partition variable, fold,
signature and ``explain()`` lines (once the reference plan carries the
port's ``backends``), every shard's GFJS level for level, the
desummarized columns element for element in shard order, and the
``ShardedSummaryFrame`` aggregates (floats to the ``rtol`` of
tests/test_torch_algebra.py).  The device-side hash and histograms are
held to the numpy ``hash_partition`` and ``np.bincount``: the
reference's mesh versions need a device mesh.
"""

import dataclasses
import os
import re
import tempfile

import numpy as np
import pytest
import torch

from repro.core.api import GraphicalJoin as RefGraphicalJoin
from repro.core.gfjs import desummarize as ref_desummarize
from repro.core.storage import load_gfjs as ref_load_gfjs
from repro.dist import partition as ref_partition
from repro.plan.stats import FactorStats as RefFactorStats
from repro.plan.stats import QueryStats as RefQueryStats
from repro.relational.encoding import encode_query as ref_encode_query
from repro.relational.query import JoinQuery as RefJoinQuery
from repro.relational.synth import figure1 as ref_figure1
from repro.relational.synth import lastfm_like as ref_lastfm_like
from repro.relational.table import Catalog as RefCatalog, Table as RefTable
from repro.summary.algebra import SummaryFrame as RefSummaryFrame

import repro_torch
from repro_torch.core.gfjs import ShardedGFJS, desummarize_range, row_at
from repro_torch.core.storage import gfjs_to_bytes, load_gfjs, save_gfjs
from repro_torch.dist import partition
from repro_torch.plan.stats import FactorStats, QueryStats
from repro_torch.relational.encoding import encode_query
from repro_torch.summary.algebra import ShardedSummaryFrame, SummaryFrame

from test_plan import SHAPES, _random_instance
from test_torch_algebra import assert_same
from torch_cases import assert_gfjs_equal, port_catalog, port_query
import torch_threads  # noqa: F401

LASTFM = dict(n_users=60, n_artists=50, artists_per_user=4,
              friends_per_user=3, seed=0)
SALTS = [0, 1, 0x9E3779B1, (1 << 32) - 1]


def both(cat, query, **kw):
    """The reference's and the port's facade over the same instance."""
    ref = RefGraphicalJoin(cat, query, **kw)
    port = repro_torch.GraphicalJoin(port_catalog(cat), port_query(query),
                                     device="cpu", **kw)
    return ref, port


def ref_plan_as_port(ref, port):
    """The reference's plan with the port's ``backends`` put in."""
    return dataclasses.replace(ref.plan(),
                               backends=dict(port.plan().backends))


def explain_lines(text):
    """``explain()`` without its wall-clock search time."""
    return [re.sub(r"\(search [0-9.]+ms\)", "", line)
            for line in text.splitlines()]


def assert_sharded_equal(ref, g_ref, port, g_port):
    """Plan identity, shards level for level, columns in shard order."""
    assert isinstance(g_port, ShardedGFJS)
    plan, want = port.plan(), ref_plan_as_port(ref, port)
    assert plan.partitions == want.partitions
    assert plan.partition_var == want.partition_var
    assert plan.partition_fold == want.partition_fold
    assert plan.signature() == want.signature()
    assert explain_lines(plan.explain()) == explain_lines(want.explain())
    assert g_port.partition_var == g_ref.partition_var
    assert g_port.shard_sizes() == g_ref.shard_sizes()
    assert g_port.join_size == g_ref.join_size
    assert list(g_port.column_order) == list(g_ref.column_order)
    for a, b in zip(g_port.shards, g_ref.shards):
        assert_gfjs_equal(a, b)
    codes = port.desummarize(g_port, decode=False)
    want_codes = ref_desummarize(g_ref, decode=False)
    values = port.desummarize(g_port)
    want_values = ref_desummarize(g_ref, decode=True)
    assert list(codes) == list(want_codes)
    for v in want_codes:
        assert codes[v].dtype == torch.int32
        np.testing.assert_array_equal(codes[v].numpy(), want_codes[v])
        np.testing.assert_array_equal(values[v], want_values[v])


def assert_same_aggregates(g_ref, g_port, var, key):
    """Every frame aggregate, plus a filtered group_by, as the reference."""
    f0 = RefSummaryFrame.of(g_ref)
    f1 = SummaryFrame.of(g_port, "cpu")
    assert isinstance(f1, ShardedSummaryFrame)
    for op in ("sum", "mean", "min", "max", "distinct", "count_distinct"):
        assert_same(getattr(f1, op)(var), getattr(f0, op)(var))
    assert f1.count() == f0.count()
    aggs = dict(n="count", s=("sum", var), avg=("mean", var),
                lo=("min", var), hi=("max", var))
    assert_same(f1.group_by(key, **aggs), f0.group_by(key, **aggs))
    dom = g_ref.domains[var].values
    if len(dom):
        pred = {var: lambda v: v <= dom[len(dom) // 2]}
        ff0, ff1 = f0.filter(pred), f1.filter(pred)
        assert ff1.count() == ff0.count()
        assert_same(ff1.group_by(key, n="count", s=("sum", var)),
                    ff0.group_by(key, n="count", s=("sum", var)))


# ---------------------------------------------------------------------------
# the hash and the histograms
# ---------------------------------------------------------------------------

def edge_codes():
    """A dense code range plus the edges: 0, 2^31 - 1, Last.fm-2k's
    largest artist code, and codes whose low 32 bits wrap."""
    return np.concatenate([np.arange(10_000), [0, (1 << 31) - 1, 17_631,
                                               (1 << 32) - 1, 1 << 32,
                                               (1 << 40) + 7]]
                          ).astype(np.int64)


@pytest.mark.parametrize("salt", SALTS)
@pytest.mark.parametrize("k", [1, 2, 3, 4, 7])
def test_hash_partition_device_is_bit_identical(k, salt):
    codes = edge_codes()
    want = ref_partition.hash_partition(codes, k, salt=salt)
    np.testing.assert_array_equal(
        partition.hash_partition(codes, k, salt=salt), want)
    got = partition.hash_partition_device(codes, k, salt=salt,
                                          device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # a tensor, and an int32 column of the codes that fit in it
    np.testing.assert_array_equal(partition.hash_partition_device(
        torch.from_numpy(codes), k, salt=salt, device="cpu").numpy(), want)
    fit = codes <= (1 << 31) - 1
    np.testing.assert_array_equal(partition.hash_partition_device(
        torch.from_numpy(codes[fit].astype(np.int32)), k, salt=salt,
        device="cpu").numpy(), want[fit])


@pytest.mark.parametrize("k", [1, 2, 3, 4, 7])
def test_partition_histogram_equals_bincount(k):
    codes = edge_codes()
    for salt in SALTS:
        got = partition.partition_histogram(codes, k, salt=salt,
                                            device="cpu")
        want = np.bincount(ref_partition.hash_partition(codes, k, salt=salt),
                           minlength=k)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


def test_sharded_potential_counts_equals_bincount():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 50, 5_000)
    got = partition.sharded_potential_counts(codes, 64, device="cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  np.bincount(codes, minlength=64))
    # codes past num_codes drop out, as the reference's dead padding slot
    got = partition.sharded_potential_counts(codes, 10, device="cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  np.bincount(codes, minlength=64)[:10])
    empty = partition.sharded_potential_counts(np.zeros(0, np.int64), 3,
                                               device="cpu")
    np.testing.assert_array_equal(empty.numpy(), [0, 0, 0])
    with pytest.raises(ValueError):
        partition.hash_partition_device(codes, 0, device="cpu")


# ---------------------------------------------------------------------------
# the copied planners and partition_encoded
# ---------------------------------------------------------------------------

def stats_pair(deg_by_var):
    """The same degree statistics in both packages."""
    ref = RefQueryStats(
        sizes={v: len(d) for v, d in deg_by_var.items()}, factors=[],
        factor_stats=[RefFactorStats((v,), float(d.sum()),
                                     {v: float(len(d))}, {v: d.copy()})
                      for v, d in deg_by_var.items()])
    port = QueryStats(
        sizes={v: len(d) for v, d in deg_by_var.items()}, factors=[],
        factor_stats=[FactorStats((v,), float(d.sum()),
                                  {v: float(len(d))}, {v: d.copy()})
                      for v, d in deg_by_var.items()])
    return ref, port


@dataclasses.dataclass
class _Step:
    var: str
    product_entries: float


@pytest.mark.parametrize("k", [1, 2, 4, 7])
def test_copied_planners_match_reference(k):
    rng = np.random.default_rng(k)
    zipf = (1.0 / np.arange(1, 2049) ** 1.1) * 1e4
    rng.shuffle(zipf)
    hot = np.zeros(16)
    hot[0] = 1000.0
    degs = {"Z": zipf, "H": hot, "F": np.full(16, 10.0)}
    ref_stats, stats = stats_pair(degs)
    steps = [_Step("H", 1000.0), _Step("F", 900.0), _Step("Z", 800.0)]
    order = ("H", "F", "Z")
    for st, rst in ((None, None), (stats, ref_stats)):
        assert partition.choose_partition_var(steps, order, st, k) == \
            ref_partition.choose_partition_var(steps, order, rst, k)
    for var in ("Z", "H", "F", "W"):
        assert partition.choose_partition_fold(stats, var, k) == \
            ref_partition.choose_partition_fold(ref_stats, var, k)
    sizes = rng.integers(0, 100, 3 * k + 1)
    np.testing.assert_array_equal(partition.fold_loads(sizes, k),
                                  ref_partition.fold_loads(sizes, k))
    assert partition.choose_partition_var((), ("A", "B")) == "B"
    with pytest.raises(ValueError):
        partition.choose_partition_var((), ())


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("k", [2, 3])
def test_partition_encoded_matches_reference(shape, k):
    cat, query = _random_instance(shape, 4)
    ref_enc = ref_encode_query(cat, query)
    enc = encode_query(port_catalog(cat), port_query(query))
    var = sorted(query.variables)[0]
    ref_scheme = ref_partition.PartitionScheme(var, k, salt=3)
    scheme = partition.PartitionScheme(var, k, salt=3)
    np.testing.assert_array_equal(partition.partition_counts(enc, scheme),
                                  ref_partition.partition_counts(ref_enc,
                                                                 ref_scheme))
    got = partition.partition_encoded(enc, scheme)
    want = ref_partition.partition_encoded(ref_enc, ref_scheme)
    assert len(got) == len(want) == k
    for enc_s, ref_s in zip(got, want):
        for occ, occ_s, ref_occ in zip(enc.encoded_tables,
                                       enc_s.encoded_tables,
                                       ref_s.encoded_tables):
            assert sorted(occ_s) == sorted(ref_occ)
            for v in ref_occ:
                np.testing.assert_array_equal(occ_s[v], ref_occ[v])
            if var not in occ:
                assert occ_s is occ         # replicated by reference
    with pytest.raises(ValueError):
        partition.partition_encoded(enc, partition.PartitionScheme("nope", 2))


# ---------------------------------------------------------------------------
# partitioned builds against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("seed", [0, 2])
@pytest.mark.parametrize("partitions", [2, 3, 4])
@pytest.mark.parametrize("fold", [1, 2])
def test_partitioned_build_matches_reference(shape, seed, partitions, fold):
    cat, query = _random_instance(shape, seed)
    ref, port = both(cat, query, partitions=partitions, partition_fold=fold)
    g_ref, g_port = ref.run(), port.run()
    assert g_port.num_partitions == partitions * fold
    assert_sharded_equal(ref, g_ref, port, g_port)
    assert port.join_size() == ref.join_size()
    var, key = sorted(query.variables)[0], sorted(query.variables)[-1]
    assert_same_aggregates(g_ref, g_port, var, key)
    rep, want = port._executor.shard_report, ref._executor.shard_report
    assert rep["sizes"] == want["sizes"]
    assert (rep["workers"], rep["executor"]) == (want["workers"],
                                                 want["executor"])
    assert port._executor.step_actuals == ref._executor.step_actuals


@pytest.mark.parametrize("query", ["lastfm_A1", "lastfm_A2", "lastfm_tri"])
@pytest.mark.parametrize("partitions", [2, 4])
def test_partitioned_lastfm_matches_reference(query, partitions):
    ref_cat, ref_qs = ref_lastfm_like(**LASTFM)
    ref, port = both(ref_cat, ref_qs[query], partitions=partitions)
    g_ref, g_port = ref.run(), port.run()
    assert_sharded_equal(ref, g_ref, port, g_port)
    assert_same(port.aggregate("count", by=["U1"], gfjs=g_port),
                ref.aggregate("count", by=["U1"], gfjs=g_ref))


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("pvar", [None, "B", "C"])
def test_partitioned_projected_query_matches_reference(seed, pvar):
    """Early projection: the partition variable may be projected out."""
    cat, query = _random_instance("chain3", seed, output=["A", "D"])
    ref, port = both(cat, query, partitions=3, partition_var=pvar)
    g_ref, g_port = ref.run(), port.run()
    if pvar is not None:
        assert port.plan().partition_var == pvar
    assert_sharded_equal(ref, g_ref, port, g_port)


# ---------------------------------------------------------------------------
# skew and empty shards
# ---------------------------------------------------------------------------

def single_key_catalog():
    """Every row joins through one key value: all rows hash to ONE shard."""
    n = 40
    rng = np.random.default_rng(0)
    cat = RefCatalog.of(
        RefTable("l", {"k": np.zeros(n, np.int64),
                       "a": rng.integers(0, 5, n).astype(np.int64)}),
        RefTable("r", {"k": np.zeros(n, np.int64),
                       "b": rng.integers(0, 5, n).astype(np.int64)}))
    q = RefJoinQuery.of("sk", [("l", {"k": "K", "a": "A"}),
                               ("r", {"k": "K", "b": "B"})])
    return cat, q


def test_all_rows_in_one_shard():
    cat, q = single_key_catalog()
    ref, port = both(cat, q, partitions=4, partition_var="K")
    g_ref, g = ref.run(), port.run()
    assert sorted(g.shard_sizes())[:-1] == [0, 0, 0]
    assert_sharded_equal(ref, g_ref, port, g)
    assert_same_aggregates(g_ref, g, "A", "B")
    f = SummaryFrame.of(g, "cpu")
    empty = f.filter(A=lambda v: v < 0)          # kills every shard
    assert empty.count() == 0
    assert empty.min("A") is None and empty.max("A") is None
    assert len(empty.distinct("A")) == 0
    tab = empty.group_by("B", n="count", s=("sum", "A"), avg=("mean", "A"))
    assert all(len(np.asarray(v)) == 0 for v in tab.values())


def test_more_partitions_than_distinct_keys():
    cat, query = _random_instance("chain3", 1)   # domains are 2..5 values
    ref, port = both(cat, query, partitions=8)
    g_ref, g = ref.run(), port.run()
    pvar = port.plan().partition_var
    assert sum(1 for s in g.shard_sizes() if s == 0) >= \
        8 - g.domains[pvar].size
    assert_sharded_equal(ref, g_ref, port, g)


def test_empty_join():
    cat = RefCatalog.of(
        RefTable("l", {"k": np.zeros(0, np.int64),
                       "a": np.zeros(0, np.int64)}),
        RefTable("r", {"k": np.zeros(0, np.int64),
                       "b": np.zeros(0, np.int64)}))
    q = RefJoinQuery.of("e", [("l", {"k": "K", "a": "A"}),
                              ("r", {"k": "K", "b": "B"})])
    ref, port = both(cat, q, partitions=3)
    g_ref, g = ref.run(), port.run()
    assert g.join_size == 0 and g.shard_sizes() == [0, 0, 0]
    assert SummaryFrame.of(g, "cpu").count() == 0
    assert_sharded_equal(ref, g_ref, port, g)
    assert all(len(c) == 0 for c in port.desummarize(g).values())


# ---------------------------------------------------------------------------
# row access, parallel desummarize, storage, plan identity
# ---------------------------------------------------------------------------

def test_sharded_range_and_row_access_match_device_columns():
    cat, query = _random_instance("chain3", 6)
    ref, port = both(cat, query, partitions=3)
    g = port.run()
    full = port.desummarize(g, decode=False)
    n = g.join_size
    assert n > 0
    for lo, hi in [(0, n), (0, min(5, n)), (n // 3, 2 * n // 3), (n - 1, n),
                   (2, 2), (n, n + 9)]:
        part = desummarize_range(g, lo, hi, decode=False)
        for v in g.column_order:
            np.testing.assert_array_equal(part[v],
                                          full[v][lo:min(hi, n)].numpy())
    for t in {0, n // 2, n - 1}:
        row = row_at(g, t, decode=False)
        assert all(row[v] == int(full[v][t]) for v in g.column_order)


def test_parallel_desummarize_matches_reference():
    ref_cat, ref_qs = ref_lastfm_like(**LASTFM)
    ref, port = both(ref_cat, ref_qs["lastfm_A1"], partitions=3)
    g_ref, g = ref.run(), port.run()
    mono_ref, mono = both(ref_cat, ref_qs["lastfm_A1"])
    g0_ref, g0 = mono_ref.run(), mono.run()
    for got, want in ((partition.parallel_desummarize(g, 3),
                       ref_partition.parallel_desummarize(g_ref, 3)),
                      (partition.parallel_desummarize(g0, 5),
                       ref_partition.parallel_desummarize(g0_ref, 5))):
        assert list(got) == list(want)
        for v in want:
            np.testing.assert_array_equal(got[v], want[v])


def test_sharded_storage_is_the_reference_format():
    cat, query = _random_instance("cycle4", 0)
    ref, port = both(cat, query, partitions=3)
    g_ref, g = ref.run(), port.run()
    from repro.core.storage import gfjs_to_bytes as ref_gfjs_to_bytes
    assert gfjs_to_bytes(g) == ref_gfjs_to_bytes(g_ref)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "s.gfjs")
        assert port.store(g, path) > 0
        back, ref_back = load_gfjs(path), ref_load_gfjs(path)
        save_gfjs(g, os.path.join(tmp, "t.gfjs"))
    assert isinstance(back, ShardedGFJS)
    assert back.shard_sizes() == ref_back.shard_sizes() == g.shard_sizes()
    for a, b in zip(back.shards, ref_back.shards):
        assert_gfjs_equal(a, b)
    got = port.desummarize(back, decode=False)
    want = ref_desummarize(g_ref, decode=False)
    for v in want:
        np.testing.assert_array_equal(got[v].numpy(), want[v])


def test_plan_knobs_refuse_as_the_reference():
    cat, q = ref_figure1()
    pcat, pq = port_catalog(cat), port_query(q)

    def port_gj(**kw):
        return repro_torch.GraphicalJoin(pcat, pq, device="cpu", **kw)

    plans = [port_gj(partitions=k).plan() for k in (1, 2, 4)]
    assert plans[0].partitions == 1 and plans[0].partition_var is None
    assert len({p.signature() for p in plans}) == 3
    for kw in (dict(partitions=0), dict(partitions=2, partition_var="Z"),
               dict(partition_var="B"), dict(shard_executor="process"),
               dict(partitions=2, shard_executor="gpu"),
               dict(partition_fold=2), dict(partitions=2, partition_fold=0),
               dict(partitions=2, hybrid=True)):
        with pytest.raises(ValueError):
            RefGraphicalJoin(cat, q, **kw).plan()
        with pytest.raises(ValueError):
            port_gj(**kw).plan()
    with pytest.raises(ValueError):
        port_gj(partitions=2, record_trace=True)
    with pytest.raises(ValueError):
        port_gj(plan=plans[1], record_trace=True)


def test_partitioned_summary_is_memoized_and_explained():
    cat, q = ref_figure1()
    ref, port = both(cat, q, partitions=3)
    g1 = port.run()
    assert port.run() is g1                   # memoized, not rebuilt
    assert port.join_size() == g1.join_size
    assert port.aggregate("count", gfjs=g1) == g1.join_size
    ref.run()
    text, want = port.explain(analyze=True), ref.explain(analyze=True)
    pvar = port.plan().partition_var
    assert f"partitions        : 3 by hash({pvar})" in text
    assert "  shards:" in text and "  shards:" in want
    assert "(max; sum" in text
    assert "executor: thread workers=3" in text
    port.build_model()                        # re-entry clears the memo
    g2 = port.run()
    assert g2 is not g1 and g2.join_size == g1.join_size


def test_precompiled_partitioned_plan_builds_no_monolithic_factors():
    ref_cat, ref_qs = ref_lastfm_like(**LASTFM)
    cat, q = port_catalog(ref_cat), port_query(ref_qs["lastfm_A2"])
    plan = repro_torch.GraphicalJoin(cat, q, partitions=2,
                                     device="cpu").plan()
    gj = repro_torch.GraphicalJoin(cat, q, plan=plan, device="cpu")
    g = gj.run()
    assert gj._executor.logical.stats.factors == []
    ref = RefGraphicalJoin(ref_cat, ref_qs["lastfm_A2"], partitions=2)
    for a, b in zip(g.shards, ref.run().shards):
        assert_gfjs_equal(a, b)


def test_numpy_generation_backend_shards_equal_torch():
    ref_cat, ref_qs = ref_lastfm_like(**LASTFM)
    cat, q = port_catalog(ref_cat), port_query(ref_qs["lastfm_A1"])
    dev = repro_torch.GraphicalJoin(cat, q, partitions=4, device="cpu").run()
    host = repro_torch.GraphicalJoin(cat, q, partitions=4, device="cpu",
                                     generation_backend="numpy").run()
    assert dev.shard_sizes() == host.shard_sizes()
    for a, b in zip(dev.shards, host.shards):
        assert_gfjs_equal(a, b)
        assert a._launch and not b._launch     # only the torch memo
    assert dev.aux_nbytes() == sum(s.aux_nbytes() for s in dev.shards) > 0


def _past_int32_shards():
    """Two reference shards and the port's twins: shard 0 of 7 rows,
    shard 1 with a level whose codes pass int32."""
    from repro.core.gfjs import (GFJS as RefGFJS, LevelSummary as RefLevel,
                                 ShardedGFJS as RefShardedGFJS)
    from repro_torch.interop import gfjs_from_arrays
    big = (1 << 31) + np.asarray([3, 7], np.int64)
    ref_shards = [
        RefGFJS([RefLevel(("A",), {"A": np.asarray([1, 0])},
                          np.asarray([3, 4], np.int64)),
                 RefLevel(("B",), {"B": np.arange(7)},
                          np.ones(7, np.int64))], ["A", "B"], 7, {}),
        RefGFJS([RefLevel(("A",), {"A": big}, np.asarray([2, 1], np.int64)),
                 RefLevel(("B",), {"B": np.asarray([1, 0, 2])},
                          np.ones(3, np.int64))], ["A", "B"], 3, {})]
    ref = RefShardedGFJS(ref_shards, ["A", "B"], 10, {}, "A")
    shards = [gfjs_from_arrays([(lvl.vars, lvl.key_cols, lvl.freq)
                                for lvl in s.levels], s.column_order,
                               s.join_size, {}) for s in ref_shards]
    return ref, ShardedGFJS(shards, ["A", "B"], 10, {}, "A")


def test_sharded_desummarize_codes_past_int32_match_reference():
    """On the CPU device a level whose codes pass int32 expands on numpy
    through ``engine.desummarize``'s one level loop, is counted, and the
    columns equal the reference's; the column that receives those codes
    becomes int64."""
    from repro_torch.core import engine
    from repro_torch.obs.metrics import REGISTRY
    fallbacks = REGISTRY.counter("engine.numpy_fallbacks")
    ref, port = _past_int32_shards()
    want = ref_desummarize(ref, decode=False)
    before = fallbacks.value
    got = engine.desummarize_sharded(port, device="cpu")
    assert fallbacks.value == before + 1          # shard 1's level 0
    assert got["A"].dtype == torch.int64 and got["B"].dtype == torch.int32
    for v in want:
        np.testing.assert_array_equal(got[v].numpy(), want[v])


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_sharded_desummarize_shard_past_int32_raises(monkeypatch, device):
    """A shard past the int32 kernel range (here: a lowered limit) raises
    before any column is allocated or any device is asked for, as a join
    past it does in ``engine.desummarize``: nothing leaves for numpy and
    nothing is counted."""
    from repro_torch.core import engine
    from repro_torch.obs.metrics import REGISTRY
    fallbacks = REGISTRY.counter("engine.numpy_fallbacks")
    _, port = _past_int32_shards()
    monkeypatch.setattr(engine, "I32_MAX", 5)     # shard 0 is past it
    before = fallbacks.value
    with pytest.raises(ValueError, match="int32"):
        engine.desummarize_sharded(port, device=device)
    with pytest.raises(ValueError, match="int32"):
        engine.desummarize(port.shards[0], device=device)
    assert fallbacks.value == before