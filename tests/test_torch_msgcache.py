"""The port's elimination-message cache against the reference's.

tests/test_msgcache.py's overlapping snowflake suites (and its triangle)
go through ``repro.GraphicalJoin(message_cache=...)`` and through
``repro_torch.GraphicalJoin(message_cache=..., device="cpu")`` in the
same order.  Held exactly after every query: the steps taken from the
cache (``cached_steps``), the cache's counters, the chosen order (the
residency-priced plan search is a copy) and the GFJS, level for level.
Around it: the refusals for traced and bagged builds, eviction and spill
under a small budget, append invalidation, and spill files that either
package reads.
"""

import numpy as np
import pytest

from repro.core.api import GraphicalJoin as RefGraphicalJoin
from repro.plan.ir import step_fingerprints as ref_step_fingerprints
from repro.relational.encoding import encode_query as ref_encode_query
from repro.summary.msgcache import MessageCache as RefMessageCache
from repro.summary.msgcache import _entry_from_bytes as ref_from_bytes
from repro.summary.msgcache import _entry_to_bytes as ref_to_bytes

from repro_torch.core.api import GraphicalJoin
from repro_torch.plan.ir import step_fingerprints
from repro_torch.relational.encoding import encode_query
from repro_torch.summary.msgcache import (MessageCache, _entry_from_bytes,
                                          _entry_to_bytes)

from test_msgcache import (snowflake_catalog, snowflake_query,
                           triangle_catalog, triangle_query)
from torch_cases import assert_gfjs_equal, port_catalog, port_query
import torch_threads  # noqa: F401


def suite(seed):
    ref_cat = snowflake_catalog(seed=seed)
    queries = [snowflake_query(f"q{f}{i}", f"fact{f}", chains)
               for f in range(2)
               for i, chains in enumerate([(0, 1), (1, 2), (0, 2)])]
    return ref_cat, port_catalog(ref_cat), queries


def run_both(ref_cat, cat, ref_q, ref_mc, mc, **kw):
    ref_gj = RefGraphicalJoin(ref_cat, ref_q, message_cache=ref_mc, **kw)
    gj = GraphicalJoin(cat, port_query(ref_q), message_cache=mc,
                       device="cpu", **kw)
    want, got = ref_gj.run(), gj.run()
    assert gj.plan().order == ref_gj.plan().order
    assert gj._executor.cached_steps == ref_gj._executor.cached_steps
    assert_gfjs_equal(got, want)
    return ref_gj, gj


@pytest.mark.parametrize("seed", range(3))
def test_suite_reuses_as_the_reference_does(seed):
    ref_cat, cat, queries = suite(seed)
    ref_mc, mc = RefMessageCache(), MessageCache()
    for _ in range(2):                          # prime, then warm
        for q in queries:
            run_both(ref_cat, cat, q, ref_mc, mc)
            assert mc.stats.as_dict() == ref_mc.stats.as_dict()
    assert mc.stats.hits > 0
    assert mc.resident_keys() == ref_mc.resident_keys()
    assert mc.resident_bytes == ref_mc.resident_bytes
    # warm equals a cache-free cold build
    for q in queries:
        cold = GraphicalJoin(cat, port_query(q), device="cpu").run()
        warm = GraphicalJoin(cat, port_query(q), message_cache=mc,
                             device="cpu").run()
        assert warm.join_size == cold.join_size


def test_fingerprints_equal_the_reference():
    ref_cat, cat, queries = suite(0)
    for q in queries:
        order = RefGraphicalJoin(ref_cat, q).plan().order
        versions = {qt.table: ref_cat[qt.table].version() for qt in q.tables}
        want = ref_step_fingerprints(ref_encode_query(ref_cat, q), order,
                                     q.output_variables, versions)
        pq = port_query(q)
        got = step_fingerprints(encode_query(cat, pq), order,
                                pq.output_variables, versions)
        assert got == want


def test_triangle_pure_gj_and_bag_refusal():
    ref_cat = triangle_catalog()
    cat = port_catalog(ref_cat)
    ref_mc, mc = RefMessageCache(), MessageCache()
    for _ in range(2):
        run_both(ref_cat, cat, triangle_query(), ref_mc, mc, hybrid=False)
    assert mc.stats.as_dict() == ref_mc.stats.as_dict()
    assert mc.stats.hits > 0
    ref_mc, mc = RefMessageCache(), MessageCache()
    for _ in range(2):
        run_both(ref_cat, cat, triangle_query(), ref_mc, mc, hybrid=True)
    assert mc.stats.as_dict() == ref_mc.stats.as_dict()
    assert mc.stats.hits == 0 and mc.stats.puts == 0


def test_record_trace_refuses_reuse():
    ref_cat, cat, queries = suite(1)
    ref_mc, mc = RefMessageCache(), MessageCache()
    for q in queries[:2]:
        run_both(ref_cat, cat, q, ref_mc, mc, record_trace=True)
    assert mc.stats.as_dict() == ref_mc.stats.as_dict()
    assert mc.stats.hits == mc.stats.misses == 0


def test_eviction_spill_and_disk_hits(tmp_path):
    ref_cat, cat, queries = suite(2)
    ref_mc = RefMessageCache(byte_budget=1 << 10,
                             spill_dir=str(tmp_path / "ref"))
    mc = MessageCache(byte_budget=1 << 10, spill_dir=str(tmp_path / "port"))
    for _ in range(2):
        for q in queries[:3]:
            run_both(ref_cat, cat, q, ref_mc, mc)
    assert mc.stats.as_dict() == ref_mc.stats.as_dict()
    assert mc.stats.spills > 0 and mc.stats.disk_hits > 0
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == \
        sorted(p.name for p in (tmp_path / "ref").iterdir())


def test_append_invalidates_as_the_reference_does():
    ref_cat, cat, queries = suite(0)
    ref_mc, mc = RefMessageCache(), MessageCache()
    for q in queries[:3]:
        run_both(ref_cat, cat, q, ref_mc, mc)
    block = {"id": np.arange(200, 205), "sub": np.zeros(5, np.int64)}
    ref_cat.append("dim0", dict(block))
    cat.append("dim0", dict(block))
    assert mc.invalidate("dim0") == ref_mc.invalidate("dim0") > 0
    for q in queries[:3]:
        run_both(ref_cat, cat, q, ref_mc, mc)
    assert mc.stats.as_dict() == ref_mc.stats.as_dict()


def test_spilled_entries_cross_packages():
    ref_cat, cat, queries = suite(0)
    ref_mc, mc = RefMessageCache(), MessageCache()
    run_both(ref_cat, cat, queries[0], ref_mc, mc)
    for key in mc.resident_keys():
        entry, ref_entry = mc.get(key), ref_mc.get(key)
        data = _entry_to_bytes(entry)
        assert ref_to_bytes(ref_entry) == data
        back = ref_from_bytes(data)
        again = _entry_from_bytes(ref_to_bytes(ref_entry))
        for a, b in ((back.message, entry.message),
                     (again.message, ref_entry.message)):
            np.testing.assert_array_equal(a.keys, b.keys)
            np.testing.assert_array_equal(a.fac, b.fac)


def test_service_shares_messages_as_the_reference_does():
    from repro.summary.service import JoinService as RefService
    from repro_torch.summary import JoinService
    ref_cat, cat, queries = suite(1)
    ref = RefService(ref_cat, incremental=False)
    svc = JoinService(cat, incremental=False, device="cpu")
    for q in queries:
        want, got = ref.frame(q), svc.frame(port_query(q))
        assert got.source == want.source == "computed"
        assert got.frame.count() == want.frame.count()
    ref_st, st = ref.stats(), svc.stats()
    assert st["msgcache_hits"] > 0
    assert {k: v for k, v in st.items() if k.startswith("msgcache_")} == \
        {k: v for k, v in ref_st.items() if k.startswith("msgcache_")}
