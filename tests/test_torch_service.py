"""The port's JoinService and SummaryCache against the reference's.

One scripted request sequence (cold, warm, ``compile`` then
``frame(plan=...)``, eviction then ``"disk"``, append then
``"refreshed"``, ``invalidate``) runs through ``repro.summary.JoinService``
and through ``repro_torch.summary.JoinService(device="cpu")`` on the same
Last.fm-like catalog (tests/test_summary_service.py's size).  Held
exactly: the ``source`` sequence, the ``stats()`` counters, and the
aggregates (floats to the ``rtol`` of tests/test_torch_algebra.py).

Cache keys: the port's plans pin ``backends`` = torch where the
reference's pin numpy (the engine each package runs), and a key folds in
the plan's signature.  So each port key is held equal, character for
character, to the reference's key of the reference's plan with the
port's ``backends`` put in: the planners agree on everything else.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.relational.synth import lastfm_like as ref_lastfm_like
from repro.summary.cache import cache_key_for_versions as ref_key_for
from repro.summary.service import JoinService as RefService

import repro_torch.summary as port_summary
from repro_torch.relational.synth import lastfm_like
from repro_torch.summary import JoinService, SummaryCache
from repro_torch.summary.cache import cache_key_for_versions

from test_torch_algebra import assert_same
from torch_cases import assert_gfjs_equal

LASTFM = dict(n_users=60, n_artists=50, artists_per_user=4,
              friends_per_user=3)
APPEND = {"userID": np.asarray([0, 3, 61, 7], np.int64),
          "friendID": np.asarray([5, 62, 2, 1], np.int64)}


def under_port_backends(ref_query, ref_reply, port_reply, versions):
    """The reference's cache key of its own plan with the port's backends."""
    plan = dataclasses.replace(ref_reply.plan,
                               backends=dict(port_reply.plan.backends))
    return ref_key_for(ref_query, versions, plan=plan)


def script(svc, qs):
    """The scripted request sequence: (reply, table versions) in order."""
    a1, b = qs["lastfm_A1"], qs["lastfm_B"]
    out = []

    def ask(q, plan=None):
        out.append((svc.frame(q, plan=plan), versions_of(svc.catalog, q)))

    ask(a1)                                            # cold
    ask(a1)                                            # warm
    plan = svc.compile(b)
    ask(b, plan)                                       # evicts A1 to disk
    ask(a1)                                            # disk, evicts B
    svc.append("user_friends", APPEND)
    ask(a1)                                            # refreshed
    ask(b, plan)                                       # refreshed
    svc.invalidate("user_artists")
    ask(a1)                                            # computed again
    return out


def aggregates(svc, q):
    small = {"U2": lambda u: u < 10}
    return [svc.count(q), svc.count(q, where=small),
            svc.sum(q, "A2"), svc.sum(q, "A2", where=small),
            svc.mean(q, "A2"), svc.mean(q, "A2", where=small),
            svc.min(q, "U1"), svc.max(q, "U1"), svc.min(q, "A1", where=small),
            svc.max(q, "A1", where=small), svc.distinct(q, "A1"),
            svc.group_by(q, "U1", total=("sum", "A2"), n="count"),
            svc.group_by(q, ["U1", "U2"], where=small, m=("mean", "A1"),
                         hi=("max", "A2"))]


def versions_of(cat, query):
    return {qt.table: cat[qt.table].version() for qt in query.tables}


@pytest.mark.parametrize("incremental", [True, False])
def test_scripted_sequence_matches_reference(tmp_path, incremental):
    ref_cat, ref_qs = ref_lastfm_like(**LASTFM)
    cat, qs = lastfm_like(**LASTFM)
    kw = dict(byte_budget=1024, incremental=incremental)
    ref = RefService(ref_cat, spill_dir=str(tmp_path / "ref"), **kw)
    port = JoinService(cat, spill_dir=str(tmp_path / "port"), device="cpu",
                       **kw)
    want, got = script(ref, ref_qs), script(port, qs)
    # untraced builds generate on the port's engine, whose device memo the
    # cache charges on top of the host levels (measured before any
    # aggregate grows the host prefix sums)
    memo = sum(int(t.nbytes) for g in port.cache._entries.values()
               for _, meta in g._launch.values()
               for t in meta if t is not None)
    assert (memo > 0) == (not incremental)
    assert port.stats()["resident_bytes"] == \
        ref.stats()["resident_bytes"] + memo
    sources = [r.source for r, _ in got]
    assert sources == [r.source for r, _ in want]
    if incremental:
        assert sources == ["computed", "memory", "computed", "disk",
                           "refreshed", "refreshed", "computed"]
    else:
        # no retained state: an append is a cold build under the
        # carried-forward plan
        assert sources == ["computed", "memory", "computed", "disk",
                           "computed", "computed", "computed"]
    for (w, versions), (g, port_versions) in zip(want, got):
        assert port_versions == versions
        name = g.plan.query_name
        assert g.key == under_port_backends(ref_qs[name], w, g, versions)
        assert g.key == cache_key_for_versions(qs[name], versions,
                                               plan=g.plan)
        assert g.plan.order == w.plan.order
        assert_gfjs_equal(g.frame.gfjs, w.frame.gfjs)
        assert g.frame.device == torch.device("cpu")
    for w, g in zip(aggregates(ref, ref_qs["lastfm_A1"]),
                    aggregates(port, qs["lastfm_A1"])):
        assert_same(g, w)
    ref_st, port_st = ref.stats(), port.stats()
    if not incremental:
        port_st.pop("resident_bytes")
        ref_st.pop("resident_bytes")
    assert port_st == ref_st


def test_canonical_fingerprints_share_entries_as_in_reference():
    from repro_torch.relational.query import JoinQuery
    cat, qs = lastfm_like(**LASTFM)
    q = qs["lastfm_A1"]
    svc = JoinService(cat, device="cpu")
    svc.frame(q)
    permuted = JoinQuery(name="renamed", tables=tuple(reversed(q.tables)),
                         output=None)
    assert svc.frame(permuted).source == "memory"
    projected = JoinQuery(q.name, q.tables, output=("A1", "A2"))
    assert svc.frame(projected).source == "computed"


def test_cache_hit_carries_no_build_timings():
    cat, qs = lastfm_like(**LASTFM)
    svc = JoinService(cat, device="cpu")
    first = svc.frame(qs["lastfm_A1"])
    assert {"build_model", "build_generator", "summarize",
            "service"} <= set(first.timings)
    second = svc.frame(qs["lastfm_A1"])
    assert second.cache_hit and "build_model" not in second.timings
    assert "service" in second.timings


def test_memo_is_charged_and_dropped_with_the_entry(tmp_path):
    """An untraced build's memo counts in ``resident_nbytes`` (so in the
    budget); eviction, ``invalidate`` and ``clear`` drop the cache's last
    reference to it."""
    import gc
    import weakref
    cat, qs = lastfm_like(**LASTFM)
    svc = JoinService(cat, incremental=False, byte_budget=1024,
                      spill_dir=str(tmp_path), device="cpu")
    reply = svc.frame(qs["lastfm_A1"])
    gfjs = reply.frame.gfjs
    assert gfjs._launch and gfjs.aux_nbytes() > 0
    assert svc.cache.resident_bytes == gfjs.resident_nbytes() == \
        gfjs.nbytes() + gfjs.aux_nbytes()
    gone = weakref.ref(gfjs)
    del reply, gfjs
    svc.frame(qs["lastfm_B"])                  # evicts A1 to disk
    gc.collect()
    assert gone() is None
    back = svc.frame(qs["lastfm_A1"])
    assert back.source == "disk" and not back.frame.gfjs._launch
    for drop in (lambda: svc.invalidate("user_friends"),
                 lambda: svc.cache.clear()):
        reply = svc.frame(qs["lastfm_B"])
        gone = weakref.ref(reply.frame.gfjs)
        del reply
        drop()
        gc.collect()
        assert gone() is None


def test_summary_package_exports_the_reference_names():
    for name in ("SummaryCache", "CacheStats", "JoinService", "ServiceReply",
                 "DeltaError", "IncrementalState", "MessageCache",
                 "SummaryFrame", "ShardedSummaryFrame"):
        assert hasattr(port_summary, name), name
    assert SummaryCache is port_summary.SummaryCache


def test_partitioned_service_refuses_by_name(tmp_path):
    """Partitioned services, which refused until the partitioned slice,
    now behave as the reference's: sharded replies, memory and disk hits
    under a one-byte budget, and an append that rebuilds (never
    ``"refreshed"``), with the same counts and keys.  The name is the one
    the test had while it asserted the refusal."""
    from repro_torch.core.gfjs import ShardedGFJS
    ref_cat, ref_qs = ref_lastfm_like(**LASTFM)
    cat, qs = lastfm_like(**LASTFM)
    q1, q2 = "lastfm_A1", "lastfm_tri"
    for d in ("ref", "port"):
        (tmp_path / d).mkdir()
    ref = RefService(ref_cat, partitions=3, spill_dir=str(tmp_path / "ref"),
                     byte_budget=1)
    svc = JoinService(cat, partitions=3, spill_dir=str(tmp_path / "port"),
                      byte_budget=1, device="cpu")
    seen = []
    for q in (q1, q1, q2, q1):
        r, p = ref.frame(ref_qs[q]), svc.frame(qs[q])
        assert isinstance(p.frame.gfjs, ShardedGFJS)
        for a, b in zip(p.frame.gfjs.shards, r.frame.gfjs.shards):
            assert_gfjs_equal(a, b)
        assert p.key == under_port_backends(ref_qs[q], r, p,
                                            versions_of(cat, qs[q]))
        seen.append((p.source, r.source, p.frame.count(), r.frame.count()))
    assert [s[:2] for s in seen] == [("computed",) * 2, ("memory",) * 2,
                                     ("computed",) * 2, ("disk",) * 2]
    assert all(a == b for _, _, a, b in seen)
    table = "user_friends"
    rows = {c: cat[table][c][:5] for c in cat[table].column_names}
    ref.append(table, rows)
    svc.append(table, rows)
    r, p = ref.frame(ref_qs[q1]), svc.frame(qs[q1])
    assert p.source == r.source == "computed"      # rebuilt
    assert svc.stats()["refreshed_requests"] == 0
    assert p.frame.count() == r.frame.count()
    assert_same(p.frame.group_by("U1", n="count"),
                r.frame.group_by("U1", n="count"))


def test_threads_hammering_one_service_agree():
    """More threads than cores on one service, with a short switch
    interval: every answer equals a lone service's, and no counter update
    is lost (each request is one cache hit or one miss)."""
    import os
    import sys
    import threading
    from repro_torch.relational.table import Catalog
    cat, qs = lastfm_like(**LASTFM)
    q = qs["lastfm_A1"]
    want = JoinService(Catalog(dict(cat.tables)), device="cpu").count(q)
    svc = JoinService(cat, incremental=False, device="cpu")
    n, rounds = 2 * (os.cpu_count() or 4), 4
    counts, errors = [], []

    def work():
        try:
            for _ in range(rounds):
                counts.append(svc.count(q))
                counts.append(int(svc.group_by(q, "U1", n="count")["n"]
                                  .sum()))
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work) for _ in range(n)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in ts)
    assert not errors, errors
    assert counts == [want] * (2 * n * rounds)
    st = svc.stats()
    assert st["requests"] == 2 * n * rounds
    assert st["hits"] + st["misses"] == st["requests"]
