"""``repro_torch.GraphicalJoin`` end to end against ``repro``'s, on the CPU.

Figure 1 and a small Last.fm-like catalog (the chain queries A1 and A2 and
the cyclic query) run through both facades: the same plan order, the same
join size, the same GFJS level for level and the same decoded columns.
The port's synthetic generators are copies, so they must also make the
reference's data from the same seed.
"""

import numpy as np
import pytest
import torch

from repro.core.api import GraphicalJoin as RefGraphicalJoin
from repro.core.gfjs import desummarize as ref_desummarize
from repro.relational import synth as ref_synth

import repro_torch
from repro_torch.core import engine
from repro_torch.interop import gfjs_from_arrays
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import Tracer
from repro_torch.relational import synth

from test_torch_engine import assert_gfjs_equal

LASTFM = dict(n_users=60, n_artists=80, artists_per_user=4,
              friends_per_user=3, seed=0)


def _same_catalog(a, b):
    assert sorted(a.tables) == sorted(b.tables)
    for name in a.tables:
        ta, tb = a[name], b[name]
        assert ta.column_names == tb.column_names
        for c in ta.column_names:
            np.testing.assert_array_equal(ta[c], tb[c])


def _instances():
    yield "figure1", ref_synth.figure1(), synth.figure1()
    ref_cat, ref_qs = ref_synth.lastfm_like(**LASTFM)
    cat, qs = synth.lastfm_like(**LASTFM)
    for q in ("lastfm_A1", "lastfm_A2", "lastfm_cyc"):
        yield q, (ref_cat, ref_qs[q]), (cat, qs[q])


INSTANCES = {name: (ref, port) for name, ref, port in _instances()}


@pytest.mark.parametrize("name", sorted(INSTANCES))
def test_pipeline_matches_reference(name):
    (ref_cat, ref_q), (cat, q) = INSTANCES[name]
    _same_catalog(ref_cat, cat)
    ref = RefGraphicalJoin(ref_cat, ref_q)
    ref_gfjs = ref.run()
    gj = repro_torch.GraphicalJoin(cat, q, device="cpu")
    tracer = Tracer()
    launches = REGISTRY.counter("kernels.launches").value
    with tracer.span("query"):
        gfjs = gj.run()
        cols = gj.desummarize(gfjs)
    assert gj.plan().order == ref.plan().order
    assert gj.plan().backends == {"summarize": "torch",
                                  "desummarize": "torch"}
    assert gj.join_size() == ref.join_size() == gfjs.join_size
    assert_gfjs_equal(gfjs, ref_gfjs)
    want = ref.desummarize(ref_gfjs)
    assert list(cols) == list(want)
    for v in want:
        np.testing.assert_array_equal(cols[v], want[v])
    # one expansion per psi while generating, one per level desummarizing
    # but an identity level (one run per row, every run of length 1),
    # whose columns are a copy of its codes
    n_psis = sum(len(level) for level in gj.generator.levels)
    identity = sum(lvl.num_runs == gfjs.join_size and bool(np.all(
        lvl.freq == 1)) for lvl in gfjs.levels)
    assert identity == sum(e[1][0] is None for e in gfjs._launch.values())
    assert REGISTRY.counter("kernels.launches").value == \
        launches + n_psis + len(gfjs.levels) - identity
    names = {s.name for s in tracer.spans}
    assert {"phase:summarize", "phase:desummarize",
            "kernel:rle_expand_many"} <= names


def test_codes_stay_on_device_without_decode():
    (_, _), (cat, q) = INSTANCES["lastfm_A1"]
    gj = repro_torch.GraphicalJoin(cat, q, device="cpu")
    gfjs = gj.run()
    codes = gj.desummarize(gfjs, decode=False)
    values = gj.desummarize(gfjs)
    for v, col in codes.items():
        assert col.device == gj.device and col.dtype == torch.int32
        np.testing.assert_array_equal(gfjs.domains[v].decode(col.numpy()),
                                      values[v])
    lo, hi = 100, 357
    window = gj.desummarize_range(gfjs, lo, hi, decode=False)
    for v in codes:
        np.testing.assert_array_equal(codes[v][lo:hi].numpy(), window[v])


def test_numpy_generation_backend_matches_torch():
    (_, _), (cat, q) = INSTANCES["lastfm_cyc"]
    dev = repro_torch.GraphicalJoin(cat, q, device="cpu")
    host = repro_torch.GraphicalJoin(cat, q, device="cpu",
                                     generation_backend="numpy")
    assert_gfjs_equal(dev.run(), host.run())
    assert "summarize=numpy" in host.explain()
    assert host.plan().signature() != dev.plan().signature()


def test_gfjs_from_arrays_round_trips_reference_summary():
    (ref_cat, ref_q), _ = INSTANCES["lastfm_A2"]
    ref_gfjs = RefGraphicalJoin(ref_cat, ref_q).run()
    gfjs = gfjs_from_arrays(
        [(lvl.vars, lvl.key_cols, lvl.freq) for lvl in ref_gfjs.levels],
        ref_gfjs.column_order, ref_gfjs.join_size,
        {v: d.values for v, d in ref_gfjs.domains.items()})
    assert_gfjs_equal(gfjs, ref_gfjs)
    got = engine.desummarize(gfjs, decode=True, device="cpu")
    want = ref_desummarize(ref_gfjs, decode=True)
    for v in want:
        np.testing.assert_array_equal(got[v], want[v])


@pytest.mark.parametrize("knob", ["partitions", "message_cache"])
def test_unported_knobs_refuse(knob):
    """``partitions > 1`` still refuses, naming ROADMAP's queue; the
    message cache, which refused the same way until the serving slice, is
    ported and now runs (its parity tests: tests/test_torch_msgcache.py)."""
    from repro_torch.summary.msgcache import MessageCache
    (_, _), (cat, q) = INSTANCES["figure1"]
    if knob == "partitions":
        gj = repro_torch.GraphicalJoin(cat, q, device="cpu", partitions=2)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            gj.run()
        return
    mc = MessageCache()
    cold = repro_torch.GraphicalJoin(cat, q, device="cpu").run()
    for _ in range(2):
        warm = repro_torch.GraphicalJoin(cat, q, device="cpu",
                                         message_cache=mc).run()
        assert_gfjs_equal(warm, cold)
    assert mc.stats.hits > 0
