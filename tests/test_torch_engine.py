"""The port's torch engine against the reference's, level for level.

The same instance (tests/test_plan.py's random acyclic and cyclic
generator) goes through both packages under one elimination order.  The
port's ``generate_gfjs(device="cpu")`` must equal ``generate_gfjs_jax``
(interpret mode) and the numpy ``generate_gfjs`` in vars, codes and freq,
and the port's ``desummarize`` must equal ``desummarize_jax`` column for
column, from the device memo that generation leaves and from a memo-free
copy of the same GFJS.  Exact throughout: GJ is integer arithmetic.
"""

import numpy as np
import pytest
import torch

from repro.core import engine_jax
from repro.core.api import GraphicalJoin as RefGraphicalJoin
from repro.core.gfjs import GFJS as RefGFJS, LevelSummary as RefLevel
from repro.relational.query import JoinQuery as RefJoinQuery
from repro.relational.table import Catalog as RefCatalog, Table as RefTable

from repro_torch.core import engine
from repro_torch.core.api import GraphicalJoin
from repro_torch.core.gfjs import generate_gfjs
from repro_torch.interop import catalog_from_arrays, gfjs_from_arrays
from repro_torch.obs.metrics import REGISTRY
from repro_torch.relational.query import JoinQuery

from test_plan import SHAPES, _random_instance
from torch_cases import assert_gfjs_equal, memo_free
import torch_threads  # noqa: F401


def port_twin(cat, query, spec, output=None):
    """The port's catalog and query over the reference instance's arrays."""
    pcat = catalog_from_arrays({n: dict(t.columns)
                                for n, t in cat.tables.items()})
    return pcat, JoinQuery.of(query.name, spec, output=output)


def both_generators(cat, query, spec, output=None):
    ref = RefGraphicalJoin(cat, query)
    ref_gfjs = ref.run()
    pcat, pquery = port_twin(cat, query, spec, output)
    port = GraphicalJoin(pcat, pquery, device="cpu",
                         elimination_order=list(ref.plan().order))
    port.build_generator()
    return ref, ref_gfjs, port


def fallbacks():
    return REGISTRY.counter("engine.numpy_fallbacks").value


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generate_and_desummarize_match_reference(shape, seed):
    cat, query = _random_instance(shape, seed)
    ref, ref_gfjs, port = both_generators(cat, query, SHAPES[shape])
    before = fallbacks()
    got = engine.generate_gfjs(port.generator, port.enc.domains,
                               device="cpu")
    assert fallbacks() == before
    jax_gfjs = engine_jax.generate_gfjs_jax(ref.generator, ref.enc.domains,
                                            interpret=True)
    assert_gfjs_equal(got, ref_gfjs)
    assert_gfjs_equal(got, jax_gfjs)
    assert_gfjs_equal(got, generate_gfjs(port.generator, port.enc.domains))

    cols = engine.desummarize(got, decode=False, device="cpu")
    want = engine_jax.desummarize_jax(ref_gfjs, decode=False, interpret=True)
    assert list(cols) == list(want)
    for v in want:
        np.testing.assert_array_equal(cols[v].numpy(), np.asarray(want[v]))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("seed", [0, 1])
def test_generated_memo_and_memo_free_copy_match_reference(shape, seed):
    """Generation leaves each level's int32 codes (equal to key_cols) and
    bounds (None only for an identity level) on the device; a memo-free
    copy uploads them and desummarizes equal to desummarize_jax."""
    cat, query = _random_instance(shape, seed)
    ref, ref_gfjs, port = both_generators(cat, query, SHAPES[shape])
    got = engine.generate_gfjs(port.generator, port.enc.domains,
                               device="cpu")
    assert sorted(got._launch) == list(range(len(got.levels)))
    for li, lvl in enumerate(got.levels):
        dev, (bounds, codes) = got._launch[li]
        assert dev == torch.device("cpu")
        assert codes.shape == (len(lvl.vars), lvl.num_runs)
        for k, v in enumerate(lvl.vars):
            np.testing.assert_array_equal(codes[k].numpy(), lvl.key_cols[v])
        identity = lvl.num_runs == got.join_size and bool(np.all(
            lvl.freq == 1))
        assert (bounds is None) == identity
        if bounds is not None:
            np.testing.assert_array_equal(bounds.numpy(), np.cumsum(lvl.freq))
    copy = memo_free(got)
    cols = engine.desummarize(copy, decode=False, device="cpu")
    assert sorted(copy._launch) == sorted(got._launch)
    assert copy.aux_nbytes() == got.aux_nbytes()
    want = engine_jax.desummarize_jax(ref_gfjs, decode=False, interpret=True)
    memoized = engine.desummarize(got, decode=False, device="cpu")
    for v in want:
        np.testing.assert_array_equal(cols[v].numpy(), np.asarray(want[v]))
        assert torch.equal(cols[v], memoized[v])


@pytest.mark.parametrize("seed", [3, 5])
def test_projected_generation_matches_reference(seed):
    cat, query = _random_instance("chain3", seed, output=["A", "D"])
    ref, ref_gfjs, port = both_generators(cat, query, SHAPES["chain3"],
                                          output=["A", "D"])
    got = engine.generate_gfjs(port.generator, port.enc.domains,
                               device="cpu")
    assert_gfjs_equal(got, engine_jax.generate_gfjs_jax(
        ref.generator, ref.enc.domains, interpret=True))
    assert_gfjs_equal(got, ref_gfjs)


def test_empty_join_emits_empty_levels():
    spec = [("t0", {"x0": "A", "x1": "B"}), ("t1", {"x0": "B", "x1": "C"})]
    cat = RefCatalog.of(
        RefTable("t0", {"x0": np.asarray([0, 1]), "x1": np.asarray([0, 1])}),
        RefTable("t1", {"x0": np.asarray([5, 6]), "x1": np.asarray([2, 3])}))
    query = RefJoinQuery.of("dead", spec)
    ref, ref_gfjs, port = both_generators(cat, query, spec)
    assert ref_gfjs.join_size == 0
    got = engine.generate_gfjs(port.generator, port.enc.domains,
                               device="cpu")
    assert_gfjs_equal(got, engine_jax.generate_gfjs_jax(
        ref.generator, ref.enc.domains, interpret=True))
    cols = engine.desummarize(got, decode=True, device="cpu")
    assert all(len(c) == 0 for c in cols.values())


def test_join_past_int32_generates_on_numpy_and_counts():
    """2**32 rows from two 65,536-row tables: outside the int32 envelope,
    the generator runs on numpy (as in the reference) and is counted."""
    spec = [("t0", {"k": "K", "a": "A"}), ("t1", {"k": "K", "b": "B"})]
    n = 1 << 16
    cat = RefCatalog.of(
        RefTable("t0", {"k": np.zeros(n, np.int64), "a": np.zeros(n, np.int64)}),
        RefTable("t1", {"k": np.zeros(n, np.int64), "b": np.zeros(n, np.int64)}))
    ref, ref_gfjs, port = both_generators(cat, RefJoinQuery.of("wide", spec),
                                          spec)
    assert ref_gfjs.join_size == 1 << 32
    assert not engine._torch_generable(port.generator)
    before = fallbacks()
    got = engine.generate_gfjs(port.generator, port.enc.domains,
                               device="cpu")
    assert fallbacks() == before + 1
    assert_gfjs_equal(got, ref_gfjs)
    assert_gfjs_equal(got, engine_jax.generate_gfjs_jax(
        ref.generator, ref.enc.domains, interpret=True))


def test_codes_past_int32_desummarize_on_numpy_and_count():
    big = (1 << 31) + np.asarray([3, 7], np.int64)
    freq = np.asarray([2, 1], np.int64)
    ref = RefGFJS([RefLevel(("A",), {"A": big}, freq),
                   RefLevel(("B",), {"B": np.asarray([1, 0, 2])},
                            np.ones(3, np.int64))], ["A", "B"], 3, {})
    port = gfjs_from_arrays([(lvl.vars, lvl.key_cols, lvl.freq)
                             for lvl in ref.levels], ref.column_order, 3, {})
    before = fallbacks()
    got = engine.desummarize(port, decode=False, device="cpu")
    assert fallbacks() == before + 1
    want = engine_jax.desummarize_jax(ref, decode=False, interpret=True)
    for v in ("A", "B"):
        np.testing.assert_array_equal(got[v].numpy(), np.asarray(want[v]))
