"""The deferred host mirror of a generated GFJS level.

``engine.generate_gfjs`` keeps each level's int32 codes and bounds on the
device (``GFJS._launch``) and emits ``LevelSummary.deferred`` levels whose
``key_cols`` and ``freq`` are downloaded on their first read.  Held here,
on ``device="cpu"``: the arrays a first read gives equal the numpy
generation's and the reference's (``generate_gfjs_jax``, interpret mode)
level for level; ``run()`` and ``desummarize`` read nothing back; the
shape queries fetch nothing; concurrent readers fetch once; the memo's
replacement by another device fills the mirror first; storage, interop
and pickling carry the same arrays and no tensor.
"""

import io
import os
import pickle
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import engine_jax
from repro.core.gfjs import GFJS as RefGFJS, LevelSummary as RefLevel
from repro.core.storage import load_gfjs as ref_load_gfjs

import repro_torch
from repro_torch.core import engine
from repro_torch.core.gfjs import GFJS, LevelSummary, generate_gfjs
from repro_torch.interop import gfjs_from_arrays
from repro_torch.kernels import ops
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import Tracer
from repro_torch.relational.synth import lastfm_like

from test_plan import SHAPES, _random_instance
from test_torch_engine import both_generators
from torch_cases import assert_gfjs_equal, spans_bytes

SMALL_LASTFM = dict(n_users=150, n_artists=120, artists_per_user=5,
                    friends_per_user=3)


def fetches() -> float:
    return REGISTRY.counter("engine.mirror_fetches").value


def _deferred(gfjs):
    """The generated levels (every level but the host generator's root)."""
    return gfjs.levels[1:]


def _lastfm(query="lastfm_A1", tracer=None):
    cat, queries = lastfm_like(**SMALL_LASTFM)
    gj = repro_torch.GraphicalJoin(cat, queries[query], device="cpu",
                                   tracer=tracer)
    return gj, gj.run()


def _numpy(query):
    """The same join generated on numpy: eager levels."""
    cat, queries = lastfm_like(**SMALL_LASTFM)
    return repro_torch.GraphicalJoin(cat, queries[query], device="cpu",
                                     generation_backend="numpy").run()


def _identity(gfjs, li):
    return gfjs._launch[li][1][0] is None


def _ranged(gfjs):
    """The first generated level that is not an identity level."""
    return next(li for li in range(1, len(gfjs.levels))
                if not _identity(gfjs, li))


def _assert_levels_int64(gfjs):
    for lvl in gfjs.levels:
        assert lvl.freq.dtype == np.int64
        assert all(lvl.key_cols[v].dtype == np.int64 for v in lvl.vars)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_first_read_equals_numpy_and_reference(shape, seed):
    cat, query = _random_instance(shape, seed)
    ref, ref_gfjs, port = both_generators(cat, query, SHAPES[shape])
    before = fetches()
    got = engine.generate_gfjs(port.generator, port.enc.domains,
                               device="cpu")
    assert fetches() == before
    _assert_levels_int64(got)
    assert fetches() == before + len(_deferred(got))
    assert_gfjs_equal(got, generate_gfjs(port.generator, port.enc.domains))
    assert_gfjs_equal(got, engine_jax.generate_gfjs_jax(
        ref.generator, ref.enc.domains, interpret=True))
    assert_gfjs_equal(got, ref_gfjs)


@pytest.mark.parametrize("query", ["lastfm_A1", "lastfm_A2", "lastfm_B"])
def test_first_read_of_lastfm_levels_equals_numpy(query):
    """Last.fm-like joins at a small size; A1's deepest level is an
    identity level, whose run lengths are ones made on the host."""
    _, got = _lastfm(query)
    want = _numpy(query)
    if query == "lastfm_A1":
        assert _identity(got, len(got.levels) - 1)
    _assert_levels_int64(got)
    assert_gfjs_equal(got, want)


@pytest.mark.parametrize("query", ["lastfm_A1", "lastfm_A2"])
def test_run_and_desummarize_read_no_level_back(query):
    tr = Tracer()
    before = fetches()
    gj, gfjs = _lastfm(query, tr)
    cols = gj.desummarize(gfjs, decode=False)
    assert fetches() == before
    assert spans_bytes(tr, "engine:download") == (0, 0)
    assert len(cols) == gfjs.num_columns
    assert {int(c.numel()) for c in cols.values()} == {gfjs.join_size}


def test_shape_queries_fetch_nothing_and_equal_the_eager_values():
    _, gfjs = _lastfm("lastfm_A2")
    want = _numpy("lastfm_A2")
    before = fetches()
    runs = [lvl.num_runs for lvl in gfjs.levels]
    nbytes = [lvl.nbytes() for lvl in gfjs.levels]
    total, resident = gfjs.nbytes(), gfjs.resident_nbytes()
    assert gfjs.join_size == want.join_size
    assert gfjs.num_runs() == want.num_runs()
    assert "deferred" in repr(gfjs.levels[1])
    assert fetches() == before
    assert runs == [lvl.num_runs for lvl in want.levels]
    assert nbytes == [lvl.nbytes() for lvl in want.levels]
    assert total == want.nbytes()
    assert resident == want.nbytes() + gfjs.aux_nbytes()
    _assert_levels_int64(gfjs)
    assert fetches() == before + len(_deferred(gfjs))
    assert [lvl.num_runs for lvl in gfjs.levels] == runs
    assert [lvl.nbytes() for lvl in gfjs.levels] == nbytes
    assert gfjs.resident_nbytes() == resident


@pytest.mark.parametrize("read", ["freq", "key_cols"])
def test_concurrent_readers_of_one_level_fetch_it_once(monkeypatch, read):
    """More reader threads than cores (at least eight), the interpreter
    switching threads every microsecond and each download slowed: one
    fetch, and every reader gets the same array."""
    _, gfjs = _lastfm("lastfm_A2")
    lvl = gfjs.levels[_ranged(gfjs)]
    download = engine._download

    def slow(t, dtype=None):
        time.sleep(0.02)
        return download(t, dtype)

    monkeypatch.setattr(engine, "_download", slow)
    n = max(8, (os.cpu_count() or 1) + 1)
    barrier = threading.Barrier(n)
    got, errors = [], []

    def reader():
        try:
            barrier.wait(timeout=30)
            got.append(getattr(lvl, read))
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    before = fetches()
    ts = [threading.Thread(target=reader) for _ in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    assert not errors, errors
    assert fetches() == before + 1
    assert len(got) == n and all(g is got[0] for g in got)


def test_deferred_level_fetches_once_and_drops_its_fetch():
    calls = []
    cols, freq = {"A": np.arange(3, dtype=np.int64)}, np.ones(3, np.int64)

    def fetch():
        calls.append(1)
        return cols, freq

    lvl = LevelSummary.deferred(["A"], 3, fetch)
    assert lvl.vars == ("A",) and lvl.num_runs == 3
    assert lvl.nbytes() == 3 * 8 * 2 and not calls
    assert lvl.freq is freq and lvl.key_cols is cols and len(calls) == 1
    assert lvl.key_cols is cols and len(calls) == 1
    assert lvl._fetch is None
    assert lvl.nbytes() == 3 * 8 * 2


def test_replacing_the_memo_for_another_device_fills_the_mirror_first():
    """gfjs_launch on another device reads the level's host arrays before
    replacing its entry: the mirror is fetched from the old tensors."""
    _, gfjs = _lastfm("lastfm_A2")
    want = _numpy("lastfm_A2")
    li = _ranged(gfjs)
    old_bounds, old_codes = gfjs._launch[li][1]
    gfjs._launch[li] = (torch.device("meta"), gfjs._launch[li][1])
    before = fetches()
    bounds, codes = ops.gfjs_launch(gfjs, li, "cpu")
    assert fetches() == before + 1
    assert gfjs._launch[li][0] == torch.device("cpu")
    assert gfjs._launch[li][1][0] is bounds and bounds is not old_bounds
    assert torch.equal(bounds, old_bounds) and torch.equal(codes, old_codes)
    lvl = gfjs.levels[li]
    np.testing.assert_array_equal(lvl.freq, want.levels[li].freq)
    for v in lvl.vars:
        np.testing.assert_array_equal(lvl.key_cols[v],
                                      want.levels[li].key_cols[v])
    assert fetches() == before + 1


def _ref_twin(gfjs):
    """The reference's GFJS over the port's arrays (the JAX package's
    LevelSummary and Domain)."""
    from repro.relational.encoding import Domain as RefDomain
    return RefGFJS([RefLevel(tuple(l.vars), dict(l.key_cols), l.freq)
                    for l in gfjs.levels], list(gfjs.column_order),
                   gfjs.join_size,
                   {v: RefDomain(v, d.values) for v, d in gfjs.domains.items()})


def test_storage_round_trip_of_a_deferred_gfjs(tmp_path):
    gj, gfjs = _lastfm("lastfm_A2")
    want = _numpy("lastfm_A2")
    before = fetches()
    path = str(tmp_path / "a2.gfjs")
    gj.store(gfjs, path)
    assert fetches() == before + len(_deferred(gfjs))
    back = repro_torch.GraphicalJoin.load(path)
    assert not back._launch
    assert_gfjs_equal(back, want)
    assert_gfjs_equal(ref_load_gfjs(path), want)
    got = gj.desummarize(back, decode=False)
    mine = gj.desummarize(gfjs, decode=False)
    for v in gfjs.column_order:
        assert torch.equal(got[v], mine[v])


def test_interop_round_trip_of_a_deferred_gfjs():
    gj, gfjs = _lastfm("lastfm_A1")
    ref = _ref_twin(gfjs)
    want = engine_jax.desummarize_jax(ref, decode=False, interpret=True)
    got = gj.desummarize(gfjs, decode=False)
    for v in want:
        np.testing.assert_array_equal(got[v].numpy(), np.asarray(want[v]))
    back = gfjs_from_arrays([(l.vars, l.key_cols, l.freq)
                             for l in ref.levels], ref.column_order,
                            ref.join_size,
                            {v: d.values for v, d in ref.domains.items()})
    assert_gfjs_equal(back, gfjs)


class _NoTorch(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] == "torch":
            raise AssertionError(f"a tensor in the pickle: {module}.{name}")
        return super().find_class(module, name)


def test_pickle_of_a_deferred_gfjs_carries_arrays_and_no_tensor():
    import copy
    gj, gfjs = _lastfm("lastfm_A1")
    want = _numpy("lastfm_A1")
    before = fetches()
    data = pickle.dumps(gfjs)
    assert fetches() == before + len(_deferred(gfjs))
    back = _NoTorch(io.BytesIO(data)).load()
    assert isinstance(back, GFJS) and not back._launch
    assert gfjs._launch                     # the original keeps its memo
    assert all(type(l) is LevelSummary for l in back.levels)
    assert_gfjs_equal(back, want)
    assert_gfjs_equal(copy.deepcopy(gfjs), want)
    got = gj.desummarize(back, decode=False)
    mine = gj.desummarize(gfjs, decode=False)
    for v in gfjs.column_order:
        assert torch.equal(got[v], mine[v])
