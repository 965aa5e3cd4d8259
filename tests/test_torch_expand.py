"""The port's RLE expansions against the reference's Pallas kernels.

``expand_many_ref`` and ``rle_expand_many`` on CPU tensors (the plain
version the wrapper runs there) against the reference's
``ops.rle_expand_many(..., interpret=True)`` and ``np.repeat``; the
single-payload ``rle_expand`` and ``expand_indices`` against the
reference's ``expand.expand_gather`` and ``ops.expand_indices``; the
device memo of a GFJS level's launch data that ``run()`` fills and
``desummarize`` reads (no upload, no host prefix sums), the upload path
of a GFJS without it, and the identity level.  GJ is integer arithmetic:
every comparison is exact (float payloads bit for bit).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import engine_jax  # also flips jax_enable_x64 on
from repro.core.gfjs import GFJS as RefGFJS, LevelSummary as RefLevel
from repro.kernels import ops as jax_ops
from repro.kernels.expand import expand_gather as jax_expand_gather

import repro_torch
from repro_torch.core import engine
from repro_torch.core.gfjs import desummarize as np_desummarize
from repro_torch.kernels import ops
from repro_torch.kernels.expand_gather import expand_gather
from repro_torch.kernels.expand_many import expand_many
from repro_torch.kernels.ref import expand_gather_ref, expand_many_ref
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import Tracer
from repro_torch.relational.synth import lastfm_like

from torch_cases import (bounds_of, expand_cases, gather_cases, level_gfjs,
                         memo_free, repeat_oracle, spans_bytes,
                         zero_run_identity_gfjs)
import torch_threads  # noqa: F401

CASES = expand_cases()
GATHER = gather_cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_expand_many_matches_reference_kernel(name):
    payloads, freqs = CASES[name]
    bounds, total = bounds_of(freqs)
    want = repeat_oracle(payloads, freqs)
    ref = np.asarray(jax_ops.rle_expand_many(payloads, bounds, total,
                                             interpret=True))
    np.testing.assert_array_equal(ref, want)

    p_t, b_t = torch.from_numpy(payloads), torch.from_numpy(bounds)
    plain = expand_many_ref(p_t, b_t, total)
    launches = expand_many.launches
    calls = REGISTRY.counter("kernels.launches").value
    got = ops.rle_expand_many(p_t, b_t, total)
    # a CPU tensor runs the plain version: no kernel launch is counted,
    # while the ops-level call counter (the reference's) still moves
    assert expand_many.launches == launches
    assert REGISTRY.counter("kernels.launches").value == calls + 1
    for out in (plain, got):
        assert out.dtype == torch.int32 and out.shape == want.shape
        np.testing.assert_array_equal(out.numpy(), ref)


def test_k1_matches_single_payload_reference():
    payloads, freqs = CASES["k1"]
    bounds, total = bounds_of(freqs)
    one = np.asarray(jax_ops.rle_expand(payloads[0], bounds, total,
                                        interpret=True))
    got = ops.rle_expand_many(torch.from_numpy(payloads),
                              torch.from_numpy(bounds), total)
    np.testing.assert_array_equal(got[0].numpy(), one)


@pytest.mark.parametrize("bad", ["dtype", "shape", "total", "no-runs"])
def test_expand_many_rejects_bad_inputs(bad):
    payloads = torch.zeros((2, 4), dtype=torch.int32)
    bounds = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    total = 4
    err = ValueError
    if bad == "dtype":
        payloads, err = payloads.long(), TypeError
    elif bad == "shape":
        bounds = bounds[:3]
    elif bad == "total":
        total = 1 << 31
    else:
        payloads, bounds = payloads[:, :0], bounds[:0]
    with pytest.raises(err):
        expand_many(payloads, bounds, total)


# ---------------------------------------------------------------------------
# the single-payload expansion (expand_gather)
# ---------------------------------------------------------------------------

def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("n_runs", [1, 7, 500, 513, 2048])
@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_rle_expand_matches_reference_kernel(n_runs, dtype):
    """test_expand_gather_shapes' axes: the reference kernel in interpret
    mode, its pure-jnp oracle and np.repeat agree with the port."""
    payload, freqs = GATHER[f"sweep-{n_runs}-{dtype}"]
    bounds, total = bounds_of(freqs)
    want = np.asarray(jax_expand_gather(
        jnp.asarray(payload), jnp.asarray(bounds),
        t_pad=jax_ops.next_bucket(total), interpret=True))[:total]
    np.testing.assert_array_equal(_bits(want),
                                  _bits(np.repeat(payload, freqs)))
    p_t, b_t = torch.from_numpy(payload), torch.from_numpy(bounds)
    calls = REGISTRY.counter("kernels.launches").value
    launches = expand_gather.launches
    got = ops.rle_expand(p_t, b_t, total)
    assert REGISTRY.counter("kernels.launches").value == calls + 1
    assert expand_gather.launches == launches    # the CPU runs no kernel
    assert got.dtype == p_t.dtype and got.shape == (total,)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("name", sorted(GATHER))
def test_expand_gather_cases_match_numpy(name):
    payload, freqs = GATHER[name]
    bounds, total = bounds_of(freqs)
    p_t, b_t = torch.from_numpy(payload), torch.from_numpy(bounds)
    want = _bits(np.repeat(payload, freqs))
    for out in (expand_gather(p_t, b_t, total),
                expand_gather_ref(p_t, b_t, total),
                ops.rle_expand(p_t, None, total, meta=ops.expand_meta(b_t))):
        assert out.dtype == p_t.dtype
        np.testing.assert_array_equal(_bits(out), want)


def test_expand_gather_is_expand_many_at_k1():
    payload, freqs = GATHER["sweep-513-int32"]
    bounds, total = bounds_of(freqs)
    p_t, b_t = torch.from_numpy(payload), torch.from_numpy(bounds)
    assert torch.equal(expand_gather(p_t, b_t, total),
                       expand_many(p_t[None], b_t, total)[0])


def test_expand_indices_matches_reference():
    """The reference test's runs, then a sweep with zero-length runs."""
    for freqs in (np.asarray([3, 1, 4, 1, 5, 9, 2, 6]),
                  GATHER["zero-length-runs"][1]):
        bounds, total = bounds_of(freqs)
        want = np.repeat(np.arange(len(freqs)), freqs)
        ref = np.asarray(jax_ops.expand_indices(jnp.asarray(bounds), total,
                                                interpret=True))
        np.testing.assert_array_equal(ref, want)
        got = ops.expand_indices(torch.from_numpy(bounds), total)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bad", ["int64-payload", "int64-bounds", "shape",
                                 "total", "no-runs"])
def test_expand_gather_rejects_bad_inputs(bad):
    payload = torch.zeros(4, dtype=torch.int32)
    bounds = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    total, err = 4, ValueError
    if bad == "int64-payload":
        payload, err = payload.long(), TypeError
    elif bad == "int64-bounds":
        bounds, err = bounds.long(), TypeError
    elif bad == "shape":
        bounds = bounds[:3]
    elif bad == "total":
        total = 1 << 31
    else:
        payload, bounds = payload[:0], bounds[:0]
    with pytest.raises(err):
        expand_gather(payload, bounds, total)


def test_expand_meta_takes_arrays_and_tensors():
    bounds = np.asarray([2, 2, 7], np.int64)
    for b in (bounds, torch.from_numpy(bounds)):
        meta = ops.expand_meta(b, "cpu")
        assert meta.dtype == torch.int32 and meta.is_contiguous()
        np.testing.assert_array_equal(meta.numpy(), bounds)
    with pytest.raises(ValueError):
        ops.expand_meta(np.asarray([1, 1 << 31]), "cpu")


def _a1_small():
    cat, queries = lastfm_like(n_users=150, n_artists=120,
                               artists_per_user=5, friends_per_user=3)
    tr = Tracer()
    gj = repro_torch.GraphicalJoin(cat, queries["lastfm_A1"], device="cpu",
                                   tracer=tr)
    return gj, gj.run(), tr


def _memo_nbytes(gfjs):
    return sum((0 if b is None else b.nbytes) + c.nbytes
               for _, (b, c) in gfjs._launch.values())


def test_desummarize_twice_reuses_the_memoized_bounds():
    """run() fills one _launch entry per level, both desummarize calls
    reuse it untouched, and aux_nbytes counts it exactly; equal columns,
    equal to the numpy path."""
    gj, gfjs, _ = _a1_small()
    entries = dict(gfjs._launch)
    assert sorted(entries) == list(range(len(gfjs.levels)))
    assert all(e[0] == torch.device("cpu") for e in entries.values())
    assert gfjs.aux_nbytes() == _memo_nbytes(gfjs) > 0
    first = engine.desummarize(gfjs, device="cpu")
    second = engine.desummarize(gfjs, device="cpu")
    assert gfjs._launch == entries
    assert all(gfjs._launch[lv] is e for lv, e in entries.items())
    assert not gfjs._bounds
    want = np_desummarize(gfjs, decode=False)
    for v in gfjs.column_order:
        assert torch.equal(first[v], second[v])
        np.testing.assert_array_equal(first[v].numpy(), np.asarray(want[v]))
    assert gfjs.aux_nbytes() == _memo_nbytes(gfjs) + sum(
        b.nbytes for b in gfjs._bounds.values())
    # one entry per level: an entry of another device is replaced
    gfjs._launch[0] = (torch.device("meta"), gfjs._launch[0][1])
    bounds = ops.gfjs_expand_meta(gfjs, 0, "cpu")
    assert gfjs._launch[0][0] == torch.device("cpu")
    assert gfjs._launch[0][1][0] is bounds
    np.testing.assert_array_equal(bounds.numpy(), np.cumsum(
        gfjs.levels[0].freq))
    assert len(gfjs._launch) == len(gfjs.levels)


def test_desummarize_after_run_uploads_nothing():
    """No engine:upload span, no host prefix sums: the launch data is the
    memo that run() left on the device."""
    gj, gfjs, tr = _a1_small()
    since = len(tr.spans)
    cols = gj.desummarize(gfjs, decode=False)
    assert spans_bytes(tr, "engine:upload", since) == (0, 0)
    assert not gfjs._bounds
    assert len(cols) == gfjs.num_columns
    # neither run() nor desummarize downloaded a level; the first host read
    # of each generated level downloads it once: one span per int32 code
    # column (widened on the host) and one for the int32 bounds, whose
    # difference the host takes (none for an identity level's ones)
    assert spans_bytes(tr, "engine:download") == (0, 0)
    deep = gfjs.levels[1:]
    since = len(tr.spans)
    with tr.span("read"):
        for lvl in deep:
            lvl.freq
    n, nbytes = spans_bytes(tr, "engine:download", since)
    ranged = [gfjs._launch[li][1][0] is not None
              for li in range(1, len(gfjs.levels))]
    assert n == sum(len(lvl.vars) + r for lvl, r in zip(deep, ranged))
    assert nbytes == sum(lvl.num_runs * 4 * (len(lvl.vars) + r)
                         for lvl, r in zip(deep, ranged))
    since = len(tr.spans)
    with tr.span("read"):
        for lvl in deep:
            lvl.key_cols, lvl.freq
    assert spans_bytes(tr, "engine:download", since) == (0, 0)


def test_memoized_codes_equal_the_levels():
    gj, gfjs, _ = _a1_small()
    for li, lvl in enumerate(gfjs.levels):
        bounds, codes = gfjs._launch[li][1]
        assert codes.dtype == torch.int32
        assert codes.shape == (len(lvl.vars), lvl.num_runs)
        for k, v in enumerate(lvl.vars):
            np.testing.assert_array_equal(codes[k].numpy(), lvl.key_cols[v])
        if bounds is None:
            assert lvl.num_runs == gfjs.join_size
            assert np.all(lvl.freq == 1)
        else:
            np.testing.assert_array_equal(bounds.numpy(),
                                          np.cumsum(lvl.freq))


def test_memo_free_copy_matches_memoized_numpy_and_reference():
    """A GFJS rebuilt from its levels uploads each level once, then
    desummarizes equal to the memoized path, to numpy and to the
    reference's desummarize_jax (interpret mode)."""
    gj, gfjs, tr = _a1_small()
    memoized = gj.desummarize(gfjs, decode=False)
    copy = memo_free(gfjs)
    assert not copy._launch
    since = len(tr.spans)
    got = gj.desummarize(copy, decode=False)
    n, nbytes = spans_bytes(tr, "engine:upload", since)
    assert n == len(copy.levels)
    assert nbytes == sum(lvl.num_runs * (4 * len(lvl.vars) + 8)
                         for lvl in copy.levels)
    assert not copy._bounds
    assert copy.aux_nbytes() == gfjs.aux_nbytes()
    since = len(tr.spans)
    again = gj.desummarize(copy, decode=False)
    assert spans_bytes(tr, "engine:upload", since) == (0, 0)
    ref = RefGFJS([RefLevel(lvl.vars, lvl.key_cols, lvl.freq)
                   for lvl in gfjs.levels], list(gfjs.column_order),
                  gfjs.join_size, {})
    want = engine_jax.desummarize_jax(ref, decode=False, interpret=True)
    numpy_cols = np_desummarize(gfjs, decode=False)
    for v in gfjs.column_order:
        assert torch.equal(got[v], memoized[v])
        assert torch.equal(again[v], memoized[v])
        np.testing.assert_array_equal(got[v].numpy(), numpy_cols[v])
        np.testing.assert_array_equal(got[v].numpy(), np.asarray(want[v]))


@pytest.mark.parametrize("name", sorted(CASES))
def test_memo_free_level_uploads_once_and_matches_repeat(name):
    payloads, freqs = CASES[name]
    gfjs = level_gfjs(payloads, freqs)
    tr = Tracer()
    with tr.span("case"):
        first = engine.desummarize(gfjs, device="cpu")
        n_up = len(tr.find("engine:upload"))
        second = engine.desummarize(gfjs, device="cpu")
    assert n_up == 1 and len(tr.find("engine:upload")) == 1
    assert not gfjs._bounds
    want = repeat_oracle(payloads, freqs)
    for k, v in enumerate(gfjs.column_order):
        np.testing.assert_array_equal(first[v].numpy(), want[k])
        assert torch.equal(first[v], second[v])


def test_identity_level_launches_nothing_and_is_a_copy():
    """Every freq 1 and num_runs == join_size: the columns are a copy of
    the memoized codes, with no bounds held and no launch."""
    gj, gfjs, _ = _a1_small()
    last = len(gfjs.levels) - 1
    bounds, codes = gfjs._launch[last][1]
    assert bounds is None and gfjs.levels[last].num_runs == gfjs.join_size
    calls = REGISTRY.counter("kernels.launches").value
    cols = engine.desummarize(gfjs, device="cpu")
    assert REGISTRY.counter("kernels.launches").value == calls + last
    v = gfjs.levels[last].vars[0]
    assert cols[v].untyped_storage().data_ptr() != \
        codes.untyped_storage().data_ptr()
    want = cols[v].clone()
    cols[v].fill_(-1)
    again = engine.desummarize(gfjs, device="cpu")
    assert torch.equal(again[v], want)
    np.testing.assert_array_equal(codes[0].numpy(),
                                  gfjs.levels[last].key_cols[v])
    # kernel-API bounds of an identity level are made, not held
    np.testing.assert_array_equal(
        ops.gfjs_expand_meta(gfjs, last, "cpu").numpy(),
        np.arange(1, gfjs.join_size + 1))
    assert gfjs._launch[last][1][0] is None


def test_zero_length_run_level_is_not_an_identity():
    """num_runs == join_size with a zero-length run: the level goes
    through the kernel and equals np.repeat."""
    gfjs = zero_run_identity_gfjs()
    calls = REGISTRY.counter("kernels.launches").value
    cols = engine.desummarize(gfjs, device="cpu")
    assert REGISTRY.counter("kernels.launches").value == calls + 2
    assert all(e[1][0] is not None for e in gfjs._launch.values())
    np.testing.assert_array_equal(cols["B"].numpy(), np.repeat(
        gfjs.levels[1].key_cols["B"], gfjs.levels[1].freq))
    np.testing.assert_array_equal(cols["A"].numpy(), [0, 0, 1])
