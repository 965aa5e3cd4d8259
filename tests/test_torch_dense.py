"""The port's dense message against the reference's Pallas kernel and numpy.

``ops.dense_message`` and ``engine.maybe_dense_message`` on the CPU (the
plain versions the wrappers run there) against the reference's
``dense_contract.dense_message(interpret=True)`` and
``engine_jax.maybe_dense_message(interpret=True)``, and against numpy's
int64 route.  Integers are compared exactly; so are the float32 cases,
whose sums of integers stay below 2^24, where an f32 sum is exact.

Deliberate difference, tested here: the reference multiplies in f32, so
its products and row sums past 2^24 round although each operand is below
2^24; the port's counts are int64 and equal numpy's route bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import engine_jax
from repro.core.potentials import Factor as RefFactor
from repro.kernels import dense_contract
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref

from repro_torch.core import engine
from repro_torch.core.potentials import Factor
from repro_torch.kernels import ops, ref
from repro_torch.kernels.dense_message import (MIN_SPLIT_V, ROWS_PER_BLOCK,
                                               THIN_K, dense_message,
                                               v_split)
from repro_torch.obs.metrics import REGISTRY
from repro_torch.relational.synth import lastfm_like

from torch_cases import dense_cases, dense_oracle, numpy_message
import torch_threads  # noqa: F401

CASES = dense_cases()
# the plain version's int64 mm on the CPU: keep the CPU sweep small
CPU_CASES = sorted(n for n, (phi, m) in CASES.items()
                   if phi.shape[0] * phi.shape[1] * m.shape[1] <= 1 << 22)


@pytest.mark.parametrize("P,V,K", [(1, 1, 1), (128, 128, 1), (300, 257, 5),
                                   (256, 512, 128), (513, 100, 130)])
def test_float_matches_reference_kernel(P, V, K):
    """test_dense_message_shapes' five shapes and inputs."""
    rng = np.random.default_rng(P * V + K)
    phi = rng.integers(0, 100, (P, V)).astype(np.float32)
    m = rng.integers(0, 100, (V, K)).astype(np.float32)
    want = np.asarray(dense_contract.dense_message(
        jnp.asarray(phi), jnp.asarray(m), interpret=True))
    np.testing.assert_array_equal(
        want, np.asarray(jax_ref.dense_message_ref(jnp.asarray(phi),
                                                   jnp.asarray(m))))
    phi_t, m_t = torch.from_numpy(phi), torch.from_numpy(m)
    calls = REGISTRY.counter("kernels.launches").value
    launches = dense_message.launches
    got = ops.dense_message(phi_t, m_t)
    assert REGISTRY.counter("kernels.launches").value == calls + 1
    assert dense_message.launches == launches     # the CPU runs no kernel
    for out in (got, ref.dense_message_ref(phi_t, m_t)):
        assert out.dtype == torch.float32 and out.shape == (P, K)
        np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("name", CPU_CASES)
def test_plain_version_matches_numpy(name):
    phi, m = CASES[name]
    got = ops.dense_message(torch.from_numpy(phi), torch.from_numpy(m))
    want = dense_oracle(phi, m)
    assert got.dtype == (torch.float32 if phi.dtype == np.float32
                         else torch.int64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", [n for n in CPU_CASES
                                  if n.startswith("counts-")])
def test_counts_by_rows_matches_mm(monkeypatch, name):
    """The card's plain product (broadcast, chunked by rows) equals int64
    ``mm``, chunk edges included."""
    monkeypatch.setattr(ref, "_CHUNK_ELEMS", 1000)
    phi, m = (torch.from_numpy(a) for a in CASES[name])
    assert torch.equal(ref.counts_by_rows(phi, m), phi.long() @ m.long())


def test_reference_rounds_past_2_24_where_the_port_is_exact():
    """Each operand is below 2^24, so the reference's guard lets the f32
    product through; 4097 * 4097 + 1 = 16,785,410 is not an f32 value."""
    phi, m = CASES["counts-f32-rounding"]
    ref_out = np.asarray(dense_contract.dense_message(
        jnp.asarray(phi, jnp.float32), jnp.asarray(m, jnp.float32),
        interpret=True))
    got = ops.dense_message(torch.from_numpy(phi), torch.from_numpy(m))
    assert int(got[0, 0]) == 16_785_410
    assert int(ref_out[0, 0]) == 16_785_408


@pytest.mark.parametrize("bad", ["dtype-mix", "int64", "float64", "shape",
                                 "rank"])
def test_dense_message_rejects_bad_inputs(bad):
    phi = torch.ones((3, 4), dtype=torch.int32)
    m = torch.ones((4, 2), dtype=torch.int32)
    err = TypeError
    if bad == "dtype-mix":
        m = m.float()
    elif bad == "int64":
        phi, m = phi.long(), m.long()
    elif bad == "float64":
        phi, m = phi.double(), m.double()
    elif bad == "shape":
        m, err = m[:3], ValueError
    else:
        m, err = m[:, 0], ValueError
    with pytest.raises(err):
        dense_message(phi, m)


def test_non_contiguous_inputs():
    rng = np.random.default_rng(5)
    phi = torch.from_numpy(rng.integers(0, 9, (40, 30)).astype(np.int32))
    m = torch.from_numpy(rng.integers(0, 9, (6, 30)).astype(np.int32))
    got = ops.dense_message(phi.T.contiguous().T, m.T)
    assert torch.equal(got, phi.long() @ m.T.long())


def test_thin_k_cases_sit_on_both_sides_of_the_crossover():
    ks = {m.shape[1] for n, (phi, m) in CASES.items() if "-thin-" in n}
    assert {THIN_K, THIN_K + 1} <= ks


@pytest.mark.parametrize("p,v,sms", [(1892, 1892, 132), (1, 1 << 20, 132),
                                     (500, 1892, 132), (10, 10_000, 132),
                                     (1, 2047, 132), (7, 70_001, 132),
                                     (1055, 5000, 132), (1, 1 << 30, 132),
                                     (3, 9000, 114)])
def test_v_split_covers_v(p, v, sms):
    """Splits only where P rows leave SMs idle; steps of at least
    MIN_SPLIT_V, multiples of 4, that cover V with none empty."""
    splits, step = v_split(p, v, sms)
    assert (splits - 1) * step < v <= splits * step
    if splits == 1:
        assert step == v
    else:
        assert p < sms * ROWS_PER_BLOCK and step % 4 == 0
        assert step >= MIN_SPLIT_V and splits <= 65535


# ---------------------------------------------------------------------------
# engine.maybe_dense_message
# ---------------------------------------------------------------------------

def _both(keys, bucket, fac, sizes, vars=("P", "V")):
    return (Factor(vars, keys, bucket, fac, sizes),
            RefFactor(vars, keys, bucket, fac, sizes))


def test_maybe_dense_message_matches_reference():
    """test_dense_message_path_matches_coo's case."""
    rng = np.random.default_rng(1)
    cols = {"P": rng.integers(0, 30, 2000), "V": rng.integers(0, 20, 2000)}
    sizes = {"P": 30, "V": 20}
    phi = Factor.from_columns(cols, sizes)
    msg = rng.integers(1, 50, 20).astype(np.int64)
    want = engine_jax.maybe_dense_message(RefFactor.from_columns(cols, sizes),
                                          "V", msg, interpret=True)
    got = engine.maybe_dense_message(phi, "V", msg, device="cpu")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, numpy_message(phi, "V", msg))


@pytest.mark.parametrize("child", ["U1", "U2"])
def test_maybe_dense_message_lastfm_friends(child):
    """Both directions over a Last.fm-like user_friends potential, against
    the numpy route and the reference (exact: every sum is below 2^24)."""
    cat, _ = lastfm_like(n_users=150, n_artists=120, artists_per_user=5,
                         friends_per_user=3)
    uf, ua = cat["user_friends"], cat["user_artists"]
    cols = {"U1": uf.columns["userID"], "U2": uf.columns["friendID"]}
    sizes = {"U1": 150, "U2": 150}
    phi = Factor.from_columns(cols, sizes)
    msg = np.bincount(ua.columns["userID"], minlength=150).astype(np.int64)
    got = engine.maybe_dense_message(phi, child, msg, device="cpu")
    np.testing.assert_array_equal(got, numpy_message(phi, child, msg))
    np.testing.assert_array_equal(got, engine_jax.maybe_dense_message(
        RefFactor.from_columns(cols, sizes), child, msg, interpret=True))


def test_chained_messages_count_the_join():
    """A1 - U1 - U2 - A2 and one hop more: the messages' sums are the join
    sizes the GFJS gives."""
    import repro_torch
    cat, queries = lastfm_like(n_users=150, n_artists=120,
                               artists_per_user=5, friends_per_user=3)
    uf, ua = cat["user_friends"], cat["user_artists"]
    phi = Factor.from_columns({"U1": uf.columns["userID"],
                               "U2": uf.columns["friendID"]},
                              {"U1": 150, "U2": 150})
    m_ua = np.bincount(ua.columns["userID"], minlength=150).astype(np.int64)
    m1 = engine.maybe_dense_message(phi, "U2", m_ua, device="cpu")
    m2 = engine.maybe_dense_message(phi, "U2", m1, device="cpu")
    for name, msg in (("lastfm_A1", m1), ("lastfm_A2", m2)):
        gj = repro_torch.GraphicalJoin(cat, queries[name], device="cpu")
        assert int(msg @ m_ua) == gj.join_size()


def test_maybe_dense_message_past_2_24_equals_numpy():
    """The reference rounds both (its operand guard passes); the port is
    exact.  2,000 cells of 9,000 against 9,001 make 162,018,000,000."""
    keys = np.stack([np.zeros(2000, np.int64), np.arange(2000)], axis=1)
    phi, rphi = _both(keys, np.full(2000, 9000), np.ones(2000, np.int64),
                      (1, 2000))
    msg = np.full(2000, 9001, np.int64)
    got = engine.maybe_dense_message(phi, "V", msg, device="cpu")
    want = engine_jax.maybe_dense_message(rphi, "V", msg, interpret=True)
    assert int(got[0]) == 162_018_000_000
    np.testing.assert_array_equal(got, numpy_message(phi, "V", msg))
    assert int(want[0]) == 162_017_656_832      # f32 rounding

    phi, rphi = _both(np.asarray([[0, 0], [0, 1]]), np.asarray([4097, 1]),
                      np.ones(2, np.int64), (1, 2))
    msg = np.asarray([4097, 1])
    got = engine.maybe_dense_message(phi, "V", msg, device="cpu")
    assert int(got[0]) == 16_785_410 == int(numpy_message(phi, "V", msg)[0])
    assert int(engine_jax.maybe_dense_message(
        rphi, "V", msg, interpret=True)[0]) == 16_785_408


@pytest.mark.parametrize("case", ["three-vars", "child-absent",
                                  "off-budget", "value-2^24",
                                  "message-2^24"])
def test_declines_match_reference(case):
    """The reference's four decline conditions: both packages return None."""
    keys = np.asarray([[0, 1], [2, 3]])
    one = np.ones(2, np.int64)
    sizes, child, msg = (4, 4), "V", np.ones(4, np.int64)
    bucket, vars = one, ("P", "V")
    if case == "three-vars":
        keys, vars, sizes = np.asarray([[0, 1, 0], [2, 3, 1]]), \
            ("P", "V", "W"), (4, 4, 2)
    elif case == "child-absent":
        child = "W"
    elif case == "off-budget":
        sizes, msg = (1 << 12, (1 << 10) + 1), np.ones((1 << 10) + 1,
                                                       np.int64)
    elif case == "value-2^24":
        bucket = np.asarray([1, 1 << 24])
    else:
        msg = np.asarray([0, 0, 0, 1 << 24])
    phi, rphi = _both(keys, bucket, one, sizes, vars)
    assert engine_jax.maybe_dense_message(rphi, child, msg,
                                          interpret=True) is None
    assert engine.maybe_dense_message(phi, child, msg, device="cpu") is None


def test_budget_edge_is_taken():
    """P * V == DENSE_BUDGET is dense in both packages."""
    assert engine.DENSE_BUDGET == engine_jax.DENSE_BUDGET
    keys = np.asarray([[0, 0], [(1 << 11) - 1, (1 << 11) - 1]])
    phi, rphi = _both(keys, np.asarray([3, 5]), np.ones(2, np.int64),
                      (1 << 11, 1 << 11))
    msg = np.arange(1 << 11, dtype=np.int64)
    got = engine.maybe_dense_message(phi, "V", msg, device="cpu")
    np.testing.assert_array_equal(got, engine_jax.maybe_dense_message(
        rphi, "V", msg, interpret=True))
    assert int(got[-1]) == 5 * ((1 << 11) - 1)


@pytest.mark.parametrize("bad", ["length", "float", "below-int32"])
def test_maybe_dense_message_rejects_what_the_kernel_cannot_take(bad):
    phi = Factor(("P", "V"), np.asarray([[0, 0]]), np.ones(1, np.int64),
                 np.ones(1, np.int64), (2, 3))
    msg = {"length": np.ones(4, np.int64), "float": np.ones(3),
           "below-int32": np.asarray([-(1 << 31) - 1, 0, 0])}[bad]
    with pytest.raises(ValueError):
        engine.maybe_dense_message(phi, "V", msg, device="cpu")
