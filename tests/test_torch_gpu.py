"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: run on a machine with an NVIDIA card by
``pytest -m gpu tests/test_torch_gpu.py``.  Without a card each test skips
with its reason; whether a card is present is decided inside the test, so
every pytest worker collects the same tests.  Exact comparisons, except
``mul_segsum`` on non-integral float64 values (``rtol=1e-12``: the kernel
adds in tile order, the plain version in another).  ``expand_gather``'s
float payloads compare bit for bit; ``dense_message``'s float cases are
sums of integers below 2^24, exact in f32 and in the plain version's f64.
"""

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import engine
from repro_torch.core.potentials import Factor
from repro_torch.kernels import ops
from repro_torch.kernels.dense_message import dense_message
from repro_torch.kernels.expand_gather import expand_gather
from repro_torch.kernels.expand_many import expand_many
from repro_torch.kernels.mul_segsum import mul_segsum
from repro_torch.kernels.ref import (dense_message_ref, expand_gather_ref,
                                     expand_many_ref, mul_segsum_ref,
                                     run_boundaries_ref)
from repro_torch.kernels.run_boundaries import run_boundaries
from repro_torch.relational.synth import figure1, lastfm_like
from repro_torch.summary.algebra import SummaryFrame

from torch_cases import (boundaries_cases, bounds_of, dense_cases,
                         dense_oracle, expand_cases, gather_cases,
                         numpy_message, repeat_oracle, segsum_cases)

pytestmark = pytest.mark.gpu

CASES = expand_cases()
SEGSUM = segsum_cases()
BOUNDARIES = boundaries_cases()
GATHER = gather_cases()
DENSE = dense_cases()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(CASES))
def test_expand_many_kernel_matches_plain_version(name):
    dev = _card()
    payloads, freqs = CASES[name]
    bounds, total = bounds_of(freqs)
    p_t = torch.from_numpy(payloads).to(dev)
    b_t = torch.from_numpy(bounds).to(dev)
    launches = expand_many.launches
    got = expand_many(p_t, b_t, total)
    torch.cuda.synchronize()
    launched = int(total > 0 and payloads.shape[0] > 0)
    assert expand_many.launches == launches + launched
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert torch.equal(got, expand_many_ref(p_t, b_t, total))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  repeat_oracle(payloads, freqs))


def test_expand_many_kernel_output_past_2_31_elements():
    """K * total > 2**31: the output offsets must be 64-bit."""
    dev = _card()
    k, runs, total = 3, 1000, (1 << 30) - 7
    gen = torch.Generator(device=dev).manual_seed(0)
    cuts = torch.randint(0, total, (runs - 1,), device=dev, generator=gen,
                         dtype=torch.int64)
    bounds = torch.cat([cuts.sort().values,
                        torch.tensor([total], device=dev)]).to(torch.int32)
    payloads = torch.randint(0, 1 << 30, (k, runs), device=dev,
                             generator=gen, dtype=torch.int32)
    got = expand_many(payloads, bounds, total)
    idx = torch.searchsorted(bounds, torch.tensor(
        [0, total // 2, total - 1], device=dev, dtype=torch.int32),
        right=True)
    for q in range(k):
        for j, t in enumerate((0, total // 2, total - 1)):
            assert int(got[q, t]) == int(payloads[q, idx[j]])
    assert torch.equal(got[k - 1], expand_many_ref(
        payloads[k - 1:], bounds, total)[0])


@pytest.mark.parametrize("name", sorted(SEGSUM))
def test_mul_segsum_kernel_matches_plain_version(name):
    dev = _card()
    seg, x, y, s = SEGSUM[name]
    args = [torch.from_numpy(a).to(dev) for a in (seg, x, y)]
    launches = mul_segsum.launches
    got = mul_segsum(*args, s)
    torch.cuda.synchronize()
    assert mul_segsum.launches == launches + int(len(seg) > 0)
    want = mul_segsum_ref(*args, s)
    assert got.dtype == want.dtype and got.shape == (s,)
    if name == "f64":
        torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-9)
        assert torch.equal(got, mul_segsum(*args, s))  # no atomics
    else:
        assert torch.equal(got, want)
    if got.dtype == torch.int64:
        oracle = np.zeros(s, np.int64)
        np.add.at(oracle, seg, x.astype(np.int64) * y.astype(np.int64))
        np.testing.assert_array_equal(got.cpu().numpy(), oracle)


@pytest.mark.parametrize("name", sorted(BOUNDARIES))
def test_run_boundaries_kernel_matches_plain_version(name):
    dev = _card()
    keys = torch.from_numpy(BOUNDARIES[name]).to(dev)
    launches = run_boundaries.launches
    got = run_boundaries(keys)
    torch.cuda.synchronize()
    assert run_boundaries.launches == launches + int(keys.numel() > 0)
    assert got.dtype == torch.int32
    assert torch.equal(got, run_boundaries_ref(keys))


def test_group_by_count_and_build_factor_on_the_card():
    dev = _card()
    rng = np.random.default_rng(3)
    keys = np.sort(rng.integers(0, 5000, 300000)).astype(np.int32)
    seg, counts, num = ops.group_by_count(torch.from_numpy(keys).to(dev))
    uniq, want = np.unique(keys, return_counts=True)
    assert num == len(uniq)
    np.testing.assert_array_equal(counts.cpu().numpy(), want)
    cols = {"A": rng.integers(0, 300, 200000),
            "B": rng.integers(0, 7000, 200000)}
    sizes = {"A": 300, "B": 7000}
    a = engine.build_factor(cols, sizes, device=dev)
    b = engine.build_factor(cols, sizes, device="cpu")
    np.testing.assert_array_equal(a.keys, b.keys)
    np.testing.assert_array_equal(a.bucket, b.bucket)


def _same(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, float) or np.asarray(a).dtype.kind == "f":
        np.testing.assert_allclose(a, b, rtol=1e-12)
    else:
        np.testing.assert_array_equal(a, b)


def test_aggregate_on_the_card_equals_the_cpu_figure1():
    dev = _card()
    cat, q = figure1()
    gpu = repro_torch.GraphicalJoin(cat, q, device=dev)
    cpu = repro_torch.GraphicalJoin(cat, q, device="cpu")
    g = gpu.run()
    launches = mul_segsum.launches
    for args, kw in ((("count",), dict(by=["A"])), (("count",), {}),
                     (("count",), dict(by=["B", "C"],
                                       where={"C": ["c3", "c4"]})),
                     (("count_distinct", "D"), dict(where={"B": "b4"}))):
        _same(gpu.aggregate(*args, gfjs=g, **kw),
              cpu.aggregate(*args, gfjs=g, **kw))
    assert mul_segsum.launches > launches


def test_aggregate_on_the_card_device_sort_route(monkeypatch):
    dev = _card()
    cat, qs = lastfm_like(n_users=300, n_artists=400, artists_per_user=8,
                          friends_per_user=4)
    gj = repro_torch.GraphicalJoin(cat, qs["lastfm_A1"], device=dev)
    g = gj.run()
    cpu = SummaryFrame.of(g, device="cpu")
    gpu = SummaryFrame.of(g, device=dev)
    monkeypatch.setattr(engine, "GROUP_DEVICE_MIN_RUNS", 0)
    launches = run_boundaries.launches
    aggs = dict(n="count", s=("sum", "U2"), avg=("mean", "U2"))
    _same(gpu.group_by(["U1", "A2"], **aggs),
          cpu.group_by(["U1", "A2"], **aggs))
    assert run_boundaries.launches > launches
    user = int(cpu.group_by("U1")["U1"][0])
    _same(gpu.filter(U1=user).group_by("A2", **aggs),
          cpu.filter(U1=user).group_by("A2", **aggs))
    _same(gpu.sum("U2"), cpu.sum("U2"))


@pytest.mark.parametrize("name", sorted(GATHER))
def test_expand_gather_kernel_matches_plain_version(name):
    dev = _card()
    payload, freqs = GATHER[name]
    bounds, total = bounds_of(freqs)
    p_t = torch.from_numpy(payload).to(dev)
    b_t = torch.from_numpy(bounds).to(dev)
    launches = expand_gather.launches
    got = expand_gather(p_t, b_t, total)
    torch.cuda.synchronize()
    assert expand_gather.launches == launches + int(total > 0)
    assert got.dtype == p_t.dtype and got.shape == (total,)
    bits = got.view(torch.int32)
    assert torch.equal(bits, expand_gather_ref(p_t, b_t, total)
                       .view(torch.int32))
    want = np.repeat(payload, freqs)
    np.testing.assert_array_equal(bits.cpu().numpy(),
                                  want.view(np.int32) if
                                  want.dtype == np.float32 else want)


@pytest.mark.parametrize("name", sorted(DENSE))
def test_dense_message_kernel_matches_plain_version(name):
    dev = _card()
    phi, m = DENSE[name]
    phi_t, m_t = torch.from_numpy(phi).to(dev), torch.from_numpy(m).to(dev)
    launches = dense_message.launches
    got = dense_message(phi_t, m_t)
    torch.cuda.synchronize()
    assert dense_message.launches == launches + int(min(phi.shape + m.shape)
                                                    > 0)
    want = dense_message_ref(phi_t, m_t)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.cpu().numpy(), dense_oracle(phi, m))


def test_dense_message_kernel_non_contiguous_inputs():
    dev = _card()
    phi, m = DENSE["counts-65x1025x63"]
    phi_t = torch.from_numpy(phi).to(dev)
    m_t = torch.from_numpy(np.ascontiguousarray(m.T)).to(dev).T
    assert not m_t.is_contiguous()
    assert torch.equal(dense_message(phi_t, m_t), dense_message_ref(phi_t,
                                                                    m_t))


def test_maybe_dense_message_on_the_card_equals_the_cpu():
    dev = _card()
    cat, _ = lastfm_like(n_users=1892, n_artists=400, artists_per_user=8,
                         friends_per_user=7)
    uf, ua = cat["user_friends"], cat["user_artists"]
    phi = Factor.from_columns({"U1": uf.columns["userID"],
                               "U2": uf.columns["friendID"]},
                              {"U1": 1892, "U2": 1892})
    msg = np.bincount(ua.columns["userID"], minlength=1892).astype(np.int64)
    launches = dense_message.launches
    got = engine.maybe_dense_message(phi, "U2", msg, device=dev)
    assert dense_message.launches == launches + 1
    np.testing.assert_array_equal(
        got, engine.maybe_dense_message(phi, "U2", msg, device="cpu"))
    np.testing.assert_array_equal(got, numpy_message(phi, "U2", msg))


def test_desummarize_twice_on_the_card_reuses_the_bounds():
    dev = _card()
    cat, qs = lastfm_like(n_users=300, n_artists=400, artists_per_user=8,
                          friends_per_user=4)
    gj = repro_torch.GraphicalJoin(cat, qs["lastfm_A1"], device=dev)
    g = gj.run()
    first = gj.desummarize(g, decode=False)
    entries = dict(g._launch)
    assert len(entries) == len(g.levels)
    assert all(e[1][0].device.type == "cuda" for e in entries.values())
    second = gj.desummarize(g, decode=False)
    assert all(g._launch[lv] is e for lv, e in entries.items())
    for v in first:
        assert torch.equal(first[v], second[v])
    lvl = next(i for i, lv in enumerate(g.levels) if "A2" in lv.vars)
    payload = torch.from_numpy(g.levels[lvl].key_cols["A2"]
                               .astype(np.int32)).to(dev)
    launches = expand_gather.launches
    col = ops.rle_expand(payload, None, g.join_size,
                         meta=ops.gfjs_expand_meta(g, lvl, dev))
    assert expand_gather.launches == launches + 1
    assert torch.equal(col, first["A2"])
