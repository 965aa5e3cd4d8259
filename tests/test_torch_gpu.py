"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: run on a machine with an NVIDIA card by
``pytest -m gpu tests/test_torch_gpu.py``.  Without a card each test skips
with its reason; whether a card is present is decided inside the test, so
every pytest worker collects the same tests.  Exact comparisons, except
``mul_segsum`` on non-integral float64 values (``rtol=1e-12``: the kernel
adds in tile order, the plain version in another).  ``expand_gather``'s
float payloads compare bit for bit; ``dense_message``'s float cases are
sums of integers below 2^24, exact in f32 and in the plain version's f64.
Both ``dense_message`` kernels (thin K and tiled) are held to the same
oracles.
"""

import json

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import engine
from repro_torch.core.gfjs import desummarize as np_desummarize
from repro_torch.core.potentials import Factor
from repro_torch.kernels import ops
from repro_torch.kernels.dense_message import (THIN_K, THIN_MAX_K,
                                               dense_message, v_split)
from repro_torch.kernels.expand_gather import expand_gather
from repro_torch.kernels.expand_many import expand_many
from repro_torch.kernels.mul_segsum import mul_segsum
from repro_torch.kernels.ref import (dense_message_ref, expand_gather_ref,
                                     expand_many_ref, mul_segsum_ref,
                                     run_boundaries_ref)
from repro_torch.kernels.run_boundaries import run_boundaries
from repro_torch.obs.trace import Tracer
from repro_torch.relational.synth import figure1, lastfm_like
from repro_torch.summary.algebra import SummaryFrame

from torch_cases import (assert_gfjs_equal, boundaries_cases, bounds_of,
                         dense_cases,
                         dense_oracle, dense_tensors, expand_cases,
                         gather_cases, level_gfjs, memo_free, numpy_message,
                         repeat_oracle, segsum_cases, spans_bytes,
                         zero_run_identity_gfjs)
import torch_threads  # noqa: F401

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


def test_expand_many_kernel_total_past_the_last_bound_is_clamped():
    """Outside the callers' contract, as the plain version's clamp: the
    outputs past the last bound take the last run, zero-length or not."""
    dev = _card()
    payloads = torch.arange(8, dtype=torch.int32, device=dev).view(2, 4)
    for freqs in ([2, 1, 3, 0], [3, 0, 0, 0], [1, 2, 3, 4]):
        bounds = torch.tensor(np.cumsum(freqs), dtype=torch.int32,
                              device=dev)
        total = int(bounds[-1]) + 5
        assert torch.equal(expand_many(payloads, bounds, total),
                           expand_many_ref(payloads, bounds, total))


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
    phi_t, m_t = dense_tensors(name, phi, m, dev)
    launches = dense_message.launches
    thin = dense_message.thin_launches
    got = dense_message(phi_t, m_t)
    torch.cuda.synchronize()
    launched = int(min(phi.shape + m.shape) > 0)
    assert dense_message.launches == launches + launched
    assert dense_message.thin_launches == thin + launched * int(
        m.shape[1] <= THIN_K)
    want = dense_message_ref(phi_t, m_t)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.cpu().numpy(), dense_oracle(phi, m))


@pytest.mark.parametrize("k", sorted({1, 2, THIN_K, THIN_K + 1, 64}))
def test_dense_message_takes_the_thin_kernel_up_to_thin_k(k):
    dev = _card()
    rng = np.random.default_rng(k)
    phi = rng.integers(0, 90, (100, 1892)).astype(np.int32)
    m = rng.integers(0, 90, (1892, k)).astype(np.int32)
    launches, thin = dense_message.launches, dense_message.thin_launches
    got = dense_message(torch.from_numpy(phi).to(dev),
                        torch.from_numpy(m).to(dev))
    assert dense_message.launches == launches + 1
    assert dense_message.thin_launches == thin + int(k <= THIN_K)
    np.testing.assert_array_equal(got.cpu().numpy(), dense_oracle(phi, m))


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8, 9, 16, 17, 32, 33, 64])
@pytest.mark.parametrize("dtype", ["counts", "float"])
def test_dense_message_thin_kernel_every_width(k, dtype):
    """The thin kernel forced at every instantiation (K rounded up to a
    power of two), and the tiled kernel forced at the same inputs."""
    dev = _card()
    rng = np.random.default_rng(k)
    dt = np.int32 if dtype == "counts" else np.float32
    phi = rng.integers(0, 90, (70, 1891)).astype(dt)
    m = rng.integers(0, 90, (1891, k)).astype(dt)
    phi_t, m_t = torch.from_numpy(phi).to(dev), torch.from_numpy(m).to(dev)
    thin = dense_message.thin_launches
    want = dense_oracle(phi, m)
    np.testing.assert_array_equal(
        dense_message(phi_t, m_t, _thin_k=THIN_MAX_K).cpu().numpy(), want)
    assert dense_message.thin_launches == thin + 1
    np.testing.assert_array_equal(
        dense_message(phi_t, m_t, _thin_k=0).cpu().numpy(), want)
    assert dense_message.thin_launches == thin + 1


@pytest.mark.parametrize("p,v,k", [(1, 5000, 1), (7, 70_001, 3),
                                   (500, 4099, 2), (1, (1 << 20) + 3, 1)])
def test_dense_message_thin_kernel_splits_v(p, v, k):
    """Fewer rows than the card has warps to fill: V is cut over blocks and
    the splits summed by the second pass, the same on every run."""
    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert v_split(p, v, sms)[0] > 1
    rng = np.random.default_rng(p + v)
    for dt in (np.int32, np.float32):
        phi = rng.integers(0, 4, (p, v)).astype(dt)
        m = rng.integers(0, 4, (v, k)).astype(dt)
        phi_t, m_t = torch.from_numpy(phi).to(dev), torch.from_numpy(m).to(dev)
        got = dense_message(phi_t, m_t)
        np.testing.assert_array_equal(got.cpu().numpy(), dense_oracle(phi, m))
        assert torch.equal(got, dense_message(phi_t, m_t))


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
    launches, thin = dense_message.launches, dense_message.thin_launches
    got = engine.maybe_dense_message(phi, "U2", msg, device=dev)
    assert dense_message.launches == launches + 1
    assert dense_message.thin_launches == thin + 1      # K = 1: thin
    np.testing.assert_array_equal(
        got, engine.maybe_dense_message(phi, "U2", msg, device="cpu"))
    np.testing.assert_array_equal(got, numpy_message(phi, "U2", msg))


def _a1_on_card(dev):
    cat, qs = lastfm_like(n_users=300, n_artists=400, artists_per_user=8,
                          friends_per_user=4)
    tr = Tracer()
    gj = repro_torch.GraphicalJoin(cat, qs["lastfm_A1"], device=dev,
                                   tracer=tr)
    return gj, gj.run(), tr


def test_desummarize_twice_on_the_card_reuses_the_bounds():
    dev = _card()
    gj, g, _ = _a1_on_card(dev)
    entries = dict(g._launch)
    assert len(entries) == len(g.levels)
    assert all(e[1][1].device.type == "cuda" and (
        e[1][0] is None or e[1][0].device.type == "cuda")
        for e in entries.values())
    first = gj.desummarize(g, decode=False)
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


def test_desummarize_after_run_on_the_card_uploads_nothing():
    dev = _card()
    gj, g, tr = _a1_on_card(dev)
    for li, lvl in enumerate(g.levels):
        _, codes = g._launch[li][1]
        for k, v in enumerate(lvl.vars):
            np.testing.assert_array_equal(codes[k].cpu().numpy(),
                                          lvl.key_cols[v])
    since = len(tr.spans)
    launches = expand_many.launches
    cols = gj.desummarize(g, decode=False)
    torch.cuda.synchronize()
    assert spans_bytes(tr, "engine:upload", since) == (0, 0)
    assert not g._bounds
    identity = sum(e[1][0] is None for e in g._launch.values())
    assert identity == 1
    assert expand_many.launches == launches + len(g.levels) - identity
    want = np_desummarize(g, decode=False)
    for v in g.column_order:
        np.testing.assert_array_equal(cols[v].cpu().numpy(), want[v])


@pytest.mark.parametrize("stage", [None, 1 << 12])
def test_run_on_the_card_downloads_no_level_until_its_first_read(
        monkeypatch, stage):
    """run() and desummarize(decode=False) download no level: every
    download they make lies outside ``phase:summarize``.  The first host
    read of each generated level downloads its int32 codes and bounds
    once, equal to the numpy route, and adds at most one STAGE_BYTES chunk
    to the card's peak (the bounds' difference is taken on the host).
    ``stage`` = 4 KB sends each level through the staging buffers."""
    from repro_torch.obs.metrics import REGISTRY
    dev = _card()
    if stage is not None:
        monkeypatch.setattr(engine, "STAGE_BYTES", stage)
    fetches = REGISTRY.counter("engine.mirror_fetches")
    before = fetches.value
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    gj, g, tr = _a1_on_card(dev)
    cols = gj.desummarize(g, decode=False)
    torch.cuda.synchronize(dev)
    assert fetches.value == before
    spans = {s.span_id: s for s in tr.spans}

    def in_summarize(s):
        while s is not None:
            if s.name == "phase:summarize":
                return True
            s = spans.get(s.parent_id)
        return False

    assert not any(in_summarize(s) for s in tr.find("engine:download"))
    peak, held = (torch.cuda.max_memory_allocated(dev),
                  torch.cuda.memory_allocated(dev))
    since = len(tr.spans)
    with tr.span("read"):
        for lvl in g.levels[1:]:
            lvl.freq
    torch.cuda.synchronize(dev)
    assert fetches.value == before + len(g.levels) - 1
    assert torch.cuda.max_memory_allocated(dev) <= peak + engine.STAGE_BYTES
    assert torch.cuda.memory_allocated(dev) <= held
    ranged = [g._launch[li][1][0] is not None
              for li in range(1, len(g.levels))]
    n, nbytes = spans_bytes(tr, "engine:download", since)
    assert n == sum(len(lvl.vars) + r for lvl, r in zip(g.levels[1:], ranged))
    assert nbytes == sum(lvl.num_runs * 4 * (len(lvl.vars) + r)
                         for lvl, r in zip(g.levels[1:], ranged))
    cat, qs = lastfm_like(n_users=300, n_artists=400, artists_per_user=8,
                          friends_per_user=4)
    want = repro_torch.GraphicalJoin(cat, qs["lastfm_A1"], device="cpu",
                                     generation_backend="numpy").run()
    assert_gfjs_equal(g, want)
    assert fetches.value == before + len(g.levels) - 1
    del cols


def test_memo_free_copy_on_the_card_equals_the_memoized_path():
    dev = _card()
    gj, g, tr = _a1_on_card(dev)
    memoized = gj.desummarize(g, decode=False)
    copy = memo_free(g)
    since = len(tr.spans)
    got = gj.desummarize(copy, decode=False)
    assert spans_bytes(tr, "engine:upload", since)[0] == len(g.levels)
    assert not copy._bounds and copy.aux_nbytes() == g.aux_nbytes()
    since = len(tr.spans)
    again = gj.desummarize(copy, decode=False)
    assert spans_bytes(tr, "engine:upload", since) == (0, 0)
    for v in g.column_order:
        assert torch.equal(got[v], memoized[v])
        assert torch.equal(again[v], memoized[v])


@pytest.mark.parametrize("name", sorted(CASES))
def test_memo_free_level_on_the_card_matches_repeat(name):
    dev = _card()
    payloads, freqs = CASES[name]
    g = level_gfjs(payloads, freqs)
    first = engine.desummarize(g, device=dev)
    second = engine.desummarize(g, device=dev)
    want = repeat_oracle(payloads, freqs)
    for k, v in enumerate(g.column_order):
        np.testing.assert_array_equal(first[v].cpu().numpy(), want[k])
        assert torch.equal(first[v], second[v])


def test_identity_level_on_the_card_is_a_copy():
    dev = _card()
    gj, g, _ = _a1_on_card(dev)
    last = len(g.levels) - 1
    bounds, codes = g._launch[last][1]
    assert bounds is None
    v = g.levels[last].vars[0]
    cols = gj.desummarize(g, decode=False)
    want = cols[v].clone()
    assert cols[v].data_ptr() != codes.data_ptr()
    cols[v].fill_(-1)
    again = gj.desummarize(g, decode=False)
    assert torch.equal(again[v], want)
    np.testing.assert_array_equal(again[v].cpu().numpy(),
                                  g.levels[last].key_cols[v])


@pytest.mark.parametrize("chunks", [-1, 0, 2, 5])
@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_staged_download_equals_a_pageable_copy(chunks, dtype):
    """Below STAGE_BYTES one pageable copy, from it on the pinned staging
    buffers (whole chunks and a ragged tail); int32 widens to int64 on the
    host, int64 stays."""
    dev = _card()
    dt = getattr(torch, dtype)
    chunk = engine.STAGE_BYTES // dt.itemsize
    n = {-1: chunk - 1, 0: chunk}.get(chunks, chunks * chunk + 5)
    t = torch.randint(-(1 << 30), 1 << 30, (n,), device=dev, dtype=dt)
    got = engine._download(t, np.int64)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, t.cpu().numpy())
    same = engine._download(t)
    assert same.dtype == t.cpu().numpy().dtype
    np.testing.assert_array_equal(same, t.cpu().numpy())


def test_staged_download_spans_and_the_profilers_clock(tmp_path):
    """Traced, a download of 4 chunks holds one ``ready`` span, then a
    ``d2h`` and a ``host`` span per chunk, whose bytes sum to the
    download's.  Each ``device=True`` span, placed on the profiler's clock
    through one anchor (as ``gjbench/devtrace.py`` places host spans),
    lies within 1 ms of the profiler's own event of its name."""
    from torch.profiler import ProfilerActivity, profile, record_function
    dev = _card()
    chunk = engine.STAGE_BYTES // 4
    n = 3 * chunk + 12345
    t = torch.randint(-(1 << 30), 1 << 30, (n,), device=dev,
                      dtype=torch.int32)
    tr = Tracer()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("test:anchor"):
            host_t0 = tr.clock()
            with tr.span("root"):
                got = engine._download(t, np.int64)
    np.testing.assert_array_equal(got, t.cpu().numpy())
    (dl,) = [s for s in tr.spans if s.name == "engine:download"]
    kids = {}
    for s in sorted(tr.spans, key=lambda s: s.t0):
        if s.parent_id == dl.span_id:
            kids.setdefault(s.name.rsplit(":", 1)[1], []).append(s)
    assert len(kids["ready"]) == 1
    assert len(kids["d2h"]) == len(kids["host"]) == 4
    assert sum(s.args["bytes"] for s in kids["host"]) == dl.args["bytes"] \
        == 4 * n
    assert kids["ready"][0].t1 <= kids["d2h"][0].t0

    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    (anchor,) = [e for e in events if e["name"] == "test:anchor"]
    for name in ("engine:download:ready", "engine:download:d2h"):
        spans = [s for s in tr.spans if s.name == name]
        marks = sorted(float(e["ts"]) for e in events if e["name"] == name)
        assert len(marks) == len(spans)
        for s, ts in zip(sorted(spans, key=lambda s: s.t0), marks):
            placed = float(anchor["ts"]) + (s.t0 - host_t0) * 1e6
            assert abs(placed - ts) < 1000.0, (name, placed - ts)


def test_zero_length_run_level_on_the_card_goes_through_the_kernel():
    dev = _card()
    g = zero_run_identity_gfjs()
    launches = expand_many.launches
    cols = engine.desummarize(g, device=dev)
    torch.cuda.synchronize()
    assert expand_many.launches == launches + 2
    assert cols["B"].cpu().tolist() == [5, 5, 7]


def test_mul_segsum_on_the_card_rejects_int64_ids_past_int32():
    """2^32 + 3 would wrap onto segment 3 in the kernel's int32 ids."""
    dev = _card()
    seg = torch.tensor([0, 1, 2, (1 << 32) + 3], dtype=torch.int64,
                       device=dev)
    x = torch.ones(4, dtype=torch.int64, device=dev)
    launches = mul_segsum.launches
    with pytest.raises(ValueError, match="outside"):
        mul_segsum(seg, x, x, 4)
    assert mul_segsum.launches == launches
    ok = mul_segsum(seg.clamp(max=3), x, x, 4)
    assert ok.tolist() == [1, 1, 1, 1]


# -- the serving path on the card ---------------------------------------------

SERVE_LASTFM = dict(n_users=300, n_artists=400, artists_per_user=8,
                    friends_per_user=4, seed=0)


def _answers(svc, q):
    small = {"U2": lambda u: u < 100}
    return [svc.count(q), svc.count(q, where=small), svc.sum(q, "A2"),
            svc.mean(q, "A2"), svc.min(q, "A1"), svc.max(q, "U1"),
            svc.distinct(q, "A1"),
            svc.group_by(q, "U1", n="count", total=("sum", "A2")),
            svc.group_by(q, ["U1", "U2"], where=small, m=("mean", "A1"))]


def _assert_same(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_same(a[k], b[k])
        return
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f":
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    else:
        np.testing.assert_array_equal(a, b)


def _memo_bytes(gfjs):
    return sum(int(t.nbytes) for _, meta in gfjs._launch.values()
               for t in meta if t is not None)


@pytest.mark.parametrize("incremental", [True, False])
def test_service_on_the_card_answers_as_on_the_cpu(incremental):
    from repro_torch.relational.table import Catalog
    from repro_torch.summary import JoinService
    dev = _card()
    cat, qs = lastfm_like(**SERVE_LASTFM)
    q = qs["lastfm_A1"]
    card = JoinService(cat, incremental=incremental, device="cuda")
    # its own catalog: an append upgrades the catalog it is given
    host = JoinService(Catalog(dict(cat.tables)), incremental=incremental,
                       device="cpu")
    first = card.frame(q)
    assert first.source == "computed" and first.frame.device.type == "cuda"
    # traced builds generate on numpy; untraced ones on the card
    assert bool(first.frame.gfjs._launch) == (not incremental)
    counts = (mul_segsum.launches, run_boundaries.launches)
    for a, b in zip(_answers(card, q), _answers(host, q)):
        _assert_same(a, b)
    assert mul_segsum.launches > counts[0]
    assert card.frame(q).source == "memory"
    rows = {"userID": np.asarray([0, 5, 301], np.int64),
            "friendID": np.asarray([301, 7, 2], np.int64)}
    card.append("user_friends", dict(rows))
    host.append("user_friends", dict(rows))
    want = "refreshed" if incremental else "computed"
    assert card.frame(q).source == host.frame(q).source == want
    for a, b in zip(_answers(card, q), _answers(host, q)):
        _assert_same(a, b)
    torch.cuda.synchronize(dev)


def test_card_built_entry_charges_its_memo():
    from repro_torch.summary import JoinService
    dev = _card()
    cat, qs = lastfm_like(**SERVE_LASTFM)
    svc = JoinService(cat, incremental=False, device="cuda")
    gfjs = svc.frame(qs["lastfm_A1"]).frame.gfjs
    memo = _memo_bytes(gfjs)
    assert memo > 0
    assert all(d == torch.device("cuda", torch.cuda.current_device())
               for d, _ in gfjs._launch.values())
    assert all(t.device.type == dev.type for _, meta in gfjs._launch.values()
               for t in meta if t is not None)
    assert gfjs.aux_nbytes() >= memo
    assert gfjs.resident_nbytes() == gfjs.nbytes() + gfjs.aux_nbytes()
    assert svc.cache.resident_bytes == gfjs.resident_nbytes()


def test_eviction_invalidate_and_clear_free_the_memo_on_the_card(tmp_path):
    """Once an evicted entry's spill is written and no reply holds it, and
    after ``invalidate`` or ``clear``, the card's allocated bytes fall by
    at least the entry's memo."""
    import gc
    from repro_torch.summary import JoinService
    dev = _card()
    cat, qs = lastfm_like(**SERVE_LASTFM)
    a1, b = qs["lastfm_A1"], qs["lastfm_B"]
    svc = JoinService(cat, incremental=False, byte_budget=1024,
                      spill_dir=str(tmp_path), device="cuda")

    def freed(drop):
        gc.collect()
        torch.cuda.synchronize(dev)
        held = torch.cuda.memory_allocated(dev)
        drop()
        gc.collect()
        torch.cuda.synchronize(dev)
        return held - torch.cuda.memory_allocated(dev)

    reply = svc.frame(a1)
    aux = reply.frame.gfjs.aux_nbytes()
    other = svc.frame(b)                    # evicts A1; its spill is written
    assert svc.stats()["evictions"] == svc.stats()["spills"] == 1
    holder = [reply]
    del reply
    assert aux > 0 and freed(holder.clear) >= aux
    aux = other.frame.gfjs.aux_nbytes()
    del other
    assert aux > 0 and freed(lambda: svc.invalidate("user_friends")) >= aux
    assert svc.frame(a1).source == "computed"    # its spill went too
    svc.cache.clear()
    reply = svc.frame(b)
    aux = reply.frame.gfjs.aux_nbytes()
    del reply
    assert aux > 0 and freed(svc.cache.clear) >= aux


def test_threads_aggregating_one_cached_gfjs_match_serial():
    import threading
    from repro_torch.summary import JoinService
    from repro_torch.summary.algebra import SummaryFrame
    dev = _card()
    cat, qs = lastfm_like(**SERVE_LASTFM)
    q = qs["lastfm_A1"]
    svc = JoinService(cat, incremental=False, device="cuda")
    gfjs = svc.frame(q).frame.gfjs
    want = _answers(svc, q)
    host = [SummaryFrame.of(gfjs, "cpu").count()]
    outs, errors = [None] * 8, []

    def worker(i):
        try:
            outs[i] = _answers(svc, q)
            # lazily grown prefix sums and a desummarize on the memo, from
            # every thread at once
            cols = engine.desummarize(gfjs, decode=False, device=dev)
            outs[i].append(int(cols["A1"].shape[0]))
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errors, errors
    for out in outs:
        for a, b in zip(out, want):
            _assert_same(a, b)
        assert out[-1] == gfjs.join_size == host[0]


def test_leaders_of_two_cold_keys_race_through_the_staged_download(
        monkeypatch):
    """Two server leaders of different cold keys generate at once; a small
    STAGE_BYTES sends every level through the pinned staging buffers, so
    both downloads interleave on the shared pool.  Both summaries equal
    the numpy generation's, every time."""
    import threading
    from repro_torch.serve import JoinServer
    from repro_torch.summary import JoinService
    dev = _card()
    monkeypatch.setattr(engine, "STAGE_BYTES", 1 << 12)
    cat, qs = lastfm_like(**SERVE_LASTFM)
    names = ("lastfm_A1", "lastfm_B")
    want = {n: repro_torch.GraphicalJoin(cat, qs[n], device="cpu",
                                         generation_backend="numpy").run()
            for n in names}
    for _ in range(3):
        server = JoinServer(JoinService(cat, incremental=False,
                                        message_reuse=False, device="cuda"))
        barrier = threading.Barrier(2)
        got, errors = {}, []

        def lead(name):
            try:
                barrier.wait()
                got[name] = server.frame(qs[name])
            except Exception as e:  # pragma: no cover - reported below
                errors.append(e)

        ts = [threading.Thread(target=lead, args=(n,)) for n in names]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errors, errors
        for n in names:
            assert got[n].source == "computed"
            assert got[n].frame.gfjs._launch
            assert_gfjs_equal(got[n].frame.gfjs, want[n])
    torch.cuda.synchronize(dev)


# -- partitioned builds on the card -------------------------------------------

@pytest.mark.parametrize("partitions,fold", [(2, 1), (4, 1), (3, 2)])
def test_partitioned_build_on_the_card_equals_the_cpu(partitions, fold):
    dev = _card()
    cat, qs = lastfm_like(**SERVE_LASTFM)
    for name in ("lastfm_A1", "lastfm_A2"):
        card = repro_torch.GraphicalJoin(cat, qs[name], partitions=partitions,
                                         partition_fold=fold, device="cuda")
        host = repro_torch.GraphicalJoin(cat, qs[name], partitions=partitions,
                                         partition_fold=fold, device="cpu")
        launches = expand_many.launches
        got, want = card.run(), host.run()
        assert expand_many.launches > launches
        assert card.plan().signature() == host.plan().signature()
        assert got.shard_sizes() == want.shard_sizes()
        for a, b in zip(got.shards, want.shards):
            assert_gfjs_equal(a, b)
            assert all(t.device.type == "cuda" for _, meta in
                       a._launch.values() for t in meta if t is not None)
        cols = card.desummarize(got, decode=False)
        host_cols = host.desummarize(want, decode=False)
        assert list(cols) == list(host_cols)
        for v in cols:
            assert cols[v].device.type == "cuda"
            assert cols[v].dtype == torch.int32
            assert torch.equal(cols[v].cpu(), host_cols[v])
        values = card.desummarize(got)
        for v, col in np_desummarize(want, decode=True).items():
            np.testing.assert_array_equal(values[v], col)
    torch.cuda.synchronize(dev)


def test_sharded_desummarize_on_the_card_memo_free_copy():
    """A loaded (memo-free) sharded GFJS uploads each shard's levels once
    and expands equal to the memoized shards."""
    from repro_torch.core.gfjs import ShardedGFJS
    dev = _card()
    cat, qs = lastfm_like(**SERVE_LASTFM)
    gj = repro_torch.GraphicalJoin(cat, qs["lastfm_A1"], partitions=4,
                                   device="cuda")
    g = gj.run()
    copy = ShardedGFJS([memo_free(s) for s in g.shards], g.column_order,
                       g.join_size, g.domains, g.partition_var, g.salt)
    a = engine.desummarize_sharded(g, device=dev)
    b = engine.desummarize_sharded(copy, device=dev)
    for v in a:
        assert torch.equal(a[v], b[v])
    assert copy.aux_nbytes() == g.aux_nbytes()


def test_codes_past_int32_raise_on_the_card():
    """The kernel carries int32 codes only: on the card a level whose
    codes pass int32 raises, monolithic and sharded, and nothing is
    expanded on numpy or counted (the CPU device's numpy route is tested
    in tests/test_torch_engine.py and tests/test_torch_partition.py)."""
    from repro_torch.core.gfjs import ShardedGFJS
    from repro_torch.interop import gfjs_from_arrays
    from repro_torch.obs.metrics import REGISTRY
    dev = _card()
    fallbacks = REGISTRY.counter("engine.numpy_fallbacks")
    big = (1 << 31) + np.asarray([3, 7], np.int64)
    g = gfjs_from_arrays([(("A",), {"A": big}, np.asarray([2, 1], np.int64)),
                          (("B",), {"B": np.asarray([1, 0, 2])},
                           np.ones(3, np.int64))], ["A", "B"], 3, {})
    sharded = ShardedGFJS([g], ["A", "B"], 3, {}, "A")
    before = fallbacks.value
    with pytest.raises(ValueError, match="int32"):
        engine.desummarize(g, device=dev)
    with pytest.raises(ValueError, match="int32"):
        engine.desummarize_sharded(sharded, device=dev)
    assert fallbacks.value == before


@pytest.mark.parametrize("k", [1, 2, 3, 4, 7])
def test_partition_histogram_on_the_card_equals_numpy(k):
    from repro_torch.dist.partition import (hash_partition,
                                            hash_partition_device,
                                            partition_histogram)
    dev = _card()
    rng = np.random.default_rng(k)
    codes = np.concatenate([rng.integers(0, 1 << 31, 1 << 20),
                            [0, (1 << 31) - 1, (1 << 32) - 1, 1 << 40]])
    for salt in (0, 1, (1 << 32) - 1):
        want = hash_partition(codes, k, salt=salt)
        t = torch.from_numpy(codes).to(dev)
        got = hash_partition_device(t, k, salt=salt, device=dev)
        assert got.device.type == "cuda" and got.dtype == torch.int32
        np.testing.assert_array_equal(got.cpu().numpy(), want)
        hist = partition_histogram(t, k, salt=salt, device=dev)
        assert hist.device.type == "cuda"
        np.testing.assert_array_equal(hist.cpu().numpy(),
                                      np.bincount(want, minlength=k))


def test_concurrent_partitioned_builds_on_the_card_are_exact(monkeypatch):
    """Two partitioned builds from two threads, four shard threads each,
    every level through the staged download: all shards equal numpy's."""
    import threading
    dev = _card()
    monkeypatch.setattr(engine, "STAGE_BYTES", 1 << 12)
    cat, qs = lastfm_like(**SERVE_LASTFM)
    names = ("lastfm_A1", "lastfm_A2")
    want = {n: repro_torch.GraphicalJoin(
        cat, qs[n], partitions=4, device="cpu",
        generation_backend="numpy").run() for n in names}
    for _ in range(3):
        got, errors = {}, []
        barrier = threading.Barrier(2)

        def build(name):
            try:
                barrier.wait()
                g = repro_torch.GraphicalJoin(
                    cat, qs[name], partitions=4, device="cuda").run()
                for shard in g.shards:      # each first read downloads
                    for lvl in shard.levels:
                        lvl.freq
                got[name] = g
            except Exception as e:  # pragma: no cover - reported below
                errors.append(e)

        ts = [threading.Thread(target=build, args=(n,)) for n in names]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errors, errors
        for n in names:
            for a, b in zip(got[n].shards, want[n].shards):
                assert_gfjs_equal(a, b)
    torch.cuda.synchronize(dev)


def test_partitioned_service_invalidate_frees_the_shards_memos():
    import gc
    from repro_torch.core.gfjs import ShardedGFJS
    from repro_torch.summary import JoinService
    dev = _card()
    cat, qs = lastfm_like(**SERVE_LASTFM)
    q = qs["lastfm_A1"]
    svc = JoinService(cat, partitions=4, device="cuda")
    reply = svc.frame(q)
    assert reply.source == "computed"
    g = reply.frame.gfjs
    assert isinstance(g, ShardedGFJS)
    aux = g.aux_nbytes()
    assert aux == sum(_memo_bytes(s) for s in g.shards) > 0
    assert svc.frame(q).source == "memory"
    del reply, g
    gc.collect()
    torch.cuda.synchronize(dev)
    held = torch.cuda.memory_allocated(dev)
    svc.invalidate("user_friends")
    gc.collect()
    torch.cuda.synchronize(dev)
    assert held - torch.cuda.memory_allocated(dev) >= aux


# -- the LM serving path (the dense family) ----------------------------------

def _cpu_and_card_lm(arch, dev, **extra):
    """The smoke model in float32 on the CPU, and on the card with the
    same weights (one state dict)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import LM
    kw = dict(param_dtype="float32", compute_dtype="float32", **extra)
    cfg = get_smoke(arch).scaled(**kw)
    cpu = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = LM(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


@pytest.mark.parametrize("arch", ["qwen3_8b", "gemma3_4b",
                                  "granite_moe_1b_a400m", "deepseek_v2_236b",
                                  "zamba2_2p7b", "xlstm_350m"])
def test_lm_on_the_card_matches_the_cpu(arch):
    """Smoke phases 11, 12 and 14 (b) at smoke size: forward, prefill and
    decode logits to 1e-4, and 8 greedy tokens equal (the moe family at
    its configs' capacity, drops included)."""
    from repro_torch.serve import ServeConfig, ServeEngine
    dev = _card()
    cpu, card = _cpu_and_card_lm(arch, dev)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cpu.cfg.vocab, (3, 16)))
    with torch.inference_mode():
        np.testing.assert_allclose(card(toks.to(dev)).cpu().numpy(),
                                   cpu(toks).numpy(), atol=1e-4, rtol=1e-4)
        lc, cc = cpu.prefill(toks[:, :8], 16)
        lg, cg = card.prefill(toks[:, :8].to(dev), 16)
        for t in range(8, 12):
            np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(),
                                       atol=1e-4, rtol=1e-4)
            lc, cc = cpu.decode_step(toks[:, t:t + 1], cc)
            lg, cg = card.decode_step(toks[:, t:t + 1].to(dev), cg)
    want = ServeEngine(cpu, ServeConfig(max_seq=24), device="cpu").generate(
        {"tokens": toks}, 8)
    got = ServeEngine(card, ServeConfig(max_seq=24), device=dev).generate(
        {"tokens": toks}, 8)
    np.testing.assert_array_equal(got, want)


def test_prefill_decode_matches_forward_on_the_card():
    """Smoke phase 11 (a) at smoke size: stepwise decode logits equal the
    teacher-forced forward's, in both KV layouts, which agree."""
    from repro_torch.models.attention import GQAttention
    dev = _card()
    _, lm = _cpu_and_card_lm("qwen3_8b", dev, num_kv_heads=2)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, lm.cfg.vocab, (2, 16))).to(dev)
    runs = {}
    with torch.inference_mode():
        for layout in ("grouped", "repeat"):
            for m in lm.modules():
                if isinstance(m, GQAttention):
                    m.kv_layout = layout
            full = lm(toks)
            logits, caches = lm.prefill(toks[:, :8], 16)
            steps = [logits[:, 0]]
            for t in range(8, 15):
                logits, caches = lm.decode_step(toks[:, t:t + 1], caches)
                steps.append(logits[:, 0])
            got = torch.stack(steps, 1)
            torch.testing.assert_close(got, full[:, 7:15], atol=1e-4,
                                       rtol=1e-4)
            runs[layout] = (full, got)
    for a, b in zip(runs["grouped"], runs["repeat"]):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_lm_is_built_on_the_card():
    """Every parameter is allocated and drawn on the card: a host
    generator is refused, and a meta build initialised on the card equals
    a direct card build."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import LM
    dev = _card()
    cfg = get_smoke("gemma3_4b")
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    lm = LM(cfg, device=dev, generator=torch.Generator(dev).manual_seed(3))
    torch.cuda.synchronize(dev)
    assert all(p.is_cuda for p in lm.parameters())
    assert torch.cuda.memory_allocated(dev) - before >= lm.param_bytes()
    with pytest.raises(RuntimeError):
        LM(cfg, device=dev, generator=torch.Generator().manual_seed(3))
    lazy = LM(cfg, device="meta").to_empty(device=dev)
    lazy.init_weights(torch.Generator(dev).manual_seed(3))
    for (k, a), (_, b) in zip(lm.state_dict().items(),
                              lazy.state_dict().items()):
        assert torch.equal(a, b), k


def test_serve_engine_without_a_card_raises(monkeypatch):
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import LM
    from repro_torch.serve import ServeConfig, ServeEngine
    _card()
    cpu = LM(get_smoke("qwen3_8b"), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cpu, ServeConfig(max_seq=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(get_smoke("qwen3_8b"))


def test_join_fed_serving_on_the_card_equals_the_cpu():
    """JoinCorpus built on the card, batches as int32 on the card equal
    to the CPU's, and features from a card service equal the CPU's."""
    from repro_torch.data import JoinCorpus, TokenBatcher
    from repro_torch.serve import (RelationalFeatureProvider, ServeConfig,
                                   ServeEngine)
    from repro_torch.summary import JoinService
    dev = _card()
    cat, qs = lastfm_like(**SERVE_LASTFM)
    q = qs["lastfm_A1"]
    cpu_c = JoinCorpus.build(cat, q, vocab=256, device="cpu")
    card_c = JoinCorpus.build(cat, q, vocab=256, device=dev)
    a = TokenBatcher(cpu_c, 4, 63, device="cpu")
    b = TokenBatcher(card_c, 4, 63, device=dev)
    for _ in range(3):
        want, got = a.next_batch(), b.next_batch()
        assert got["tokens"].is_cuda and got["tokens"].dtype == torch.int32
        assert torch.equal(got["tokens"].cpu(), want["tokens"])
        assert torch.equal(got["labels"].cpu(), want["labels"])
    keys = np.arange(0, 320, 7)
    aggs = {"n_paths": "count"}
    on_card = RelationalFeatureProvider(JoinService(cat, device=dev), q,
                                        key_var="U1", aggs=aggs)
    on_cpu = RelationalFeatureProvider(JoinService(cat, device="cpu"), q,
                                       key_var="U1", aggs=aggs)
    np.testing.assert_array_equal(on_card.features(keys),
                                  on_cpu.features(keys))
    _, lm = _cpu_and_card_lm("qwen3_8b", dev)
    eng = ServeEngine(lm, ServeConfig(max_seq=72), feature_provider=on_card,
                      device=dev)
    batch = eng.attach_features(b.next_batch(), keys[:4])
    assert batch["features"].is_cuda
    assert eng.generate(batch, 8).shape == (4, 8)


# -- the moe family -----------------------------------------------------------

def _layer_on_cpu_and_card(cls, cfg, dev, seed):
    """A layer in float32 on the CPU with seeded weights (norm scales
    too), and on the card with the same weights."""
    gen = torch.Generator().manual_seed(seed)
    cpu = cls(cfg, device=torch.device("cpu"))
    with torch.no_grad():
        for p in cpu.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * p.shape[0] ** -0.5)
    card = cls(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


@pytest.mark.parametrize("cf", [0.01, 1.25])
@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m",
                                  "deepseek_v2_236b"])
def test_moe_block_on_the_card_matches_the_cpu(arch, cf):
    """Routes and drops agree: outputs to 1e-5, the top-k equal."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.models.moe import MoEBlock
    dev = _card()
    cfg = get_smoke(arch).scaled(param_dtype="float32",
                                 compute_dtype="float32")
    cfg = cfg.scaled(moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    cpu, card = _layer_on_cpu_and_card(MoEBlock, cfg, dev, 1)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(3, 16, cfg.d_model)).astype(np.float32))
    with torch.inference_mode():
        torch.testing.assert_close(card(x.to(dev)).cpu(), cpu(x),
                                   atol=1e-5, rtol=1e-5)
        xt = x.reshape(-1, cfg.d_model)
        assert torch.equal(card.route(xt.to(dev))[0].cpu(), cpu.route(xt)[0])


@pytest.mark.parametrize("q_lora", [0, 32])
def test_mla_on_the_card_matches_the_cpu(q_lora):
    """forward, prefill and absorbed decode steps to 1e-4."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.models.attention import MLAttention
    dev = _card()
    cfg = get_smoke("deepseek_v2_236b").scaled(param_dtype="float32",
                                               compute_dtype="float32")
    cfg = cfg.scaled(mla=dataclasses.replace(cfg.mla, q_lora_rank=q_lora))
    cpu, card = _layer_on_cpu_and_card(MLAttention, cfg, dev, 3)
    B, S, k = 2, 16, 10
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(B, S, cfg.d_model)).astype(np.float32))
    pos = torch.arange(S)[None].expand(B, S)
    tol = dict(atol=1e-4, rtol=1e-4)
    with torch.inference_mode():
        torch.testing.assert_close(card(x.to(dev), pos.to(dev)).cpu(),
                                   cpu(x, pos), **tol)
        cc, gc_ = cpu.init_cache(B, S), card.init_cache(B, S)
        yc, cc = cpu.prefill(x[:, :k], pos[:, :k], cc)
        yg, gc_ = card.prefill(x[:, :k].to(dev), pos[:, :k].to(dev), gc_)
        torch.testing.assert_close(yg.cpu(), yc, **tol)
        for t in range(k, S):
            yc, cc = cpu.decode(x[:, t:t + 1], cc)
            yg, gc_ = card.decode(x[:, t:t + 1].to(dev), gc_)
            torch.testing.assert_close(yg.cpu(), yc, **tol)
        torch.testing.assert_close(gc_.k.cpu(), cc.k, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["granite_moe_1b_a400m",
                                  "deepseek_v2_236b"])
def test_moe_lm_on_the_card_is_deterministic(arch, dtype):
    """Two card forwards, and two prefill + decode runs, bit-equal: the
    dispatch is an indexed copy and the combine a fixed-order sum."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import LM
    dev = _card()
    cfg = get_smoke(arch).scaled(param_dtype=dtype, compute_dtype=dtype)
    lm = LM(cfg, device=dev, generator=torch.Generator(dev).manual_seed(5))
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (4, 32))).to(dev)

    def run():
        logits, caches = lm.prefill(toks[:, :16], 32)
        out = [lm(toks), logits]
        for t in range(16, 24):
            logits, caches = lm.decode_step(toks[:, t:t + 1], caches)
            out.append(logits)
        return out

    with torch.inference_mode():
        a, b = run(), run()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# -- the recurrent families (zamba2, xlstm) ----------------------------------

@pytest.mark.parametrize("name", ["Mamba2Block", "MLSTMBlock", "SLSTMBlock"])
def test_recurrent_block_on_the_card_matches_the_cpu(name):
    """Forward (the chunked SSD in three chunks, the mLSTM in four), its
    final state and four decode steps, card against CPU to 1e-4."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import ssm, xlstm
    dev = _card()
    arch = "zamba2_2p7b" if name == "Mamba2Block" else "xlstm_350m"
    cfg = get_smoke(arch).scaled(param_dtype="float32",
                                 compute_dtype="float32")
    cls = getattr(ssm if name == "Mamba2Block" else xlstm, name)
    cpu, card = _layer_on_cpu_and_card(cls, cfg, dev, 3)
    kw = {"chunk": 8} if name == "MLSTMBlock" else {}
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 52, cfg.d_model)).astype(np.float32) * 0.5)
    tol = dict(atol=1e-4, rtol=1e-4)
    with torch.inference_mode():
        want, s_cpu = cpu(x[:, :48], return_state=True, **kw)
        got, s_card = card(x[:, :48].to(dev), return_state=True, **kw)
        torch.testing.assert_close(got.cpu(), want, **tol)
        for t in range(48, 52):
            torch.testing.assert_close(
                card.decode(x[:, t:t + 1].to(dev), s_card).cpu(),
                cpu.decode(x[:, t:t + 1], s_cpu), **tol)
    for f in vars(s_cpu):
        torch.testing.assert_close(getattr(s_card, f).cpu(),
                                   getattr(s_cpu, f), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["zamba2_2p7b", "xlstm_350m"])
def test_recurrent_lm_on_the_card_is_deterministic(arch, dtype):
    """Smoke phase 14 (b): two card forwards, and two prefill + decode
    runs, bit-equal."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import LM
    dev = _card()
    cfg = get_smoke(arch).scaled(param_dtype=dtype, compute_dtype=dtype)
    lm = LM(cfg, device=dev, generator=torch.Generator(dev).manual_seed(5))
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab, (4, 40))).to(dev)

    def run():
        logits, caches = lm.prefill(toks[:, :32], 40)
        out = [lm(toks[:, :32]), logits]
        for t in range(32, 40):
            logits, caches = lm.decode_step(toks[:, t:t + 1], caches)
            out.append(logits)
        return out

    with torch.inference_mode():
        a, b = run(), run()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_granite_is_built_on_the_card_at_full_size():
    """granite-moe-1b-a400m at full width and depth on the card: every
    parameter there, the count the config gives (vocab padded to 256),
    the routers float32."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import LM
    dev = _card()
    cfg = get_config("granite_moe_1b_a400m")
    lm = LM(cfg, device=dev, generator=torch.Generator(dev).manual_seed(7))
    d, L, H, KV, hd = (cfg.d_model, cfg.num_layers, cfg.num_heads,
                       cfg.num_kv_heads, cfg.head_dim_)
    E, f = cfg.moe.num_experts, cfg.moe.d_ff_expert
    per_layer = (2 * d + d * H * hd + 2 * d * KV * hd + H * hd * d
                 + d * E + 3 * E * d * f)
    want = lm.vocab_padded * d + d + L * per_layer
    assert sum(p.numel() for p in lm.parameters()) == want
    assert all(p.is_cuda for p in lm.parameters())
    routers = [p for n, p in lm.named_parameters() if n.endswith("router")]
    assert len(routers) == L
    assert all(p.dtype == torch.float32 for p in routers)
    toks = torch.zeros((2, 8), dtype=torch.int64, device=dev)
    with torch.inference_mode():
        assert torch.isfinite(lm(toks)[..., :cfg.vocab]).all()


# -- training and checkpoints (smoke phase 13 (a) and (b)) --------------------

def _rel_l2(got, want):
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-300))


def _train_batch(vocab, dev, seed=0, B=4, S=32):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, vocab, (B, S))).to(dev)
            for k in ("tokens", "labels")}


@pytest.mark.parametrize("arch", ["qwen3_8b", "granite_moe_1b_a400m",
                                  "zamba2_2p7b", "xlstm_350m"])
def test_training_on_the_card_matches_the_cpu(arch):
    """Smoke phases 13 (a) and 14 (d): the loss, every gradient and the
    parameters after two AdamW steps on the card against the CPU, each to
    1e-5 in the L2 norm (float32; granite drop-free, capacity factor
    64)."""
    from repro_torch.configs import get_smoke
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step)
    dev = _card()
    extra = {}
    if arch == "granite_moe_1b_a400m":
        import dataclasses
        extra["moe"] = dataclasses.replace(get_smoke(arch).moe,
                                           capacity_factor=64.0)
    cpu, card = _cpu_and_card_lm(arch, dev, **extra)
    batch = _train_batch(cpu.cfg.vocab, "cpu")
    cbatch = {k: v.to(dev) for k, v in batch.items()}
    out = []
    for lm, b in ((cpu, batch), (card, cbatch)):
        params = [p.requires_grad_(True) for p in lm.parameters()]
        loss = lm.loss(b)
        out.append((loss.detach(), torch.autograd.grad(loss, params)))
    assert _rel_l2(out[1][0], out[0][0]) <= 1e-5
    for g_card, g_cpu in zip(out[1][1], out[0][1]):
        assert _rel_l2(g_card, g_cpu) <= 1e-5
    states = []
    for lm, b in ((cpu, batch), (card, cbatch)):
        step, state = make_train_step(lm, AdamWConfig(warmup_steps=1)), \
            init_train_state(lm)
        for _ in range(2):
            state, _ = step(state, b)
        states.append(state)
    for name, p in states[0].params.items():
        assert _rel_l2(states[1].params[name], p) <= 1e-5, name


@pytest.mark.parametrize("arch", ["qwen3_8b", "granite_moe_1b_a400m"])
def test_training_on_the_card_is_deterministic(arch, monkeypatch):
    """Smoke phase 13 (a): two card runs of three steps from one seed are
    bit-equal under ``torch.use_deterministic_algorithms(True)`` (granite
    at its config's capacity, drops included)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import LM
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step)
    dev = _card()
    cfg = get_smoke(arch).scaled(param_dtype="float32",
                                 compute_dtype="float32")
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    runs = []
    torch.use_deterministic_algorithms(True)
    try:
        for _ in range(2):
            lm = LM(cfg, device=dev,
                    generator=torch.Generator(dev).manual_seed(8))
            step, state = make_train_step(lm, AdamWConfig()), \
                init_train_state(lm)
            for i in range(3):
                state, _ = step(state, _train_batch(cfg.vocab, dev, i))
            runs.append(state)
    finally:
        torch.use_deterministic_algorithms(False)
    a, b = runs
    for n in a.params:
        assert torch.equal(a.params[n], b.params[n]), n
        assert torch.equal(a.opt.m[n], b.opt.m[n]), n
        assert torch.equal(a.opt.v[n], b.opt.v[n]), n


def test_trainer_crash_and_resume_on_the_card_is_bit_exact(tmp_path,
                                                           monkeypatch):
    """Smoke phase 13 (b): ``Trainer`` on the card, fed by a corpus built
    on the card; a crash after step 6 (checkpoints every 4) and a resume
    equal an uninterrupted run bit for bit."""
    from repro_torch.configs import get_smoke
    from repro_torch.data import JoinCorpus, TokenBatcher
    from repro_torch.models.model import LM
    from repro_torch.train import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    dev = _card()
    cfg = get_smoke("qwen3_8b")
    cat, qs = lastfm_like(n_users=60, n_artists=50, artists_per_user=4,
                          friends_per_user=3)
    corpus = JoinCorpus.build(cat, qs["lastfm_A1"], vocab=cfg.vocab,
                              device=dev)

    def trainer(d, crash=None):
        return Trainer(lambda g: LM(cfg, device=dev, generator=g),
                       AdamWConfig(warmup_steps=2, total_steps=8),
                       TokenBatcher(corpus, 4, 16, device=dev),
                       TrainerConfig(steps=8, checkpoint_every=4,
                                     checkpoint_dir=str(d), log_every=4,
                                     crash_after_step=crash), device=dev)

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        want = trainer(tmp_path / "whole").run(seed=3)
        with pytest.raises(RuntimeError, match="injected failure"):
            trainer(tmp_path / "crash", crash=6).run(seed=3)
        got = trainer(tmp_path / "crash").run(seed=3)
    finally:
        torch.use_deterministic_algorithms(False)
    assert int(got.opt.step) == int(want.opt.step) == 8
    assert all(p.is_cuda for p in got.params.values())
    for n in want.params:
        assert torch.equal(got.params[n], want.params[n]), n
        assert torch.equal(got.opt.m[n], want.opt.m[n]), n


def test_checkpoint_of_card_tensors_round_trips(tmp_path):
    """A train state on the card saved (synchronously and through
    ``save_async``, whose staged download covers a leaf past
    ``STAGE_BYTES``) and restored onto the card, bit for bit, bf16 too."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.engine import STAGE_BYTES
    dev = _card()
    g = torch.Generator(dev).manual_seed(9)
    tree = {"big": torch.randn(STAGE_BYTES // 4 + 1000, generator=g,
                               device=dev),
            "segments.blocks.0.w": torch.randn(3, 5, generator=g,
                                               device=dev).bfloat16(),
            "segments.blocks.1.w": torch.randn(3, 5, generator=g,
                                               device=dev).bfloat16(),
            "step": torch.tensor(4, dtype=torch.int32, device=dev)}
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.save(1, tree)
    mgr.save_async(2, tree)
    snapshot = {k: v.clone() for k, v in tree.items()}
    tree["big"].add_(1.0)
    for step in (1, 2):
        back, got_step, _ = mgr.restore(snapshot, step=step)
        assert got_step == step
        for k, v in snapshot.items():
            assert back[k].is_cuda and back[k].dtype == v.dtype
            assert torch.equal(back[k], v), k


# -- the vlm and audio families (smoke phase 15 (b), (d)) --------------------

def _media_inputs(cfg, seed, B=3, S=16):
    """Tokens (vlm: with its image context) or audio frames, float32
    numpy-drawn, on the CPU."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"frames": torch.from_numpy(rng.normal(
            size=(B, S, 512)).astype(np.float32))}
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, S)))}
    out["vision"] = torch.from_numpy(rng.normal(size=(
        B, cfg.vlm.num_image_tokens, cfg.vlm.vision_dim)).astype(np.float32))
    return out


def _media_forward(lm, inputs):
    x = inputs.get("frames", inputs.get("tokens"))
    return lm(x, vision=inputs.get("vision"))


@pytest.mark.parametrize("arch", ["llama32_vision_11b", "hubert_xlarge"])
def test_media_lm_on_the_card_matches_the_cpu(arch):
    """Smoke phase 15 (b) at smoke size: forward logits to 1e-4; the vlm's
    prefill and decode logits (the image context at every step) to 1e-4
    and 8 greedy tokens equal; HuBERT's encode step, which moves position
    0 when the last frame changes."""
    from repro_torch.serve import ServeConfig, ServeEngine, make_serve_step
    dev = _card()
    cpu, card = _cpu_and_card_lm(arch, dev)
    inp = _media_inputs(cpu.cfg, 0)
    cinp = {k: v.to(dev) for k, v in inp.items()}
    with torch.inference_mode():
        np.testing.assert_allclose(_media_forward(card, cinp).cpu().numpy(),
                                   _media_forward(cpu, inp).numpy(),
                                   atol=1e-4, rtol=1e-4)
        if cpu.cfg.family == "audio":
            enc = make_serve_step(card, mode="prefill")(cinp["frames"])
            moved = cinp["frames"].clone()
            moved[:, -1] += 1.0
            other = make_serve_step(card, mode="prefill")(moved)
            assert float((other[:, 0] - enc[:, 0]).abs().max()) > 1e-4
            return
        toks, v, cv = inp["tokens"], inp["vision"], cinp["vision"]
        lc, cc = cpu.prefill(toks[:, :8], 16, vision=v)
        lg, cg = card.prefill(toks[:, :8].to(dev), 16, vision=cv)
        for t in range(8, 12):
            np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(),
                                       atol=1e-4, rtol=1e-4)
            lc, cc = cpu.decode_step(toks[:, t:t + 1], cc, vision=v)
            lg, cg = card.decode_step(toks[:, t:t + 1].to(dev), cg,
                                      vision=cv)
    want = ServeEngine(cpu, ServeConfig(max_seq=24), device="cpu").generate(
        {"tokens": toks, "vision": v}, 8)
    got = ServeEngine(card, ServeConfig(max_seq=24), device=dev).generate(
        {"tokens": toks, "vision": v}, 8)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llama32_vision_11b", "hubert_xlarge"])
def test_media_lm_on_the_card_is_deterministic(arch, dtype):
    """Smoke phase 15 (b): two card runs (forward; the vlm's prefill and
    decode steps too) bit-equal."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import LM
    dev = _card()
    cfg = get_smoke(arch).scaled(param_dtype=dtype, compute_dtype=dtype)
    lm = LM(cfg, device=dev, generator=torch.Generator(dev).manual_seed(5))
    inp = {k: v.to(dev) for k, v in _media_inputs(cfg, 6, 4, 40).items()}

    def run():
        out = [_media_forward(lm, inp)]
        if cfg.family == "vlm":
            toks, v = inp["tokens"], inp["vision"]
            logits, caches = lm.prefill(toks[:, :32], 40, vision=v)
            out.append(logits)
            for t in range(32, 40):
                logits, caches = lm.decode_step(toks[:, t:t + 1], caches,
                                                vision=v)
                out.append(logits)
        return out

    with torch.inference_mode():
        a, b = run(), run()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("arch", ["llama32_vision_11b", "hubert_xlarge"])
def test_media_training_on_the_card_matches_the_cpu(arch):
    """Smoke phase 15 (d): the loss and every gradient (``vision_norm``,
    the cross ``wk`` / ``wv``, ``frontend_proj`` included) to 1e-5 in the
    L2 norm, card against CPU, and the parameters after two AdamW steps to
    1e-4, as ``tests/test_torch_train.py`` holds Adam-stepped parameters:
    Adam divides each element by its own gradient's scale, so a
    zero-initialised norm scale whose gradient is small in some elements
    turns their rounding into an O(lr) move (HuBERT's smoke ``ln2`` read
    2.6e-5 on an H100, as zamba2's ``A_log`` did in smoke phase 14)."""
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step)
    dev = _card()
    cpu, card = _cpu_and_card_lm(arch, dev)
    batch = _media_inputs(cpu.cfg, 1, 4, 32)
    batch["labels"] = torch.from_numpy(np.random.default_rng(2).integers(
        0, cpu.cfg.vocab, (4, 32)))
    cbatch = {k: v.to(dev) for k, v in batch.items()}
    out = []
    for lm, b in ((cpu, batch), (card, cbatch)):
        params = [p.requires_grad_(True) for p in lm.parameters()]
        loss = lm.loss(b)
        out.append((loss.detach(), torch.autograd.grad(loss, params)))
    assert _rel_l2(out[1][0], out[0][0]) <= 1e-5
    for g_card, g_cpu in zip(out[1][1], out[0][1]):
        assert _rel_l2(g_card, g_cpu) <= 1e-5
    states = []
    for lm, b in ((cpu, batch), (card, cbatch)):
        step, state = make_train_step(lm, AdamWConfig(warmup_steps=1)), \
            init_train_state(lm)
        for _ in range(2):
            state, _ = step(state, b)
        states.append(state)
    for name, p in states[0].params.items():
        assert _rel_l2(states[1].params[name], p) <= 1e-4, name


# -- data parallelism across ranks (smoke phase 16) ----------------------------

@pytest.fixture
def nccl_world(tmp_path):
    """A one-rank NCCL world in this process, and its ``("data",)`` mesh
    on the card."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    _card()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield make_mesh((1,), ("data",), device="cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["qwen3_8b", "granite_moe_1b_a400m"])
def test_one_rank_nccl_dp_step_is_bit_equal_to_train_step(nccl_world, arch,
                                                          monkeypatch):
    """Smoke phase 16 (a) at world 1: three uncompressed DP steps equal
    three ``make_train_step`` steps from the same seed bit for bit (an
    all-reduce over one rank and a division by 1.0 change no bit); three
    compressed steps keep each loss within 0.05 of the uncompressed
    step's, every residual finite."""
    from repro_torch.configs import get_smoke
    from repro_torch.models.model import LM
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_dp_shard_map_step, make_train_step)
    dev = torch.device("cuda")
    cfg = get_smoke(arch)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1)
    batches = [_train_batch(cfg.vocab, dev, i) for i in range(3)]

    def run(dp: bool, compress: bool = False):
        lm = LM(cfg, device=dev,
                generator=torch.Generator(dev).manual_seed(3))
        state = init_train_state(lm)
        if dp:
            init, step = make_dp_shard_map_step(lm, ocfg, nccl_world,
                                                compress=compress)
            state = init(state.params)
        else:
            step = make_train_step(lm, ocfg)
        losses = []
        for b in batches:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        return state, losses

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        runs = [run(False), run(True), run(True, compress=True)]
    finally:
        torch.use_deterministic_algorithms(False)
    (want, lw), (got, lg), (comp, lc) = runs
    assert lg == lw
    for n, p in want.params.items():
        assert torch.equal(got.params[n], p), n
        assert torch.equal(got.opt.m[n], want.opt.m[n]), n
        assert torch.equal(got.opt.v[n], want.opt.v[n]), n
    assert max(abs(a - b) for a, b in zip(lc, lg)) < 0.05
    assert all(torch.isfinite(r).all() for r in comp.residual.values())


@pytest.mark.parametrize("k", [2, 4, 7])
def test_cross_rank_partition_histogram_on_the_card_equals_numpy(nccl_world,
                                                                 k):
    from repro_torch.dist.partition import (hash_partition,
                                            partition_histogram)
    dev = torch.device("cuda")
    codes = np.random.default_rng(k).integers(0, 1 << 31, 1 << 20)
    hist = partition_histogram(torch.from_numpy(codes).to(dev), k, salt=3,
                               device=dev, mesh=nccl_world)
    assert hist.device.type == "cuda" and hist.dtype == torch.int64
    np.testing.assert_array_equal(
        hist.cpu().numpy(),
        np.bincount(hash_partition(codes, k, salt=3), minlength=k))


# -- the sharded train step (smoke phase 17) -----------------------------------

@pytest.fixture
def nccl_mesh_2d(tmp_path):
    """A one-rank NCCL world in this process, and its ``("data",
    "model")`` mesh on the card (``make_local_mesh``)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    _card()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield make_local_mesh(model=1, device="cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("B,S", [(4, 32), (1, 4096)])
def test_placed_step_at_world_1_is_bit_equal_to_the_plain_step(
        nccl_mesh_2d, B, S, monkeypatch):
    """Smoke phase 17 (a) at world 1, the qwen3_8b smoke model: three
    ``make_train_step`` steps on parameters and batches placed by the
    rules equal three plain steps from the same seed bit for bit, in
    deterministic mode (S = 4,096 takes the online attention path)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_smoke
    from repro_torch.launch import specs
    from repro_torch.models.model import LM
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step)
    dev = torch.device("cuda")
    cfg = get_smoke("qwen3_8b")
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1)
    batches = [_train_batch(cfg.vocab, dev, i, B=B, S=S) for i in range(3)]

    def run(placed: bool):
        lm = LM(cfg, device=dev,
                generator=torch.Generator(dev).manual_seed(5))
        bs = batches
        if placed:
            mesh = nccl_mesh_2d
            st = specs.state_shardings(lm, mesh, specs.arch_rules(cfg, mesh))
            specs.place_params(lm, st.params)
            of = specs.batch_shardings(cfg, mesh, B)
            bs = [{k: distribute_tensor(v, mesh, of(v).placements)
                   for k, v in b.items()} for b in batches]
        step, state = make_train_step(lm, ocfg), init_train_state(lm)
        losses = []
        for b in bs:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        full = {n: p.full_tensor() if placed else p
                for n, p in state.params.items()}
        return full, losses

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        (want, lw), (got, lg) = run(False), run(True)
    finally:
        torch.use_deterministic_algorithms(False)
    assert lg == lw
    for n, p in want.items():
        assert got[n].device.type == "cuda"
        assert torch.equal(got[n], p), n


def test_placements_and_constrain_on_cuda_tensors(nccl_mesh_2d):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.dist import constrain, use
    from repro_torch.dist.sharding import placements
    mesh = nccl_mesh_2d
    x = torch.arange(48, dtype=torch.float32, device="cuda").reshape(8, 6)
    pl = placements(("data", "model"), mesh)
    assert pl == (Shard(0), Shard(1))
    xd = distribute_tensor(x, mesh, pl)
    assert xd.to_local().device.type == "cuda"
    assert torch.equal(xd.to_local(), x)
    assert constrain(xd) is xd
    with use(mesh, (None, "model")):
        y = constrain(xd)
    assert tuple(y.placements) == (Replicate(), Shard(1))
    assert torch.equal(y.full_tensor(), x)


# -- every family placed (smoke phase 18) --------------------------------------

def test_placed_granite_step_at_world_1_is_bit_equal_to_the_plain_step(
        nccl_mesh_2d, monkeypatch):
    """Smoke phase 18 (a) at world 1, the granite-moe smoke model: three
    steps of the train cell placed by ``specs.place_cell`` (the MoE
    dispatch on placed tensors) equal three plain steps from the same
    seed bit for bit, in deterministic mode."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs import get_smoke
    from repro_torch.launch import specs
    from repro_torch.models.model import LM
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step)
    dev, B, S = torch.device("cuda"), 4, 64
    cfg = get_smoke("granite_moe_1b_a400m")
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1)
    batches = [_train_batch(cfg.vocab, dev, i, B=B, S=S) for i in range(3)]

    def run(placed: bool):
        lm = LM(cfg, device=dev,
                generator=torch.Generator(dev).manual_seed(6))
        bs = batches
        if placed:
            mesh = nccl_mesh_2d
            sh = specs.cell_shardings(lm, "train", mesh, B, S,
                                      specs.arch_rules(cfg, mesh))
            step, (state, _) = specs.place_cell(
                lm, "train", (None, batches[0]), sh, seq=S, opt_cfg=ocfg)
            bs = [{k: distribute_tensor(v, mesh, sh[1][k].placements)
                   for k, v in b.items()} for b in batches]
        else:
            step, state = make_train_step(lm, ocfg), init_train_state(lm)
        losses = []
        for b in bs:
            state, m = step(state, b)
            losses.append(float(m["loss"]))
        return {n: p.full_tensor() if placed else p
                for n, p in state.params.items()}, losses

    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        (want, lw), (got, lg) = run(False), run(True)
    finally:
        torch.use_deterministic_algorithms(False)
    assert lg == lw
    for n, p in want.items():
        assert got[n].device.type == "cuda"
        assert torch.equal(got[n], p), n


def test_placed_qwen3_decode_at_world_1_is_bit_equal_to_plain(nccl_mesh_2d):
    """Smoke phase 18 (c) at world 1, the qwen3_8b smoke model: a prefill
    and greedy decode steps on placed parameters and placed caches give
    the plain run's logits bit for bit."""
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_smoke
    from repro_torch.launch import specs
    from repro_torch.models.model import LM
    dev, B, S, new = torch.device("cuda"), 2, 32, 6
    cfg = get_smoke("qwen3_8b")
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)).to(dev)

    def run(placed: bool):
        lm = LM(cfg, device=dev,
                generator=torch.Generator(dev).manual_seed(7))
        x = tokens
        if placed:
            sh = specs.cell_shardings(lm, "prefill", nccl_mesh_2d, B,
                                      S + new, specs.arch_rules(
                                          cfg, nccl_mesh_2d))
            _, (_, b) = specs.place_cell(lm, "prefill", (None, {
                "tokens": tokens}), sh, seq=S + new)
            x = b["tokens"]
        out = []
        with torch.no_grad():
            logits, caches = lm.prefill(x, S + new)
            for _ in range(new):
                out.append(logits[:, -1].full_tensor() if placed
                           else logits[:, -1])
                tok = logits[:, -1].argmax(-1, keepdim=True)
                logits, caches = lm.decode_step(tok, caches)
        if placed:
            assert all(isinstance(c.k, DTensor) for c in caches[0])
        return torch.stack(out)

    want, got = run(False), run(True)
    assert got.device.type == "cuda"
    assert torch.equal(got, want)
