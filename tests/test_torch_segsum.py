"""The port's `mul_segsum`, `run_boundaries`, device GROUP BY COUNT and
storage against the reference.

On CPU tensors the wrappers run their plain PyTorch versions, which are
held here to the reference's Pallas kernels in interpret mode and to
numpy.  The reference's `mul_segsum` sums in f32, so it is exact only
below 2^24: those cases compare against it, and the int64 cases past 2^24
compare against ``np.add.at`` alone, where only the port is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine_jax
from repro.core.api import GraphicalJoin as RefGraphicalJoin
from repro.core.potentials import Factor as RefFactor
from repro.core.storage import load_gfjs as ref_load, save_gfjs as ref_save
from repro.kernels.boundaries import run_boundaries as ref_boundaries
from repro.kernels.segsum import mul_segsum as ref_segsum
from repro.relational.synth import lastfm_like as ref_lastfm_like

from repro_torch.core import engine
from repro_torch.core.api import GraphicalJoin
from repro_torch.core.potentials import Factor
from repro_torch.core.storage import load_gfjs, save_gfjs
from repro_torch.interop import catalog_from_arrays
from repro_torch.kernels import ops
from repro_torch.kernels.mul_segsum import carry_len, mul_segsum
from repro_torch.kernels.ref import mul_segsum_ref, run_boundaries_ref
from repro_torch.kernels.run_boundaries import run_boundaries
from repro_torch.obs.metrics import REGISTRY
from repro_torch.relational.query import JoinQuery


def dense_segments(n, segs, rng):
    """Sorted dense ids over n entries (test_mul_segsum_shapes' recipe)."""
    seg = np.sort(np.concatenate([np.arange(segs),
                                  rng.integers(0, segs, max(n - segs, 0))]))
    _, seg = np.unique(seg[:n], return_inverse=True)
    return seg.astype(np.int32), int(seg.max()) + 1


SEGSUM_SHAPES = [(1, 1), (100, 3), (512, 512), (1500, 40), (4096, 1000)]


@pytest.mark.parametrize("n,segs", SEGSUM_SHAPES)
def test_mul_segsum_matches_reference_kernel(n, segs):
    rng = np.random.default_rng(n)
    seg, s_eff = dense_segments(n, segs, rng)
    x = rng.integers(0, 100, n).astype(np.float32)
    y = rng.integers(0, 100, n).astype(np.float32)
    want = np.asarray(ref_segsum(jnp.asarray(seg), jnp.asarray(x),
                                 jnp.asarray(y), num_segments=s_eff,
                                 interpret=True))
    for xs, ys in ((x, y), (x.astype(np.int64), y.astype(np.int32))):
        launches = mul_segsum.launches
        calls = REGISTRY.counter("kernels.launches").value
        got = ops.mul_segsum(torch.from_numpy(seg), torch.from_numpy(xs),
                             torch.from_numpy(ys), s_eff)
        assert mul_segsum.launches == launches      # CPU: the plain version
        assert REGISTRY.counter("kernels.launches").value == calls + 1
        assert got.dtype == (torch.float64 if xs.dtype.kind == "f"
                             else torch.int64)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["past-2^24", "past-2^40", "negative",
                                  "one-segment", "empty-segments"])
def test_mul_segsum_exact_in_int64(case):
    """Only the port is exact here: compare with np.add.at in int64."""
    rng = np.random.default_rng(7)
    n = 5000
    seg, s = dense_segments(n, 300, rng)
    x = rng.integers(0, 1 << 20, n)
    y = rng.integers(1 << 10, 1 << 12, n)
    if case == "past-2^40":
        x = rng.integers(1 << 40, 1 << 41, n)
    elif case == "negative":
        x = rng.integers(-(1 << 40), 1 << 40, n)
        y = rng.integers(-5, 6, n)
    elif case == "one-segment":
        seg, s = np.zeros(n, np.int32), 1
    elif case == "empty-segments":
        seg, s = seg * 3, 3 * s          # ids with gaps: empty segments
    want = np.zeros(s, np.int64)
    np.add.at(want, seg, x.astype(np.int64) * y)
    assert np.abs(want).max() > 1 << 24
    got = mul_segsum(torch.from_numpy(seg), torch.from_numpy(x),
                     torch.from_numpy(y), s)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        mul_segsum_ref(torch.from_numpy(seg), torch.from_numpy(x),
                       torch.from_numpy(y), s).numpy(), want)


@pytest.mark.parametrize("bad", ["seg-dtype", "shape", "segments", "complex",
                                 "no-segments"])
def test_mul_segsum_rejects_bad_inputs(bad):
    seg = torch.zeros(4, dtype=torch.int32)
    x = y = torch.ones(4, dtype=torch.int64)
    s, err = 1, ValueError
    if bad == "seg-dtype":
        seg, err = seg.float(), TypeError
    elif bad == "shape":
        x = x[:3]
    elif bad == "segments":
        s = 1 << 31
    elif bad == "complex":
        x, err = x.to(torch.complex64), TypeError
    else:
        s = 0
    with pytest.raises(err):
        mul_segsum(seg, x, y, s)


@pytest.mark.parametrize("bad_id", [(1 << 32) + 3, -1, 3, 1 << 31])
def test_mul_segsum_rejects_int64_ids_out_of_range(bad_id):
    """An int64 id outside [0, num_segments) raises ValueError, before the
    kernel's int32 cast could wrap 2^32 + 3 onto segment 3."""
    seg = torch.tensor([0, 1, 2, bad_id], dtype=torch.int64)
    if bad_id < 0:
        seg = seg.sort().values
    x = y = torch.ones(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="outside"):
        mul_segsum(seg, x, y, 3)
    with pytest.raises(ValueError, match="outside"):
        ops.mul_segsum(seg, x, y, 3)


def test_mul_segsum_takes_int64_ids_in_range():
    seg = torch.tensor([0, 0, 2, 2], dtype=torch.int64)
    x = torch.tensor([1, 2, 3, 4], dtype=torch.int64)
    got = mul_segsum(seg, x, x, 3)
    assert got.tolist() == [5, 0, 25]
    assert torch.equal(got, mul_segsum(seg.int(), x, x, 3))


def test_mul_segsum_empty_input():
    e = torch.zeros(0, dtype=torch.int32)
    out = mul_segsum(e, e.long(), e.long(), 3)
    assert out.dtype == torch.int64 and out.tolist() == [0, 0, 0]
    assert mul_segsum(e, e.double(), e.long(), 0).dtype == torch.float64


@pytest.mark.parametrize("n,want", [(0, 0), (2048, 0), (2049, 4),
                                    (38_344_764, 2 * 18_724 + 2 * 19)])
def test_carry_len_follows_the_kernel_tiling(n, want):
    """Scratch for the kernel's carry passes: 2 per tile per pass but the
    last (2048-entry tiles: 38.3M -> 18,724 tiles -> 19 -> 1)."""
    assert carry_len(n, 2048) == want


@pytest.mark.parametrize("n", [1, 5, 1024, 1025, 5000])
def test_run_boundaries_matches_reference_kernel(n):
    rng = np.random.default_rng(n)
    keys = np.sort(rng.integers(0, max(n // 3, 1), n)).astype(np.int32)
    want = np.asarray(ref_boundaries(jnp.asarray(keys), interpret=True))
    launches = run_boundaries.launches
    for k in (keys, keys.astype(np.int64) + (1 << 40)):
        got = ops.run_boundaries(torch.from_numpy(k))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert run_boundaries.launches == launches
    np.testing.assert_array_equal(
        run_boundaries_ref(torch.from_numpy(keys)).numpy(), want)


@pytest.mark.parametrize("bad", ["dtype", "rank"])
def test_run_boundaries_rejects_bad_inputs(bad):
    keys = torch.zeros(4, dtype=torch.int32)
    err = ValueError
    if bad == "dtype":
        keys, err = keys.float(), TypeError
    else:
        keys = keys.reshape(2, 2)
    with pytest.raises(err):
        run_boundaries(keys)


@pytest.mark.parametrize("n,hi", [(0, 1), (1, 1), (3000, 50), (5000, 5000)])
def test_group_by_count_matches_numpy_unique(n, hi):
    keys = np.sort(np.random.default_rng(n).integers(0, hi, n)) \
        .astype(np.int32)
    seg, counts, num = ops.group_by_count(torch.from_numpy(keys))
    uniq, want = np.unique(keys, return_counts=True)
    assert num == len(uniq)
    assert counts.dtype == torch.int64 and seg.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), want)
    np.testing.assert_array_equal(seg.numpy(),
                                  np.searchsorted(uniq, keys))


def fallbacks():
    return REGISTRY.counter("engine.numpy_fallbacks").value


@pytest.mark.parametrize("case", ["two-cols", "one-col", "three-cols",
                                  "empty", "unpackable"])
def test_build_factor_matches_reference(case):
    rng = np.random.default_rng(0)
    n = 5000
    if case == "two-cols":
        sizes = {"A": 40, "B": 60}
    elif case == "one-col":
        sizes = {"A": 7}
    elif case == "three-cols":
        sizes = {"A": 13, "B": 1, "C": 900}
    elif case == "empty":
        sizes, n = {"A": 4, "B": 4}, 0
    else:  # 2^20 * 2^20 * 4 packs past int32
        sizes = {"A": 1 << 20, "B": 1 << 20, "C": 4}
    cols = {v: rng.integers(0, s, n) for v, s in sizes.items()}
    before = fallbacks()
    got = engine.build_factor(cols, sizes, device="cpu")
    assert fallbacks() == before + (case == "unpackable")
    wants = [Factor.from_columns(cols, sizes), RefFactor.from_columns(
        cols, sizes), engine_jax.build_factor_jax(cols, sizes, interpret=True)]
    for want in wants:
        assert got.vars == want.vars and got.sizes == want.sizes
        np.testing.assert_array_equal(got.keys, want.keys)
        np.testing.assert_array_equal(got.bucket, want.bucket)
        np.testing.assert_array_equal(got.fac, want.fac)
    assert got.bucket.dtype == np.int64


def assert_levels_equal(a, b):
    assert a.join_size == b.join_size
    assert list(a.column_order) == list(b.column_order)
    assert len(a.levels) == len(b.levels)
    for la, lb in zip(a.levels, b.levels):
        assert tuple(la.vars) == tuple(lb.vars)
        np.testing.assert_array_equal(la.freq, lb.freq)
        for v in la.vars:
            np.testing.assert_array_equal(la.key_cols[v], lb.key_cols[v])
    for v in a.domains:
        np.testing.assert_array_equal(a.domains[v].values,
                                      b.domains[v].values)


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("sharded", [False, True], ids=["mono", "sharded"])
def test_storage_files_cross_packages(tmp_path, writer, sharded):
    cat, queries = ref_lastfm_like(n_users=80, n_artists=60,
                                   artists_per_user=4, friends_per_user=3)
    q = queries["lastfm_A1"]
    ref = RefGraphicalJoin(cat, q, partitions=2 if sharded else None)
    ref_gfjs = ref.run()
    path = str(tmp_path / "q.gfjs")
    if writer == "reference":
        nbytes = ref.store(ref_gfjs, path)
        got = GraphicalJoin.load(path)
    else:
        ref_save(ref_gfjs, str(tmp_path / "ref.gfjs"))
        port_gfjs = load_gfjs(str(tmp_path / "ref.gfjs"))
        nbytes = save_gfjs(port_gfjs, path)
        got = ref_load(path)
    assert nbytes > 0
    pairs = zip(got.shards, ref_gfjs.shards) if sharded \
        else [(got, ref_gfjs)]
    for a, b in pairs:
        assert_levels_equal(a, b)


def test_compute_and_reuse_end_to_end(tmp_path):
    """run -> store -> load -> aggregate on the port, equal to the
    reference's answers on its own run."""
    cat, queries = ref_lastfm_like(n_users=120, n_artists=100,
                                   artists_per_user=5, friends_per_user=3)
    q = queries["lastfm_A1"]
    ref = RefGraphicalJoin(cat, q)
    ref_gfjs = ref.run()
    pcat = catalog_from_arrays({n: dict(t.columns)
                                for n, t in cat.tables.items()})
    spec = [(qt.table, dict(qt.var_map)) for qt in q.tables]
    gj = GraphicalJoin(pcat, JoinQuery.of(q.name, spec), device="cpu",
                       elimination_order=list(ref.plan().order))
    path = str(tmp_path / "a1.gfjs")
    assert gj.store(gj.run(), path) > 0 and "store" in gj.timings
    back = GraphicalJoin.load(path)
    got = gj.aggregate("count", by=["U1", "A2"], gfjs=back)
    want = ref.aggregate("count", by=["U1", "A2"], gfjs=ref_gfjs)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert gj.aggregate("sum", "U2", gfjs=back) == \
        ref.aggregate("sum", "U2", gfjs=ref_gfjs)
