"""Kernel cases shared by the CPU and the card tests of the port's kernels.

The expansion cases mirror tests/test_expand_fused.py (the parity sweep,
empty runs, a single run, K=1, a total that is not a tile multiple, and
[K, 0] outputs) and add the edges of expand_many.cu's per-tile run window;
the dense cases cover both dense_message kernels, thin and tiled.  Inputs
are made with numpy from fixed seeds.
"""

import numpy as np
import torch

from repro_torch.core.gfjs import GFJS, LevelSummary
from repro_torch.kernels.dense_message import THIN_K

EXPAND_TILE = 2048   # expand_many.cu's outputs per block (kTile)


def expand_cases():
    """name -> (payloads [K, runs] int32, freqs [runs] int64)."""
    cases = {}
    for n_runs in (1, 7, 500, 513, 1200):
        for k in (1, 2, 5):
            rng = np.random.default_rng(n_runs * 31 + k)
            freqs = rng.integers(1, 9, n_runs)
            cases[f"sweep-{n_runs}x{k}"] = (
                rng.integers(0, 1 << 20, (k, n_runs)).astype(np.int32), freqs)
    rng = np.random.default_rng(0)
    freqs = rng.integers(0, 4, 600)            # many zero-length runs
    freqs[::7] = 0
    cases["empty-runs"] = (
        rng.integers(0, 1 << 20, (3, 600)).astype(np.int32), freqs)
    # zero-length runs at both ends and back to back
    cases["zero-length-edges"] = (
        np.arange(14, dtype=np.int32).reshape(2, 7),
        np.asarray([0, 0, 3, 0, 2, 0, 0]))
    cases["single-run"] = (np.asarray([[9], [4]], np.int32), np.asarray([6]))
    rng = np.random.default_rng(4)
    cases["k1"] = (rng.integers(0, 1 << 30, (1, 777)).astype(np.int32),
                   rng.integers(1, 7, 777))
    rng = np.random.default_rng(3)
    freqs = rng.integers(1, 5, 300)
    assert int(freqs.sum()) % 512 != 0
    cases["ragged-total"] = (
        rng.integers(0, 1 << 20, (2, 300)).astype(np.int32), freqs)
    cases["all-runs-empty"] = (np.ones((4, 5), np.int32),
                               np.zeros(5, np.int64))
    cases["no-runs"] = (np.zeros((3, 0), np.int32), np.zeros(0, np.int64))
    # the per-tile run window of expand_many.cu
    for total in (EXPAND_TILE - 1, EXPAND_TILE, EXPAND_TILE + 1):
        rng = np.random.default_rng(total)
        freqs = lengths_to(rng, total, 1, 4)
        cases[f"window-tile-{total}"] = (
            rng.integers(0, 1 << 30, (2, len(freqs))).astype(np.int32), freqs)
    rng = np.random.default_rng(40)
    cases["run-spans-tiles"] = (
        rng.integers(0, 1 << 30, (2, 5)).astype(np.int32),
        np.asarray([3, 1, 5 * EXPAND_TILE + 17, 2, 1]))
    freqs = np.minimum(rng.zipf(1.5, 1000), 2 * EXPAND_TILE)
    cases["zipf"] = (rng.integers(0, 1 << 30, (3, 1000)).astype(np.int32),
                     freqs)
    # row q starts at word q * total: rows off the 16-byte grid
    for k in (2, 7):
        for mod in (1, 2, 3):
            total = 2 * EXPAND_TILE + 100 + mod
            freqs = lengths_to(rng, total, 1, 6)
            cases[f"k{k}-total-mod4-{mod}"] = (
                rng.integers(0, 1 << 30, (k, len(freqs))).astype(np.int32),
                freqs)
    return cases


def lengths_to(rng, total, lo, hi):
    """Run lengths in [lo, hi) from ``rng`` that sum to exactly ``total``."""
    freqs = rng.integers(lo, hi, total)
    cut = int(np.searchsorted(np.cumsum(freqs), total))
    freqs = freqs[:cut + 1].copy()
    freqs[-1] -= int(freqs.sum()) - total
    return freqs


def bounds_of(freqs):
    """Inclusive prefix sums (int32) and the total they reach."""
    bounds = np.cumsum(freqs).astype(np.int32)
    return bounds, int(bounds[-1]) if len(bounds) else 0


def repeat_oracle(payloads, freqs):
    return np.stack([np.repeat(p, freqs) for p in payloads])


def memo_free(gfjs):
    """The same summary rebuilt from its levels: no device memo."""
    return GFJS(gfjs.levels, gfjs.column_order, gfjs.join_size,
                gfjs.domains)


def level_gfjs(payloads, freqs):
    """A one-level GFJS of an expansion case: variable ``v<k>`` holds row
    k of ``payloads`` (int64 codes, as a LevelSummary holds them)."""
    names = tuple(f"v{k}" for k in range(payloads.shape[0]))
    lvl = LevelSummary(names, {v: payloads[k].astype(np.int64)
                               for k, v in enumerate(names)},
                       np.asarray(freqs, np.int64))
    return GFJS([lvl], list(names), int(np.sum(freqs)), {})


def zero_run_identity_gfjs():
    """Two levels whose second has ``num_runs == join_size`` but holds a
    zero-length run: not an identity level, so it goes through the
    kernel."""
    return GFJS([LevelSummary(("A",), {"A": np.asarray([0, 1])},
                              np.asarray([2, 1])),
                 LevelSummary(("B",), {"B": np.asarray([5, 6, 7])},
                              np.asarray([2, 0, 1]))], ["A", "B"], 3, {})


def spans_bytes(tracer, name, since=0):
    """(count, bytes) of the ``name`` spans recorded after the first
    ``since`` spans."""
    spans = [s for s in tracer.spans[since:] if s.name == name]
    return len(spans), sum(s.args.get("bytes", 0) for s in spans)


def port_catalog(cat):
    """The port's catalog over a reference catalog's arrays."""
    from repro_torch.interop import catalog_from_arrays
    return catalog_from_arrays({n: dict(t.columns)
                                for n, t in cat.tables.items()})


def port_query(query):
    """The port's twin of a reference query: same name, occurrences and
    output."""
    from repro_torch.relational.query import JoinQuery, QueryTable
    return JoinQuery(query.name,
                     tuple(QueryTable(qt.table, tuple(qt.var_map))
                           for qt in query.tables), query.output)


def assert_gfjs_equal(a, b):
    """Level for level: vars, codes and freq (a and b from either package)."""
    assert a.join_size == b.join_size
    assert list(a.column_order) == list(b.column_order)
    assert len(a.levels) == len(b.levels)
    for la, lb in zip(a.levels, b.levels):
        assert tuple(la.vars) == tuple(lb.vars)
        np.testing.assert_array_equal(la.freq, lb.freq)
        for v in la.vars:
            np.testing.assert_array_equal(la.key_cols[v], lb.key_cols[v])

TILE = 2048          # mul_segsum.cu's entries per tile
I32 = np.iinfo(np.int32)


def segsum_cases():
    """name -> (seg [n] int32 sorted, x [n], y [n], num_segments): the edge
    cases of the CUDA mul_segsum kernel's tiling and carry passes."""
    rng = np.random.default_rng(11)
    cases = {}

    def ints(n, lo=-1000, hi=1000):
        return rng.integers(lo, hi, n), rng.integers(-9, 10, n)

    cases["n0"] = (np.zeros(0, np.int32), *ints(0), 3)
    cases["n1"] = (np.zeros(1, np.int32), *ints(1), 1)
    n = 5 * TILE + 3
    cases["one-segment-all-tiles"] = (np.zeros(n, np.int32), *ints(n), 1)
    n = 2 * TILE * TILE + 5                 # three passes: n -> 4098 -> 6
    cases["one-segment-three-passes"] = (np.zeros(n, np.int32), *ints(n), 1)
    n = 3 * TILE + 17
    cases["own-segments"] = (np.arange(n, dtype=np.int32), *ints(n), n)
    for name, width in (("tile-edges", TILE), ("half-tiles", TILE // 2),
                        ("thread-edges", 8), ("off-edges", TILE + 1)):
        seg = np.repeat(np.arange(9, dtype=np.int32), width)
        cases[name] = (seg, *ints(len(seg)), 9)
    seg = np.sort(rng.integers(0, 50, 20000)).astype(np.int32) * 4
    cases["empty-segments"] = (seg, *ints(len(seg)), 4 * 50 + 7)
    seg = np.sort(rng.integers(0, 3000, 100000)).astype(np.int32)
    cases["past-2^40"] = (seg, rng.integers(1 << 40, 1 << 41, len(seg)),
                          rng.integers(1, 1 << 10, len(seg)), 3000)
    cases["negative"] = (seg, rng.integers(-(1 << 41), 1 << 41, len(seg)),
                         rng.integers(-7, 8, len(seg)), 3000)
    cases["f64"] = (seg, rng.standard_normal(len(seg)) * 1e3,
                    rng.standard_normal(len(seg)), 3000)
    cases["f64-integral"] = (seg, rng.integers(-1000, 1000, len(seg))
                             .astype(np.float64),
                             rng.integers(0, 9, len(seg)), 3000)
    cases["int32-inputs"] = (seg, rng.integers(-1000, 1000, len(seg))
                             .astype(np.int32),
                             rng.integers(0, 9, len(seg)).astype(np.int16),
                             3000)
    return cases


def boundaries_cases():
    """name -> sorted keys (int32 or int64) for the CUDA run_boundaries."""
    rng = np.random.default_rng(12)
    cases = {"n0": np.zeros(0, np.int32), "n1": np.asarray([7], np.int32)}
    cases["int32-min-max"] = np.asarray(
        [I32.min, I32.min, -1, 0, 0, I32.max - 1, I32.max, I32.max],
        np.int32)
    cases["block-edges"] = np.repeat(np.arange(40, dtype=np.int32), 256)
    cases["all-distinct"] = np.arange(-5000, 5000, dtype=np.int32)
    cases["all-equal"] = np.full(7000, 3, np.int32)
    cases["grid-stride"] = np.sort(rng.integers(0, 1 << 20, 3_000_000)) \
        .astype(np.int32)
    cases["int64-past-2^40"] = np.sort(
        rng.integers(1 << 40, (1 << 40) + 5000, 100000)).astype(np.int64)
    cases["int64-min-max"] = np.asarray(
        [np.iinfo(np.int64).min, -1, 0, 0, np.iinfo(np.int64).max], np.int64)
    return cases


def gather_cases():
    """name -> (payload [runs] int32 or float32, freqs [runs]): the edge
    cases of the single-payload expansion (expand_gather)."""
    cases = {}
    for n_runs in (1, 7, 500, 513, 2048):       # test_expand_gather_shapes
        for dt in (np.int32, np.float32):
            rng = np.random.default_rng(n_runs)
            freqs = rng.integers(1, 9, size=n_runs)
            cases[f"sweep-{n_runs}-{np.dtype(dt).name}"] = (
                rng.integers(0, 1 << 20, n_runs).astype(dt), freqs)
    cases["single-run"] = (np.asarray([-5], np.int32), np.asarray([11]))
    rng = np.random.default_rng(21)
    freqs = rng.integers(0, 4, 900)
    freqs[::5] = 0
    freqs[:3] = freqs[-3:] = 0
    cases["zero-length-runs"] = (
        rng.integers(-(1 << 31), 1 << 31, 900).astype(np.int32), freqs)
    cases["total-0"] = (np.arange(4, dtype=np.int32), np.zeros(4, np.int64))
    cases["no-runs"] = (np.zeros(0, np.int32), np.zeros(0, np.int64))
    bits = np.asarray([0x7FC00000, 0x7FA00001, 0xFFC00001, 0x80000000,
                       0x00000000, 0x7F800000, 0xFF800000, 0x00000001,
                       0x3F800000, 0xBF800000], np.uint32)
    bits = np.concatenate([bits, rng.integers(0, 1 << 32, 300,
                                              dtype=np.uint32)])
    cases["float-nan-negzero-bits"] = (
        bits.view(np.float32), rng.integers(0, 6, len(bits)))
    for total in (2047, 2048, 2049):         # 8 blocks of 256 threads
        freqs = np.ones(total, np.int64)            # every run one thread
        cases[f"tile-edge-{total}"] = (
            rng.integers(0, 1 << 30, total).astype(np.int32), freqs)
    freqs = rng.integers(1, 16, 250_000)            # past the grid stride
    cases["grid-stride"] = (
        rng.integers(0, 1 << 30, len(freqs)).astype(np.int32), freqs)
    # the per-tile run window of expand_many.cu
    for total in (EXPAND_TILE - 1, EXPAND_TILE, EXPAND_TILE + 1):
        rng = np.random.default_rng(1000 + total)
        freqs = lengths_to(rng, total, 1, 4)
        cases[f"window-tile-{total}"] = (
            rng.integers(0, 1 << 30, len(freqs)).astype(np.int32), freqs)
    rng = np.random.default_rng(23)
    # 100,000 back-to-back zero-length runs inside one tile
    freqs = np.concatenate([[EXPAND_TILE // 2 + 3], np.zeros(100_000, int),
                            [EXPAND_TILE], np.zeros(5, int), [9]])
    cases["zero-length-100000-in-one-tile"] = (
        rng.integers(-(1 << 31), 1 << 31, len(freqs)).astype(np.int32), freqs)
    cases["run-spans-tiles"] = (
        rng.integers(0, 1 << 30, 3).astype(np.int32),
        np.asarray([1, 9 * EXPAND_TILE + 5, 2]))
    freqs = np.minimum(rng.zipf(1.5, 5000), 4 * EXPAND_TILE)
    cases["zipf"] = (rng.standard_normal(len(freqs)).astype(np.float32),
                     freqs)
    return cases


DENSE_SIZES = (1, 63, 64, 65, 1025)   # about dense_message.cu's 64-wide tile


def dense_cases():
    """name -> (phi [P, V], m [V, K]) for dense_message: int32 counts or
    float32 integers whose f32 sums stay exact (below 2^24)."""
    cases = {}
    for p in DENSE_SIZES:
        for v in DENSE_SIZES:
            for k in DENSE_SIZES:
                rng = np.random.default_rng(p * 1_000_003 + v * 1009 + k)
                phi = rng.integers(0, 100, (p, v))
                m = rng.integers(0, 100, (v, k))
                cases[f"counts-{p}x{v}x{k}"] = (phi.astype(np.int32),
                                                m.astype(np.int32))
                cases[f"float-{p}x{v}x{k}"] = (phi.astype(np.float32),
                                               m.astype(np.float32))
    rng = np.random.default_rng(22)
    for dt, tag in ((np.int32, "counts"), (np.float32, "float")):
        for name, (p, v, k) in (("P", (0, 5, 3)), ("V", (4, 0, 3)),
                                ("K", (4, 5, 0))):
            cases[f"{tag}-empty-{name}"] = (np.ones((p, v), dt),
                                            np.ones((v, k), dt))
    # products past 2^24 and 2^47, row sums past 2^40 (and 2^55)
    cases["counts-past-2^40"] = (
        rng.integers(1 << 23, 1 << 24, (65, 300)).astype(np.int32),
        rng.integers(1 << 23, 1 << 24, (300, 3)).astype(np.int32))
    # products near 2^62 summed past 2^63: int64 wraps, as numpy's does
    cases["counts-int64-wrap"] = (
        rng.integers((1 << 31) - (1 << 20), 1 << 31, (3, 64)).astype(np.int32),
        rng.integers((1 << 31) - (1 << 20), 1 << 31, (64, 2)).astype(np.int32))
    cases["counts-negative"] = (
        rng.integers(-(1 << 31), 1 << 31, (65, 129)).astype(np.int32),
        rng.integers(-(1 << 31), 1 << 31, (129, 5)).astype(np.int32))
    cases["float-negative"] = (
        rng.integers(-100, 100, (65, 1025)).astype(np.float32),
        rng.integers(-100, 100, (1025, 5)).astype(np.float32))
    # the reference's maybe_dense_message rounds this one (16,785,408)
    cases["counts-f32-rounding"] = (np.asarray([[4097, 1]], np.int32),
                                    np.asarray([[4097], [1]], np.int32))
    # the thin kernel (K <= THIN_K) and the tiled one past it; values below
    # 90 keep the float sums (< 90^2 * 1891) below 2^24
    for k in sorted({2, 3, 4, 7, 8, 9, 16, 17, THIN_K, THIN_K + 1}):
        rng = np.random.default_rng(500 + k)
        phi = rng.integers(0, 90, (70, 1891))
        m = rng.integers(0, 90, (1891, k))
        cases[f"counts-thin-k{k}"] = (phi.astype(np.int32),
                                      m.astype(np.int32))
        cases[f"float-thin-k{k}"] = (phi.astype(np.float32),
                                     m.astype(np.float32))
    # each row's scalar head and tail about its 16-byte vectors (V % 4)
    for v in (3, 4, 5, 1891):
        rng = np.random.default_rng(600 + v)
        phi = rng.integers(0, 90, (33, v))
        m = rng.integers(0, 90, (v, 1))
        cases[f"counts-v{v}-k1"] = (phi.astype(np.int32), m.astype(np.int32))
        cases[f"float-v{v}-k1"] = (phi.astype(np.float32),
                                   m.astype(np.float32))
    # one row: V split over blocks, summed by the second pass
    rng = np.random.default_rng(700)
    cases["counts-split-1x2^20"] = (
        rng.integers(-100, 100, (1, 1 << 20)).astype(np.int32),
        rng.integers(-100, 100, ((1 << 20), 1)).astype(np.int32))
    cases["float-split-1x2^20"] = (
        rng.integers(0, 4, (1, 1 << 20)).astype(np.float32),
        rng.integers(0, 4, ((1 << 20), 1)).astype(np.float32))
    # misaligned pointers (see dense_tensors): V % 4 == 0, so only the
    # offset moves the rows off the 16-byte grid
    for k in (1, 3):
        phi = rng.integers(0, 90, (65, 1892))
        m = rng.integers(0, 90, (1892, k))
        cases[f"counts-offset-k{k}"] = (phi.astype(np.int32),
                                        m.astype(np.int32))
        cases[f"float-offset-k{k}"] = (phi.astype(np.float32),
                                       m.astype(np.float32))
    # K = 1: sums past 2^40, and products near 2^62 where int64 wraps
    cases["counts-past-2^40-k1"] = (
        rng.integers(1 << 23, 1 << 24, (65, 1891)).astype(np.int32),
        rng.integers(1 << 23, 1 << 24, (1891, 1)).astype(np.int32))
    cases["counts-int64-wrap-k1"] = (
        rng.integers((1 << 31) - (1 << 20), 1 << 31, (9, 64)).astype(np.int32),
        rng.integers((1 << 31) - (1 << 20), 1 << 31, (64, 1)).astype(np.int32))
    return cases


def dense_tensors(name, phi, m, device):
    """``phi`` and ``m`` of a dense case as tensors on ``device``.  In an
    ``-offset-`` case each is a contiguous view one element into a larger
    buffer, as ``phi_full[1:]`` is, so its pointer is off the 16-byte
    grid."""
    def put(a):
        t = torch.from_numpy(a).to(device)
        if "-offset-" not in name:
            return t
        full = torch.empty(a.size + 1, dtype=t.dtype, device=device)
        full[1:] = t.reshape(-1)
        return full[1:].view(a.shape)
    return put(phi), put(m)


def dense_oracle(phi, m):
    """numpy's answer: int64 (wrapping) for counts, f64 rounded to f32."""
    if phi.dtype == np.float32:
        return (phi.astype(np.float64) @ m.astype(np.float64)) \
            .astype(np.float32)
    return phi.astype(np.int64) @ m.astype(np.int64)


def numpy_message(phi, child, msg):
    """The numpy route of a message (``multiply`` then ``marginalize_out``),
    scattered into a dense int64 vector over the parent's codes."""
    ci = phi.var_index(child)
    V, P = phi.sizes[ci], phi.sizes[1 - ci]
    mf = type(phi).message((child,), np.arange(V)[:, None],
                           np.asarray(msg, np.int64), (V,))
    out = phi.multiply(mf).marginalize_out(child)
    dense = np.zeros(P, np.int64)
    dense[out.keys[:, 0]] = out.fac
    return dense
