"""Expansion cases shared by the CPU and the card tests of the port's kernel.

Mirrors the cases of tests/test_expand_fused.py: the parity sweep, empty
runs, a single run, K=1, a total that is not a tile multiple, and [K, 0]
outputs.  Inputs are made with numpy from fixed seeds.
"""

import numpy as np


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
    return cases


def bounds_of(freqs):
    """Inclusive prefix sums (int32) and the total they reach."""
    bounds = np.cumsum(freqs).astype(np.int32)
    return bounds, int(bounds[-1]) if len(bounds) else 0


def repeat_oracle(payloads, freqs):
    return np.stack([np.repeat(p, freqs) for p in payloads])


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
