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
