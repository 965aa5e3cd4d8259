"""The port's fused RLE expansion against the reference's Pallas kernel.

``expand_many_ref`` and ``rle_expand_many`` on CPU tensors (the plain
version the wrapper runs there) against the reference's
``ops.rle_expand_many(..., interpret=True)`` and ``np.repeat``.  GJ is
integer arithmetic: every comparison is exact.
"""

import numpy as np
import pytest
import torch

from repro.core import engine_jax  # noqa: F401  (flips jax_enable_x64 on)
from repro.kernels import ops as jax_ops

from repro_torch.kernels import ops
from repro_torch.kernels.expand_many import expand_many
from repro_torch.kernels.ref import expand_many_ref
from repro_torch.obs.metrics import REGISTRY

from torch_cases import bounds_of, expand_cases, repeat_oracle

CASES = expand_cases()


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
