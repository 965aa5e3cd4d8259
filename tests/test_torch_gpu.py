"""The port's CUDA kernel against its plain version, on the card.

Marked ``gpu``: run on a machine with an NVIDIA card by
``pytest -m gpu tests/test_torch_gpu.py``.  Without a card each test skips
with its reason; whether a card is present is decided inside the test, so
every pytest worker collects the same tests.  Exact comparisons: the
kernel computes integer gathers.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.expand_many import expand_many
from repro_torch.kernels.ref import expand_many_ref

from torch_cases import bounds_of, expand_cases, repeat_oracle

pytestmark = pytest.mark.gpu

CASES = expand_cases()


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

