"""Plain PyTorch versions of the port's kernels (the correctness references).

Each function computes exactly what its kernel computes, with no launch
details.  The wrappers run these for CPU tensors (the tests), and
``chip_smoke.py`` holds every kernel against them on the card.
"""

from __future__ import annotations

import torch


def expand_many_ref(payloads: torch.Tensor, bounds: torch.Tensor,
                    total: int) -> torch.Tensor:
    """RLE expansion of K rows: out[q, t] = payloads[q, r] where
    bounds[r-1] <= t < bounds[r] (``bounds`` inclusive prefix sums)."""
    t = torch.arange(total, dtype=bounds.dtype, device=bounds.device)
    idx = torch.searchsorted(bounds, t, right=True)
    idx.clamp_(max=max(payloads.shape[1] - 1, 0))
    return payloads[:, idx]


def run_boundaries_ref(keys: torch.Tensor) -> torch.Tensor:
    """flags[i] = 1 iff i == 0 or keys[i] != keys[i-1] (int32 flags)."""
    flags = torch.ones(keys.shape[0], dtype=torch.int32, device=keys.device)
    flags[1:] = (keys[1:] != keys[:-1]).to(torch.int32)
    return flags


def mul_segsum_ref(seg: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   num_segments: int) -> torch.Tensor:
    """out[s] = sum of x[i] * y[i] over seg[i] == s, in the accumulation
    dtype of ``x`` and ``y`` (int64 for integers, float64 for floats)."""
    acc = torch.float64 if x.is_floating_point() or y.is_floating_point() \
        else torch.int64
    out = torch.zeros(num_segments, dtype=acc, device=seg.device)
    return out.index_add_(0, seg.long(), x.to(acc) * y.to(acc))
