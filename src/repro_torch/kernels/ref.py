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
