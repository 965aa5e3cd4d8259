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


def expand_gather_ref(payload: torch.Tensor, bounds: torch.Tensor,
                      total: int) -> torch.Tensor:
    """Single-payload RLE expansion, the K=1 case of :func:`expand_many_ref`.

    A float32 payload is expanded as its int32 bit pattern, so NaN payloads
    and -0.0 come out bit for bit (the kernel copies words too)."""
    bits = payload.view(torch.int32)
    return expand_many_ref(bits[None], bounds, total)[0].view(payload.dtype)


# rows of phi per step of the chunked integer product: keeps each [rows, V,
# K] int64 broadcast at or below this many elements (512 MB)
_CHUNK_ELEMS = 1 << 26


def dense_message_ref(phi: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """[P, K] = phi[P, V] @ m[V, K] in the counting semiring.

    int32 inputs give the int64 product (wrapping mod 2^64 as int64 does);
    float32 inputs give float32, accumulated in float64 and then rounded,
    which equals an f32 sum wherever that sum is exact.  CUDA has no int64
    ``mm``, so there the integer product is formed by broadcasting, a few
    rows of ``phi`` at a time; it never goes through floating point.
    """
    if phi.is_floating_point():
        return (phi.double() @ m.double()).float()
    if phi.device.type == "cpu":
        return phi.long() @ m.long()
    return counts_by_rows(phi, m)


def counts_by_rows(phi: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The int64 product of int32 ``phi`` and ``m`` by broadcasting, a few
    rows of ``phi`` at a time (the CUDA branch of :func:`dense_message_ref`;
    it runs on any device)."""
    p, v = phi.shape
    k = m.shape[1]
    out = torch.zeros((p, k), dtype=torch.int64, device=phi.device)
    rows = max(1, _CHUNK_ELEMS // max(v * k, 1))
    m64 = m.long()
    for lo in range(0, p, rows):
        out[lo:lo + rows] = (phi[lo:lo + rows, :, None].long()
                             * m64[None]).sum(1)
    return out
