"""Public wrappers around the port's kernels — what the torch engine calls.

Each call counts a launch in ``kernels.launches`` (plus the bytes an
expansion writes in ``kernels.bytes_expanded``) and opens a
``kernel:<name>`` span, as the reference's ``kernels/ops.py`` does.  No
padding: the CUDA kernels take exact sizes, so the reference's power-of-two
buckets (which only bound a jit cache) have no counterpart here, and no
``next_bucket`` or ``interpret=`` either.  No ``exact=`` switch on
``mul_segsum``: the port's kernel accumulates in int64 / float64, so it is
the exact path.  ``dense_message`` on int32 counts is exact in int64 (the
reference's f32 MXU product is exact only below 2^24).

The launch metadata of an expansion is only the int32 bounds on the
device: each output position finds its run by a binary search, with no
per-tile window to precompute.  ``gfjs_expand_meta`` memoizes it per GFJS
level, as the reference memoizes its padded bounds and tile starts.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.dense_message import \
    dense_message as _dense_message
from repro_torch.kernels.expand_gather import expand_gather
from repro_torch.kernels.expand_many import expand_many
from repro_torch.kernels.mul_segsum import mul_segsum as _mul_segsum
from repro_torch.kernels.run_boundaries import \
    run_boundaries as _run_boundaries
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.trace import span as _span


def _launch(kernel: str, expanded_bytes: int = 0, **args):
    """Count a kernel call (+ bytes written by expansions) and open a
    device-annotated span (the ambient no-op when tracing is off)."""
    REGISTRY.counter("kernels.launches").inc()
    if expanded_bytes:
        REGISTRY.counter("kernels.bytes_expanded", unit="B").inc(
            expanded_bytes)
    return _span(f"kernel:{kernel}", cat="kernel", device=True, **args)


I32_MAX = (1 << 31) - 1


def rle_expand(payload: torch.Tensor, bounds: torch.Tensor, total: int,
               meta: torch.Tensor = None) -> torch.Tensor:
    """Expand one payload (int32 or float32) by its RLE: [runs] -> [total].

    ``meta`` is the device bounds from :func:`expand_meta` or
    :func:`gfjs_expand_meta` (the memoized path for levels expanded again);
    when given, it replaces ``bounds``.
    """
    bounds = bounds if meta is None else meta
    with _launch("rle_expand", expanded_bytes=int(total) * 4,
                 runs=int(payload.shape[0]), total=int(total),
                 dtype=str(payload.dtype).removeprefix("torch.")):
        return expand_gather(payload, bounds, total)


def expand_indices(bounds: torch.Tensor, total: int) -> torch.Tensor:
    """Source-run index per output position (frontier expansion's ``src``)."""
    payload = torch.arange(bounds.shape[0], dtype=torch.int32,
                           device=bounds.device)
    return rle_expand(payload, bounds, total)


def expand_meta(bounds, device=None) -> torch.Tensor:
    """Launch metadata for expanding by ``bounds``: the int32 bounds,
    contiguous, on ``device`` (by default a tensor's own device, the card
    for an array).  The cast runs where the bounds are, so an upload moves
    4 bytes per run."""
    if isinstance(bounds, torch.Tensor):
        dev = bounds.device if device is None else torch.device(device)
    else:
        bounds = torch.from_numpy(np.asarray(bounds))
        dev = torch.device("cuda" if device is None else device)
    if bounds.numel() and int(bounds[-1]) > I32_MAX:
        raise ValueError(f"bounds reach {int(bounds[-1])}, past the int32 "
                         f"kernel range")
    return bounds.to(torch.int32).to(dev).contiguous()


def gfjs_expand_meta(gfjs, level: int, device) -> torch.Tensor:
    """Memoized launch metadata for expanding one GFJS level on ``device``.

    Cached on ``GFJS._launch`` beside the ``_bounds`` prefix sums, so a
    second desummarize of the same GFJS uploads no bounds.  One entry per
    level: a different device replaces it, so the memo stays bounded and
    ``GFJS.aux_nbytes`` counts it.
    """
    dev = torch.device(device)
    hit = gfjs._launch.get(level)
    if hit is None or hit[0] != dev:
        hit = (dev, (expand_meta(gfjs.bounds(level), dev),))
        gfjs._launch[level] = hit
    return hit[1][0]


def rle_expand_many(payloads: torch.Tensor, bounds: torch.Tensor,
                    total: int) -> torch.Tensor:
    """Expand K int32 payload rows sharing one RLE: [K, runs] -> [K, total].

    One fused kernel launch: the run search is done once per output
    position and reused for all K rows (the codes of every variable of a
    GFJS level, or the frontier columns plus the (src, CSR start, offset)
    index columns of one generation step).
    """
    k, runs = payloads.shape
    with _launch("rle_expand_many", expanded_bytes=k * int(total) * 4,
                 k=k, runs=runs, total=int(total)):
        return expand_many(payloads, bounds, total)


def mul_segsum(seg: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               num_segments: int) -> torch.Tensor:
    """Per-segment sum of x*y over sorted segment ids (int64 / float64)."""
    with _launch("mul_segsum", n=int(seg.shape[0]),
                 segments=int(num_segments),
                 dtype="float64" if x.is_floating_point()
                 or y.is_floating_point() else "int64"):
        return _mul_segsum(seg, x, y, num_segments)


def run_boundaries(keys: torch.Tensor) -> torch.Tensor:
    """Run-start flags (int32) over sorted int32 / int64 keys."""
    with _launch("run_boundaries", n=int(keys.shape[0]),
                 key_bytes=keys.element_size()):
        return _run_boundaries(keys)


def group_by_count(keys: torch.Tensor):
    """GROUP BY sorted keys: (segment ids int32, counts int64, num_groups).

    Composition of the two build kernels: run_boundaries -> cumsum ->
    mul_segsum(ones, ones).  One host sync, for the group count.
    """
    flags = run_boundaries(keys)
    seg = torch.cumsum(flags, 0, dtype=torch.int32).sub_(1)
    num = int(seg[-1]) + 1 if seg.numel() else 0
    ones = torch.ones(seg.shape[0], dtype=torch.int64, device=seg.device)
    counts = mul_segsum(seg, ones, ones, num)
    return seg, counts, num


def dense_message(phi: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """[P, K] = phi[P, V] @ m[V, K] in the counting semiring (int32 -> int64
    counts, float32 -> float32)."""
    with _launch("dense_message", p=int(phi.shape[0]), v=int(phi.shape[1]),
                 k=int(m.shape[1]) if m.dim() == 2 else 0,
                 dtype=str(phi.dtype).removeprefix("torch.")):
        return _dense_message(phi, m)
