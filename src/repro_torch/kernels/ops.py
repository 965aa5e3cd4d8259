"""Public wrappers around the port's kernels — what the torch engine calls.

Each call counts a launch in ``kernels.launches`` (plus the bytes an
expansion writes in ``kernels.bytes_expanded``) and opens a
``kernel:<name>`` span, as the reference's ``kernels/ops.py`` does.  No
padding: the CUDA kernels take exact sizes, so the reference's power-of-two
buckets (which only bound a jit cache) have no counterpart here.  No
``exact=`` switch on ``mul_segsum`` either: the port's kernel accumulates
in int64 / float64, so it is the exact path.
"""

from __future__ import annotations

import torch

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
