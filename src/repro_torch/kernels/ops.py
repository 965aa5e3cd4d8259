"""Public wrappers around the port's kernels — what the torch engine calls.

Each call counts a launch in ``kernels.launches`` (plus the bytes an
expansion writes in ``kernels.bytes_expanded``) and opens a
``kernel:<name>`` span, as the reference's ``kernels/ops.py`` does.  No
padding: the CUDA kernels take exact sizes, so the reference's power-of-two
buckets (which only bound a jit cache) have no counterpart here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.expand_many import expand_many
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
