"""`expand_many` — fused multi-payload RLE expansion (CUDA, ``csrc/expand_many.cu``).

Replaces the Pallas kernel ``src/repro/kernels/expand_fused.py::
_expand_many_kernel``.  K int32 payload rows ``[K, runs]`` share one array
of inclusive prefix sums ``bounds[runs]``; the result is the contiguous
``[K, total]`` int32 expansion, with no padding tail.  Desummarization
launches it once per GFJS level, generation once per psi.

Bound on the H100: HBM bytes, ``(K*total + K*runs + runs) * 4`` over
3.35 TB/s.  A block owns a tile of 2,048 outputs: it finds the tile's
run window with two searches, marks where each run begins in shared
memory, max-scans that into every output's run, and stores each payload
row as 16-byte vectors (see the source).

A CPU tensor runs the plain version (``ref.expand_many_ref``); a CUDA tensor
launches the kernel or raises.  ``expand_many.launches`` counts kernel
launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import expand_many_ref

I32_MAX = (1 << 31) - 1


@functools.cache
def _bind():
    fn = build.load("expand_many").expand_many_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def expand_many(payloads: torch.Tensor, bounds: torch.Tensor,
                total: int) -> torch.Tensor:
    """RLE-expand the K rows of ``payloads`` by the shared ``bounds``.

    ``total`` must not exceed ``bounds[-1]`` (it is the join size or the
    frontier total, which the callers know without a device sync).
    """
    if payloads.dtype != torch.int32 or bounds.dtype != torch.int32:
        raise TypeError(f"expand_many takes int32 payloads and bounds, got "
                        f"{payloads.dtype} and {bounds.dtype}")
    if payloads.dim() != 2 or bounds.dim() != 1 \
            or payloads.shape[1] != bounds.shape[0]:
        raise ValueError(f"expand_many needs payloads [K, runs] and bounds "
                         f"[runs], got {tuple(payloads.shape)} and "
                         f"{tuple(bounds.shape)}")
    if payloads.device != bounds.device:
        raise ValueError(f"payloads on {payloads.device}, bounds on "
                         f"{bounds.device}")
    total = int(total)
    if not 0 <= total <= I32_MAX:
        raise ValueError(f"total {total} outside the int32 kernel range")
    k, runs = payloads.shape
    if runs == 0 and total:
        raise ValueError(f"total {total} > 0 with no runs")
    if payloads.device.type == "cpu":
        return expand_many_ref(payloads, bounds, total)
    if payloads.device.type != "cuda":
        raise ValueError(f"expand_many runs on cuda or cpu, not "
                         f"{payloads.device}")
    if not (payloads.is_contiguous() and bounds.is_contiguous()):
        raise ValueError("expand_many needs contiguous payloads and bounds")
    out = torch.empty((k, total), dtype=torch.int32, device=payloads.device)
    if k == 0 or total == 0:
        return out
    with torch.cuda.device(payloads.device):
        stream = torch.cuda.current_stream(payloads.device).cuda_stream
        rc = _bind()(payloads.data_ptr(), bounds.data_ptr(), runs, total, k,
                     out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"expand_many launch failed: CUDA error {rc}")
    expand_many.launches += 1
    return out


expand_many.launches = 0
