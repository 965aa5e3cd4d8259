"""`expand_gather` — single-payload RLE expansion (CUDA, ``csrc/expand_many.cu``).

Replaces the Pallas kernel ``src/repro/kernels/expand.py::_expand_kernel``:
``out[t] = payload[r]`` where ``bounds[r-1] <= t < bounds[r]``, ``[runs]``
-> ``[total]`` at exact sizes (no padding tail).  It is the K = 1 case of
:func:`~repro_torch.kernels.expand_many.expand_many` and launches the same
CUDA kernel through its own entry point, ``expand_gather_launch``; the TPU
had two kernels only because a Pallas ``BlockSpec`` fixes K.

The payload is int32 or float32.  A float32 payload is expanded as its
int32 bit pattern (``.view(torch.int32)``): the expansion is a bit copy, so
NaN payloads and -0.0 come out unchanged.

Bound on the H100: HBM bytes, ``(total + 2 * runs) * 4`` over 3.35 TB/s.

A CPU tensor runs the plain version (``ref.expand_gather_ref``); a CUDA
tensor launches the kernel or raises.  ``expand_gather.launches`` counts
kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import expand_gather_ref

I32_MAX = (1 << 31) - 1


def _bind():
    fn = build.load("expand_many").expand_gather_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def expand_gather(payload: torch.Tensor, bounds: torch.Tensor,
                  total: int) -> torch.Tensor:
    """RLE-expand ``payload`` by ``bounds`` (inclusive prefix sums).

    ``total`` must not exceed ``bounds[-1]``; the result has the payload's
    dtype.
    """
    if payload.dtype not in (torch.int32, torch.float32) \
            or bounds.dtype != torch.int32:
        raise TypeError(f"expand_gather takes an int32 or float32 payload "
                        f"and int32 bounds, got {payload.dtype} and "
                        f"{bounds.dtype}")
    if payload.dim() != 1 or bounds.dim() != 1 \
            or payload.shape[0] != bounds.shape[0]:
        raise ValueError(f"expand_gather needs payload [runs] and bounds "
                         f"[runs], got {tuple(payload.shape)} and "
                         f"{tuple(bounds.shape)}")
    if payload.device != bounds.device:
        raise ValueError(f"payload on {payload.device}, bounds on "
                         f"{bounds.device}")
    total = int(total)
    if not 0 <= total <= I32_MAX:
        raise ValueError(f"total {total} outside the int32 kernel range")
    runs = payload.shape[0]
    if runs == 0 and total:
        raise ValueError(f"total {total} > 0 with no runs")
    if payload.device.type == "cpu":
        return expand_gather_ref(payload, bounds, total)
    if payload.device.type != "cuda":
        raise ValueError(f"expand_gather runs on cuda or cpu, not "
                         f"{payload.device}")
    if not (payload.is_contiguous() and bounds.is_contiguous()):
        raise ValueError("expand_gather needs a contiguous payload and bounds")
    out = torch.empty(total, dtype=torch.int32, device=payload.device)
    if total:
        with torch.cuda.device(payload.device):
            stream = torch.cuda.current_stream(payload.device).cuda_stream
            rc = _bind()(payload.view(torch.int32).data_ptr(),
                         bounds.data_ptr(), runs, total, out.data_ptr(),
                         stream)
        if rc != 0:
            raise RuntimeError(f"expand_gather launch failed: CUDA error {rc}")
        expand_gather.launches += 1
    return out.view(payload.dtype)


expand_gather.launches = 0
