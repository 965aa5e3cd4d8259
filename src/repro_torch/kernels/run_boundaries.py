"""`run_boundaries` — run-start flags over sorted keys (CUDA,
``csrc/run_boundaries.cu``).

Replaces the Pallas kernel ``src/repro/kernels/boundaries.py::
_boundaries_kernel``: ``flags[i] = 1`` iff ``i == 0`` or ``keys[i] !=
keys[i-1]``, over sorted keys ``[n]``; flags are int32 ``[n]``.  Keys are
int32 as in the reference, or int64 (the packed ranks that a device GROUP
BY sorts).  ``cumsum(flags) - 1`` gives the dense segment ids that
``mul_segsum`` takes.

Bound on the H100: HBM bytes, ``n * (key bytes + 4)`` over 3.35 TB/s.

A CPU tensor runs the plain version (``ref.run_boundaries_ref``); a CUDA
tensor launches the kernel or raises.  ``run_boundaries.launches`` counts
kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import run_boundaries_ref


def _bind() -> ctypes.CDLL:
    fn = build.load("run_boundaries").run_boundaries_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def run_boundaries(keys: torch.Tensor) -> torch.Tensor:
    """Run-start flags (int32) of the sorted 1-D int32 or int64 ``keys``."""
    if keys.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"run_boundaries takes int32 or int64 keys, got "
                        f"{keys.dtype}")
    if keys.dim() != 1:
        raise ValueError(f"run_boundaries needs keys [n], got "
                         f"{tuple(keys.shape)}")
    if keys.device.type == "cpu":
        return run_boundaries_ref(keys)
    if keys.device.type != "cuda":
        raise ValueError(f"run_boundaries runs on cuda or cpu, not "
                         f"{keys.device}")
    if not keys.is_contiguous():
        raise ValueError("run_boundaries needs contiguous keys")
    n = keys.shape[0]
    flags = torch.empty(n, dtype=torch.int32, device=keys.device)
    if n == 0:
        return flags
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        rc = _bind()(keys.data_ptr(), n, keys.element_size(),
                     flags.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"run_boundaries launch failed: CUDA error {rc}")
    run_boundaries.launches += 1
    return flags


run_boundaries.launches = 0
