"""`mul_segsum` — fused multiply + segmented sum (CUDA, ``csrc/mul_segsum.cu``).

Replaces the Pallas kernel ``src/repro/kernels/segsum.py::
_mul_segsum_kernel``: ``out[s] = sum of x[i] * y[i] over seg[i] == s``,
for segment ids sorted ascending (int32 ``[n]``) and ``num_segments``
outputs, zero where a segment is empty.  Integers accumulate in int64 and
floats in float64 (the TPU kernel's f32 MXU sum is exact only below 2^24;
this one is exact wherever int64 is).  The wrapper casts narrower inputs to
the accumulation dtype on the device; one launch per call runs the kernel's
passes (tiles, then their carries) for that dtype.

Bound on the H100: HBM bytes, ``12 * n + 8 * num_segments`` over
3.35 TB/s.

A CPU tensor runs the plain version (``ref.mul_segsum_ref``); a CUDA tensor
launches the kernel or raises.  ``mul_segsum.launches`` counts kernel
launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import mul_segsum_ref

I32_MAX = (1 << 31) - 1


@functools.cache
def _bind():
    lib = build.load("mul_segsum")
    fn = lib.mul_segsum_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.mul_segsum_tile.argtypes = []
    lib.mul_segsum_tile.restype = ctypes.c_int
    return fn, lib.mul_segsum_tile()


def carry_len(n: int, tile: int) -> int:
    """Carry pairs the kernel's passes write for ``n`` entries: two per
    tile of every pass but the last (the kernel's own tiling)."""
    total = 0
    while n > tile:
        tiles = -(-n // tile)
        total += 2 * tiles
        n = 2 * tiles
    return total


def mul_segsum(seg: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               num_segments: int) -> torch.Tensor:
    """Per-segment sums of ``x * y`` over sorted ``seg`` (int64 or float64).

    Ids must lie in ``[0, num_segments)``.  The wrapper checks int64 ids
    (one pass, before the kernel's int32 cast could wrap one into range):
    an id outside raises ``ValueError`` on both devices.  An int32 id
    outside is not checked: the kernel drops its entry (the plain version
    raises).  The order is not checked, which would cost a pass over
    ``seg``.
    """
    if seg.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"mul_segsum takes int32 or int64 segment ids, got "
                        f"{seg.dtype}")
    for t in (x, y):
        if t.is_complex():
            raise TypeError(f"mul_segsum takes real values, got {t.dtype}")
    if seg.dim() != 1 or x.shape != seg.shape or y.shape != seg.shape:
        raise ValueError(f"mul_segsum needs seg, x, y of one shape [n], got "
                         f"{tuple(seg.shape)}, {tuple(x.shape)}, "
                         f"{tuple(y.shape)}")
    if not (seg.device == x.device == y.device):
        raise ValueError(f"seg on {seg.device}, x on {x.device}, y on "
                         f"{y.device}")
    num_segments = int(num_segments)
    n = seg.shape[0]
    if not 0 <= num_segments <= I32_MAX or (n and num_segments == 0):
        raise ValueError(f"num_segments {num_segments} outside [1, 2^31) "
                         f"for {n} entries")
    if seg.dtype == torch.int64 and n:
        lo, hi = (int(v) for v in torch.aminmax(seg))
        if lo < 0 or hi >= num_segments:
            raise ValueError(f"segment ids span [{lo}, {hi}], outside "
                             f"[0, {num_segments})")
    if seg.device.type == "cpu":
        return mul_segsum_ref(seg, x, y, num_segments)
    if seg.device.type != "cuda":
        raise ValueError(f"mul_segsum runs on cuda or cpu, not {seg.device}")
    floaty = x.is_floating_point() or y.is_floating_point()
    acc = torch.float64 if floaty else torch.int64
    out = torch.zeros(num_segments, dtype=acc, device=seg.device)
    if n == 0:
        return out
    seg = seg.to(torch.int32).contiguous()
    x = x.to(acc).contiguous()
    y = y.to(acc).contiguous()
    fn, tile = _bind()
    cap = carry_len(n, tile)
    carry_seg = torch.empty(cap, dtype=torch.int32, device=seg.device)
    carry_val = torch.empty(cap, dtype=acc, device=seg.device)
    with torch.cuda.device(seg.device):
        stream = torch.cuda.current_stream(seg.device).cuda_stream
        rc = fn(seg.data_ptr(), x.data_ptr(), y.data_ptr(), n, int(floaty),
                out.data_ptr(), num_segments, carry_seg.data_ptr(),
                carry_val.data_ptr(), cap, stream)
    if rc != 0:
        raise RuntimeError(f"mul_segsum launch failed: CUDA error {rc}")
    mul_segsum.launches += 1
    return out


mul_segsum.launches = 0
