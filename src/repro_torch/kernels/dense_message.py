"""`dense_message` — counting-semiring matrix product (CUDA, ``csrc/dense_message.cu``).

Replaces the Pallas kernel ``src/repro/kernels/dense_contract.py::
_dense_message_kernel``: ``[P, K] = phi[P, V] @ m[V, K]``, the sum-product
message of a densified potential, at exact sizes (no padding).  Two
instantiations of each kernel, picked by the inputs' dtype:

* int32 ``phi`` and ``m`` give an int64 result: 64-bit products summed in
  int64, equal to numpy's int64 route bit for bit (the TPU kernel sums in
  f32, exact only below 2^24);
* float32 inputs give float32, IEEE ``fmaf`` on the CUDA cores (never TF32).

Any other dtype, or two different ones, raises: there is no silent cast.
Non-contiguous inputs are made contiguous on the device.  A P, V or K of 0
launches nothing and returns zeros of shape ``[P, K]``.

Two kernels in ``csrc/dense_message.cu``: for ``K <= THIN_K`` (the
messages of ``engine.maybe_dense_message`` have K = 1) the thin kernel, a
warp per row streaming phi as 16-byte vectors, with V split over blocks
where P rows cannot fill the card; above it the 64 x 64 tiled kernel.
Bound on the H100: HBM bytes, ``(P*V + V*K) * 4 + P*K * out bytes``, at
thin K; multiply-adds over the card's rate for the type at wide K.

A CPU tensor runs the plain version (``ref.dense_message_ref``); a CUDA
tensor launches a kernel or raises.  ``dense_message.launches`` counts
kernel launches, and nothing else; ``dense_message.thin_launches`` counts
those that took the thin kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import dense_message_ref

I32_MAX = (1 << 31) - 1
TILE = 64                    # dense_message.cu's output tile, each way
MAX_K_TILES = 65535          # gridDim.y
# widest K the thin kernel takes: the crossover of chip_smoke.py's K sweep
# at [1892, 1892] @ [1892, K] (PERF.md §6)
THIN_K = 32
THIN_MAX_K = 64              # the thin kernel's widest instantiation
ROWS_PER_BLOCK = 8           # the thin kernel's rows, a warp each
MIN_SPLIT_V = 1024           # V a split keeps, at least


@functools.cache
def _bind(name: str):
    fn = getattr(build.load("dense_message"), name)
    long, ptr = ctypes.c_longlong, ctypes.c_void_p
    fn.argtypes = ([ptr, ptr, long, long, long, long, long, ptr, ptr, ptr]
                   if "thin" in name else
                   [ptr, ptr, long, long, long, ptr, ptr])
    fn.restype = ctypes.c_int
    return fn


def v_split(p: int, v: int, sms: int) -> tuple:
    """``(splits, vstep)`` of the thin kernel: V is cut over blocks only
    where P rows (one warp each) leave SMs idle, into steps of at least
    ``MIN_SPLIT_V`` that are multiples of 4."""
    fill = sms * ROWS_PER_BLOCK           # a block on every SM
    if p >= fill or v < 2 * MIN_SPLIT_V:
        return 1, v
    splits = min(-(-fill // p), v // MIN_SPLIT_V)
    step = -(-v // splits)
    step = -(-step // 4) * 4
    return -(-v // step), step


@functools.cache
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def dense_message(phi: torch.Tensor, m: torch.Tensor, *,
                  _thin_k: int = THIN_K) -> torch.Tensor:
    """``phi @ m`` in the counting semiring: int32 -> int64, float32 ->
    float32.  ``K <= THIN_K`` takes the thin kernel.  ``_thin_k`` (at most
    ``THIN_MAX_K``) moves that threshold, for chip_smoke.py's crossover
    sweep and the card tests, which force each kernel."""
    if phi.dtype != m.dtype or phi.dtype not in (torch.int32, torch.float32):
        raise TypeError(f"dense_message takes int32 or float32 phi and m of "
                        f"one dtype, got {phi.dtype} and {m.dtype}")
    if phi.dim() != 2 or m.dim() != 2 or phi.shape[1] != m.shape[0]:
        raise ValueError(f"dense_message needs phi [P, V] and m [V, K], got "
                         f"{tuple(phi.shape)} and {tuple(m.shape)}")
    if phi.device != m.device:
        raise ValueError(f"phi on {phi.device}, m on {m.device}")
    (p, v), k = phi.shape, m.shape[1]
    if max(p, v, k) > I32_MAX or -(-k // TILE) > MAX_K_TILES:
        raise ValueError(f"dense_message shape [{p}, {v}] @ [{v}, {k}] "
                         f"outside the kernel's grid")
    if phi.device.type == "cpu":
        return dense_message_ref(phi, m)
    if phi.device.type != "cuda":
        raise ValueError(f"dense_message runs on cuda or cpu, not "
                         f"{phi.device}")
    counts = phi.dtype == torch.int32
    acc = torch.int64 if counts else torch.float32
    if p == 0 or v == 0 or k == 0:
        return torch.zeros((p, k), dtype=acc, device=phi.device)
    phi, m = phi.contiguous(), m.contiguous()
    out = torch.empty((p, k), dtype=acc, device=phi.device)
    kind = "counts" if counts else "float"
    thin = k <= min(_thin_k, THIN_MAX_K)
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        if thin:
            splits, vstep = v_split(p, v, _sms(phi.device))
            part = torch.empty((splits, p, k), dtype=acc,
                               device=phi.device) if splits > 1 else None
            rc = _bind(f"dense_message_thin_{kind}_launch")(
                phi.data_ptr(), m.data_ptr(), p, v, k, splits, vstep,
                None if part is None else part.data_ptr(), out.data_ptr(),
                stream)
        else:
            rc = _bind(f"dense_message_{kind}_launch")(
                phi.data_ptr(), m.data_ptr(), p, v, k, out.data_ptr(),
                stream)
    if rc != 0:
        raise RuntimeError(f"dense_message launch failed: CUDA error {rc}")
    dense_message.launches += 1
    dense_message.thin_launches += thin
    return out


dense_message.launches = 0
dense_message.thin_launches = 0
