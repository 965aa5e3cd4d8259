"""`dense_message` — counting-semiring matrix product (CUDA, ``csrc/dense_message.cu``).

Replaces the Pallas kernel ``src/repro/kernels/dense_contract.py::
_dense_message_kernel``: ``[P, K] = phi[P, V] @ m[V, K]``, the sum-product
message of a densified potential, at exact sizes (no padding).  Two
instantiations of one kernel, picked by the inputs' dtype:

* int32 ``phi`` and ``m`` give an int64 result: 64-bit products summed in
  int64, equal to numpy's int64 route bit for bit (the TPU kernel sums in
  f32, exact only below 2^24);
* float32 inputs give float32, IEEE ``fmaf`` on the CUDA cores (never TF32).

Any other dtype, or two different ones, raises: there is no silent cast.
Non-contiguous inputs are made contiguous on the device.  A P, V or K of 0
launches nothing and returns zeros of shape ``[P, K]``.

Bound on the H100: multiply-adds over the card's rate for the type (HBM
bytes, ``(P*V + V*K) * 4 + P*K * out bytes``, at K = 1).

A CPU tensor runs the plain version (``ref.dense_message_ref``); a CUDA
tensor launches the kernel or raises.  ``dense_message.launches`` counts
kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import dense_message_ref

I32_MAX = (1 << 31) - 1
TILE = 64                    # dense_message.cu's output tile, each way
MAX_K_TILES = 65535          # gridDim.y


def _bind(counts: bool):
    lib = build.load("dense_message")
    fn = lib.dense_message_counts_launch if counts \
        else lib.dense_message_float_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dense_message(phi: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``phi @ m`` in the counting semiring: int32 -> int64, float32 ->
    float32."""
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
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream(phi.device).cuda_stream
        rc = _bind(counts)(phi.data_ptr(), m.data_ptr(), p, v, k,
                           out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"dense_message launch failed: CUDA error {rc}")
    dense_message.launches += 1
    return out


dense_message.launches = 0
