"""Primitive layers: norms, activations, rotary embeddings, the loss, and
the initialisers.

The reference declares every parameter through a ``ParamCollector``; here
each layer is an ``nn.Module`` that owns its parameters, created on the
device the model is built on (never as float32 on the host) and filled by
:func:`init_normal` from an explicit ``torch.Generator``.  The stddevs are
the reference's (``repro/models/layers.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


ONES = "ones"        # ``declare``'s ``std`` for a parameter of ones


def declare(module: nn.Module, name: str, shape: Sequence[int],
            dtype: torch.dtype, device: torch.device,
            std: Union[float, None, str]) -> None:
    """Register an uninitialised parameter ``name`` on ``module``, without
    gradients (``train_step.make_train_step`` turns them on).  ``std``
    is its normal initialiser's stddev, ``None`` for zeros (the
    reference's norm scales) or :data:`ONES` for ones (Mamba2's ``D``);
    :func:`init_normal` reads it from the module's ``init_stds``, which
    survives ``to_empty``."""
    module.register_parameter(name, nn.Parameter(
        torch.empty(tuple(shape), dtype=dtype, device=device),
        requires_grad=False))
    if "init_stds" not in module.__dict__:
        module.init_stds = {}
    module.init_stds[name] = std


def copy_state(dst, src) -> None:
    """Copy a recurrent state (a dataclass of tensors) into ``dst``'s
    tensors, in place."""
    for f in dataclasses.fields(dst):
        getattr(dst, f.name).copy_(getattr(src, f.name))


INIT_CHUNK = 1 << 26        # float32 draws per step: 256 MB at most


@torch.no_grad()
def init_normal(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every declared parameter under ``module``: normal draws in
    float32 times its stddev, cast to its dtype (the reference's
    ``normal_init``), or zeros, or ones.  Draws come from ``generator``,
    which lives on the parameters' device, in ``modules()`` order and
    ``INIT_CHUNK`` elements at a time."""
    for mod in module.modules():
        for name, std in mod.__dict__.get("init_stds", {}).items():
            flat = getattr(mod, name).view(-1)
            if std is None or std == ONES:
                flat.fill_(0 if std is None else 1)
                continue
            for lo in range(0, flat.numel(), INIT_CHUNK):
                part = flat[lo:lo + INIT_CHUNK]
                part.copy_(torch.randn(part.shape, generator=generator,
                                       device=part.device,
                                       dtype=torch.float32).mul_(std))


# ---------------------------------------------------------------------------
# functional layer ops
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Scales by ``1 + scale``, all in float32 (zero-initialised scales)."""
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def _relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(x))


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "silu":
        return F.silu
    if name == "gelu":
        return _gelu_tanh
    if name == "relu2":       # squared ReLU (nemotron-4)
        return _relu2
    raise ValueError(name)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    # theta as a Python scalar: pow in float32 on the device, and no
    # host-to-device copy (which would wait for the card) per call
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq].  Rotates the
    split halves (not interleaved pairs) with float32 angles."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)               # [hd/2]
    angles = positions[..., :, None].float() * freqs    # [..., seq, hd/2]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over valid positions; logits in float32 for stability."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels.long()[..., None],
                              dim=-1)[..., 0]
    nll = logz - ll
    if mask is not None:
        mask = mask.to(nll.dtype)
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
