"""Activation-sharding constraints as an ambient context
(``repro/dist/act_sharding.py``).

Model code calls :func:`constrain` on every residual-stream activation; by
default that's the identity, so single-device tests and benchmarks pay
nothing.  :func:`use` installs a ``(mesh, spec)`` context (a spec of
``repro_torch.dist.sharding``), turning every call into a
``DTensor.redistribute`` to the spec's placements, the counterpart of
``jax.lax.with_sharding_constraint`` -- model code never names mesh axes.
Under a context the activation must be a DTensor (the model's parameters
placed, ``launch.specs.place_params``): a plain tensor raises, it is
never wrapped or gathered quietly.

The context is per thread.  Importing this module imports no DTensor
code (``torch.distributed.tensor`` takes over a second to import) and
touches no distributed state.
"""

from __future__ import annotations

import contextlib
import sys
import threading
from typing import Iterator, Optional, Tuple

import torch

from repro_torch.dist.sharding import Spec, placements

_state = threading.local()


def current() -> Optional[Tuple[object, Spec]]:
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def use(mesh, spec: Spec) -> Iterator[None]:
    """Install an activation sharding constraint for the enclosed calls."""
    prev = current()
    _state.ctx = (mesh, tuple(spec))
    try:
        yield
    finally:
        _state.ctx = prev


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor; no tensor can be one while nothing has
    imported ``torch.distributed.tensor``, so this imports nothing."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def constrain(x: torch.Tensor) -> torch.Tensor:
    """Apply the ambient activation constraint (identity when unset)."""
    ctx = current()
    if ctx is None:
        return x
    mesh, spec = ctx
    if not is_dtensor(x):
        raise TypeError(f"an activation sharding constraint {spec} needs a "
                        f"DTensor activation (the model's parameters "
                        f"placed), not a plain {type(x).__name__}")
    return x.redistribute(mesh, placements(spec, mesh))


def replicated_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t``, a plain tensor the model makes itself from global shapes
    (rope angles, the vocab padding mask), as a ``Replicate()`` DTensor on
    ``like``'s mesh when ``like`` is a DTensor (it is the same on every
    rank); ``t`` itself otherwise.  DTensor ops refuse a plain operand,
    and its ``implicit_replication`` switch is per thread, which the
    backward pass on a card (autograd's device thread) does not see."""
    if not is_dtensor(like):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def summed(x: torch.Tensor) -> torch.Tensor:
    """``x`` with each pending sum (a ``Partial`` placement, as a gather
    from a vocab-sharded table leaves) reduced now, to ``Replicate()``;
    a plain tensor as it is.  A value read twice is then reduced once:
    torch 2.11's ``MaskPartial`` frees its mask at the first reduction,
    and the second fails ("assert self.mask_buffer.data is not None")."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(placements=[Replicate() if p.is_partial() else p
                                      for p in x.placements])
