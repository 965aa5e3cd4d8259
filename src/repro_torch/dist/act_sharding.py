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

The rest of the module is the one place where what a block makes meets
the mesh of the tensors it meets: plain constants become replicated
DTensors (:func:`replicated_like`), dims are made whole where a DTensor
op would refuse or mislay them (:func:`whole`, :func:`merged`,
:func:`splittable`), a placed cache is written in place
(:func:`write_at`), and work DTensor cannot express runs on plain
tensors on each rank (:func:`by_rows`: a recurrence on the rank's batch
rows; :func:`on_every_rank`: index work over the whole batch).  Each is
the identity, or runs its function as it is, on plain tensors, so the
single-device path is unchanged bit for bit.

The context is per thread.  Importing this module imports no DTensor
code (``torch.distributed.tensor`` takes over a second to import) and
touches no distributed state.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
    """``t``, a plain tensor a block makes itself from global shapes (rope
    angles, the vocab padding mask, masks, ids, a value to write into a
    placed cache), as a ``Replicate()`` DTensor on ``like``'s mesh when
    ``like`` is a DTensor (it is the same on every rank); ``t`` itself
    otherwise, or when it is a DTensor already.  DTensor ops refuse a
    plain operand, and its ``implicit_replication`` switch is per thread,
    which the backward pass on a card (autograd's device thread) does not
    see.  The blocks' other constants (causal masks, initial states) are
    made inside ``by_rows`` and ``on_every_rank``, on plain tensors."""
    if not is_dtensor(like) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def whole(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` redistributed so that no mesh dim shards its dim ``dim``
    (those mesh dims replicate it; the others keep their placements); a
    plain tensor, or a DTensor with ``dim`` whole, as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dim %= x.ndim
    if not any(p.is_shard(dim) for p in x.placements):
        return x
    return x.redistribute(placements=[
        Replicate() if p.is_shard(dim) else p for p in x.placements])


def _shards(x, dim: int) -> int:
    """How many shards a DTensor's mesh dims cut its dim ``dim`` into."""
    n = 1
    for i, p in enumerate(x.placements):
        if p.is_shard(dim % x.ndim):
            n *= x.device_mesh.size(i)
    return n


def splittable(x: torch.Tensor, dim: int, outer: int) -> torch.Tensor:
    """``x``, made whole on ``dim`` unless the number of its shards there
    divides ``outer``, the leading size an unflatten of ``dim`` gives it
    (DTensor refuses to "unflatten unevenly sharded" dims); a plain tensor
    as it is."""
    if not is_dtensor(x):
        return x
    return x if outer % _shards(x, dim) == 0 else whole(x, dim)


class _Merged(torch.autograd.Function):
    """``x.flatten(start, end)``, whose gradient is made whole on the
    merged dim, unless its shards divide ``x.shape[start]``, before it is
    unflattened back."""

    @staticmethod
    def forward(ctx, x, start, end):
        ctx.start, ctx.shape = start, tuple(x.shape)
        return x.flatten(start, end)

    @staticmethod
    def backward(ctx, g):
        g = splittable(g, ctx.start, ctx.shape[ctx.start])
        return g.reshape(ctx.shape), None, None


def merged(x: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """``x.flatten(start, end)`` (a weight merged into a matrix), and a
    gradient that can be unflattened again; a plain tensor's own
    ``flatten``.  A DTensor is first made whole on the merged dims after
    the first (a shard of an inner dim would leave a strided layout,
    whose every redistribution torch 2.13 plans by a graph search) and on
    the first if its shards do not divide it (8 KV heads on a 16-way
    axis, as ``SP_FSDP_RULES`` places them: DTensor refuses to "flatten
    unevenly sharded" dims)."""
    if not is_dtensor(x):
        return x.flatten(start, end)
    start, end = start % x.ndim, end % x.ndim
    if x.shape[start] % _shards(x, start):
        x = whole(x, start)
    for d in range(start + 1, end + 1):
        x = whole(x, d)
    return _Merged.apply(x, start, end)


def write_at(dst: torch.Tensor, dim: int, start: int,
             src: torch.Tensor) -> None:
    """``dst.narrow(dim, start, n).copy_(src)``, ``n = src.shape[dim]``,
    in place, whatever the placements of a DTensor ``dst`` (a placed
    cache): ``src`` is redistributed to ``dst``'s placements on every
    other dim and made whole on ``dim``, and each rank copies the rows of
    ``[start, start + n)`` that its shard of ``dim`` holds, so no rank
    gathers ``dst``.  A DTensor's sliced setitem would instead
    redistribute the slice of a sharded dim and write into a copy."""
    if not is_dtensor(dst):
        dst.narrow(dim, start, src.shape[dim]).copy_(src)
        return
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    dim %= dst.ndim
    mesh = dst.device_mesh
    n = src.shape[dim]
    src = replicated_like(src, dst)
    src = src.redistribute(mesh, [
        Replicate() if p.is_shard(dim) or not p.is_shard() else p
        for p in dst.placements]).to_local()
    size, off = compute_local_shape_and_global_offset(
        dst.shape, mesh, dst.placements)
    lo = max(start, off[dim])
    hi = min(start + n, off[dim] + size[dim])
    if lo < hi:
        dst.to_local().narrow(dim, lo - off[dim], hi - lo).copy_(
            src.narrow(dim, lo - start, hi - lo))


def _leaves_map(fn, t):
    if t is None:
        return None
    if isinstance(t, (tuple, list)):
        return type(t)(_leaves_map(fn, v) for v in t)
    if dataclasses.is_dataclass(t):
        return dataclasses.replace(t, **{
            f.name: _leaves_map(fn, getattr(t, f.name))
            for f in dataclasses.fields(t)})
    return fn(t)


def by_rows(fn, rows: tuple, weights: tuple = ()):
    """``fn(*rows, *weights)`` where every tensor of ``rows`` (and of the
    result: a tensor, or a tuple, list or dataclass of them) has the
    batch on dim 0 and ``fn`` treats its rows independently: a
    recurrence over time, such as sLSTM's.

    For DTensors each rank runs ``fn`` on plain tensors: its own batch
    rows of ``rows``, whole on every other dim (a mesh dim that shards
    anything but the batch is gathered), and ``weights`` whole.  So a
    loop of thousands of steps runs no collective and no DTensor
    dispatch inside; the ranks of a mesh dim that does not shard the
    batch repeat the same work.  Gradients flow back as DTensors: a
    weight's is a pending sum over the mesh dims that shard the batch.
    A plain ``rows[0]`` runs ``fn`` as it is."""
    if not is_dtensor(rows[0]):
        return fn(*rows, *weights)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    first = rows[0]
    mesh = first.device_mesh
    pl = [Shard(0) if p.is_shard(0) else Replicate()
          for p in first.placements]
    grad_w = [Partial() if p.is_shard() else Replicate() for p in pl]
    local = [summed(replicated_like(t, first)).redistribute(mesh, pl)
             .to_local() for t in rows]
    wl = [summed(replicated_like(w, first)).redistribute(
        mesh, [Replicate()] * mesh.ndim).to_local(grad_placements=grad_w)
        for w in weights]
    batch = first.shape[0]

    def back(t):
        # contiguous, as the global stride given says
        shape = (batch,) + tuple(t.shape[1:])
        return DTensor.from_local(t.contiguous(), mesh, pl, run_check=False,
                                  shape=shape, stride=torch.empty(
                                      shape, device="meta").stride())

    return _leaves_map(back, fn(*local, *wl))


def on_every_rank(fn, *tensors):
    """``fn(*tensors)``; for DTensors each rank runs ``fn`` on plain
    tensors, every input gathered whole (pending sums reduced), and the
    result (a tensor, or a tuple, list or dataclass of them) is
    ``Replicate()`` on the mesh: each rank computes the same.  For index
    work that DTensor has no rule for (torch 2.11's ``aten.index_put_``)
    and that needs every row: the MoE's capacity dispatch ranks each slot
    among all the batch's slots.  Gradients flow back as DTensors.
    Plain tensors run ``fn`` as they are."""
    mesh = next((t.device_mesh for t in tensors if is_dtensor(t)), None)
    if mesh is None:
        # through a view, as the placed path goes through ``to_local``:
        # the gradients ``fn`` gives an input are summed before they join
        # the input's other gradients, in the same order either way
        return fn(*(t.view_as(t) for t in tensors))
    from torch.distributed.tensor import DTensor, Replicate
    rep = [Replicate()] * mesh.ndim
    local = [summed(t).redistribute(mesh, rep).to_local()
             if is_dtensor(t) else t for t in tensors]

    def back(t):
        return DTensor.from_local(t, mesh, rep, run_check=False)

    return _leaves_map(back, fn(*local))


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
