"""Primitive layers: norms, activations, rotary embeddings, the loss, and
the initialisers.

The reference declares every parameter through a ``ParamCollector``; here
each layer is an ``nn.Module`` that owns its parameters, created on the
device the model is built on (never as float32 on the host) and filled by
:func:`init_normal` from an explicit ``torch.Generator``.  The stddevs are
the reference's (``repro/models/layers.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Iterator, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.act_sharding import (is_dtensor, replicated_like,
                                           summed, whole)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


ONES = "ones"        # ``declare``'s ``std`` for a parameter of ones


def declare(module: nn.Module, name: str, shape: Sequence[int],
            dtype: torch.dtype, axes: Sequence[Optional[str]],
            device: torch.device, std: Union[float, None, str]) -> None:
    """Register an uninitialised parameter ``name`` on ``module``, without
    gradients (``train_step.make_train_step`` turns them on).  ``axes``
    are its logical axes, one per dim (the reference's, which
    ``repro_torch.dist.sharding`` maps to mesh axes), kept in the
    module's ``param_axes``.  ``std`` is its normal initialiser's
    stddev, ``None`` for zeros (the reference's norm scales) or
    :data:`ONES` for ones (Mamba2's ``D``); :func:`init_normal` reads it
    from the module's ``init_stds``, which survives ``to_empty``."""
    axes = tuple(axes)
    assert len(axes) == len(shape), (name, tuple(shape), axes)
    module.register_parameter(name, nn.Parameter(
        torch.empty(tuple(shape), dtype=dtype, device=device),
        requires_grad=False))
    if "init_stds" not in module.__dict__:
        module.init_stds = {}
        module.param_axes = {}
    module.init_stds[name] = std
    module.param_axes[name] = axes


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
# loops on meta
# ---------------------------------------------------------------------------

_trip = threading.local()


def trip_count() -> int:
    """How many times the op now dispatched stands for: the product of
    the enclosing :func:`counted_as` (1 outside any; :func:`uniform_loop`
    sets it on meta); an op counter (``launch.op_analysis``) multiplies
    each op's count by it."""
    return getattr(_trip, "n", 1)


@contextlib.contextmanager
def counted_as(n: int) -> Iterator[None]:
    prev = trip_count()
    _trip.n = prev * n
    try:
        yield
    finally:
        _trip.n = prev


class _OneForMany(torch.autograd.Function):
    """``step(*inputs)`` run once, its ops counted ``n`` times in the
    forward and in the backward pass (the backward recomputes the step
    uncounted, then takes its gradient counted ``n`` times)."""

    @staticmethod
    def forward(ctx, step, n, *inputs):
        ctx.step, ctx.n = step, n
        ctx.save_for_backward(*inputs)
        with counted_as(n):
            return step(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        inputs = [t.detach().requires_grad_(t.requires_grad)
                  for t in ctx.saved_tensors]
        with torch.enable_grad():
            with counted_as(0):
                outs = ctx.step(*inputs)
            want = [i for i, t in enumerate(inputs) if t.requires_grad]
            with counted_as(ctx.n):
                got = torch.autograd.grad(
                    outs, [inputs[i] for i in want], grads,
                    allow_unused=True)
        out = [None] * len(inputs)
        for i, g in zip(want, got):
            out[i] = g
        return (None, None, *out)


def uniform_loop(step, n: int, carry: tuple = (), xs=lambda i: (),
                 consts: tuple = ()) -> tuple:
    """``n`` steps in order of ``step(i, *xs(i), *carry, *consts)``, which
    returns ``(y, carry)``: (the list of the steps' ``y``, the last
    carry).  Every step must have the same shapes, whatever ``i``.

    On real tensors this is the Python loop.  On meta tensors, which have
    shapes and no values (the dry run), the first and the last step run
    as they are and one more stands for the ``n - 2`` between: an op
    counter counts its ops ``n - 2`` times, forward and backward, as the
    reference's HLO analysis multiplies a ``while`` body by its trip
    count.  The ends differ from the steps between in the backward: the
    first takes no gradient of the carry it was given unless the caller's
    carry needs one, and the last none of a carry nobody reads.  ``step``
    must take every tensor that needs a gradient through ``xs``,
    ``carry`` or ``consts``, not from its closure: the counted backward
    reaches only those.  On meta, only plain tensors (a DTensor's layout
    may change from one step to the next)."""
    carry = tuple(carry)
    first = xs(0)
    if n <= 3 or not any(t.is_meta for t in (*first, *carry, *consts)):
        ys = []
        for i in range(n):
            y, carry = step(i, *(first if i == 0 else xs(i)), *carry,
                            *consts)
            ys.append(y)
        return ys, tuple(carry)
    y0, carry = step(0, *first, *carry, *consts)
    carry = tuple(carry)
    mid = xs(1)
    k, c = len(mid), len(carry)

    def flat(*a):
        y, out = step(1, *a[:k], *a[k:k + c], *a[k + c:])
        return (*out,) if y is None else (y, *out)

    ins = (*mid, *carry, *consts)
    assert all(t.is_meta and not is_dtensor(t) for t in ins)
    outs = _OneForMany.apply(flat, n - 2, *ins)
    y1 = None if y0 is None else outs[0]
    carry = tuple(outs[0 if y0 is None else 1:])
    y_last, carry = step(n - 1, *xs(n - 1), *carry, *consts)
    return [y0] + [y1] * (n - 2) + [y_last], tuple(carry)


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
    angles = replicated_like(angles, x)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# the embedding gather
# ---------------------------------------------------------------------------

def embed_lookup(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``F.embedding(ids, table)``.

    For a placed table (a DTensor) the gather runs on each rank's shards,
    as GSPMD partitions it: the table is first made whole on its embed
    dim (``SP_FSDP_RULES`` shards it there too); each rank looks up the
    ids that fall in its rows of the vocab, zeros the others, and the
    result is a pending sum (``Partial``) over the mesh dims that shard
    the vocab, and sharded as the ids are over the others.  DTensor's own
    masked gather fails on a table sharded on both dims (torch 2.13,
    ``MaskPartial.apply_mask``: "The shape of the mask ... does not match
    the shape of the indexed tensor"), and its backward refuses a
    gradient that arrives as a plain pending sum ("Redistribution from
    one partial type (P(sum)) to another (MaskP(sum ...)) is
    unsupported": the starcoder2 and nemotron train cells).  On a mesh
    of one rank every id falls in the rank's rows, and the result is the
    plain gather's, bit for bit."""
    if not is_dtensor(table):
        return F.embedding(ids, table)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    table = whole(table, 1)
    mesh, tpl = table.device_mesh, table.placements
    ids = replicated_like(ids, table)
    # a mesh dim that shards the vocab gives each of its ranks every id
    ids = ids.redistribute(mesh, [Replicate() if t.is_shard(0) else p
                                  for t, p in zip(tpl, ids.placements)])
    size, off = compute_local_shape_and_global_offset(table.shape, mesh,
                                                      tpl)
    out_pl = [Partial() if t.is_shard(0) else p
              for t, p in zip(tpl, ids.placements)]
    # the table's gradient sums over the ranks that looked up other ids
    grad_pl = [t if t.is_shard() else Partial() if p.is_shard()
               else Replicate() for t, p in zip(tpl, ids.placements)]
    local = ids.to_local()
    lo, hi = off[0], off[0] + size[0]
    inside = (local >= lo) & (local < hi)
    rows = F.embedding(torch.where(inside, local - lo, 0),
                       table.to_local(grad_placements=grad_pl))
    rows = torch.where(inside[..., None], rows, rows.new_zeros(()))
    shape = (*ids.shape, table.shape[1])
    return DTensor.from_local(rows, mesh, out_pl, run_check=False,
                              shape=shape,
                              stride=torch.empty(shape,
                                                 device="meta").stride())


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over valid positions; logits in float32 for stability.

    Logits placed on a mesh (a DTensor: the placed model's head) are first
    reduced where a mesh dim leaves them ``Partial`` (a head that
    contracts a sharded dim: gemma3's and Llama-3.2-Vision's under
    ``arch_rules``) and gathered whole on the ranks of a mesh dim that
    shards the vocab, as GSPMD is free to do; the label gather then runs
    on whole rows (DTensor's gather fails on a sharded or pending sum in
    torch 2.13: ``MaskPartial.apply_mask``, "too many indices")."""
    logits = whole(summed(logits.float()), -1)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, labels.long()[..., None],
                              dim=-1)[..., 0]
    nll = logz - ll
    if mask is not None:
        mask = mask.to(nll.dtype)
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
