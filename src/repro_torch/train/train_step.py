"""The train step: loss -> grad -> clip -> AdamW, with optional microbatch
gradient accumulation (``repro/train/train_step.py``).

The reference jits a pure function of ``(state, batch)``.  Here the state's
parameters are the model's own ``nn.Parameter`` tensors: the step runs the
loss eagerly, takes its gradients with ``torch.autograd.grad`` and writes
the AdamW update into the parameters and moments in place, so a step holds
one copy of the state and one of the gradients.  Microbatches accumulate in
float32 in a Python loop where the reference uses ``lax.scan``.

The reference's explicit data-parallel mode is
:func:`make_dp_shard_map_step` with the int8 :func:`compressed_psum`.
Where the reference runs one ``shard_map`` body per device of a mesh axis,
here every rank of a ``torch.distributed`` world runs the step on its own
rows, and the axis's collectives are explicit ``dist.all_reduce`` calls
over that axis's process group (NCCL on the card, gloo on the CPU, as the
caller initialised it).  Both raise without an initialised process group.

The reference's GSPMD mode is the same ``make_train_step`` jitted with
``in_shardings``.  Here it is the same :func:`make_train_step`, made after
``launch.specs.place_params`` has replaced the model's parameters by
DTensors placed by the sharding rules, and given a batch placed by
``launch.specs.batch_shardings``: DTensor's sharding propagation inserts
the collectives, as GSPMD does, and the optimizer updates each rank's
shards (``train.optim``).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.dist.act_sharding import is_dtensor
from repro_torch.models.model import LM
from repro_torch.train.optim import (AdamWConfig, AdamWState, Tree,
                                     apply_updates, init_state)


class TrainState(NamedTuple):
    params: Tree
    opt: AdamWState


def init_train_state(lm: LM) -> TrainState:
    """The model's parameters (by state-dict name) and a fresh AdamW
    state beside them."""
    params = dict(lm.named_parameters())
    return TrainState(params, init_state(params))


def _grads_fn(lm: LM):
    """``lm``'s named parameters, their gradients turned on, and
    ``grads_of(batch) -> (loss, {name: gradient})``."""
    named = list(lm.named_parameters())
    for _, p in named:
        p.requires_grad_(True)

    def grads_of(batch) -> Tuple[torch.Tensor, Tree]:
        with torch.enable_grad():
            loss = lm.loss(batch)
            grads = torch.autograd.grad(loss, [p for _, p in named])
        loss = loss.detach()
        if is_dtensor(loss):
            loss = loss.full_tensor()
        return loss, {n: g for (n, _), g in zip(named, grads)}

    return named, grads_of


def _check_params(named, params: Tree) -> None:
    if any(params.get(n) is not p for n, p in named):
        raise ValueError("the state's params are not the model's "
                         "parameters (use init_train_state(lm))")


def make_train_step(
    lm: LM,
    opt_cfg: AdamWConfig,
    *,
    microbatches: int = 1,
) -> Callable[[TrainState, Dict[str, torch.Tensor]],
              Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``state.params`` must be ``lm``'s parameters (:func:`init_train_state`);
    the step turns their gradients on and updates them in place.  With
    ``microbatches > 1`` the batch's leading dim is split, and gradients
    and losses are summed in float32 and divided by ``microbatches``.
    """
    if microbatches < 1:
        raise ValueError(f"microbatches must be at least 1, not "
                         f"{microbatches}")
    named, grads_of = _grads_fn(lm)

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        _check_params(named, state.params)
        if microbatches == 1:
            loss, grads = grads_of(batch)
        else:
            def split(x: torch.Tensor) -> torch.Tensor:
                b = x.shape[0]
                if b % microbatches:
                    raise ValueError(f"batch {b} does not split into "
                                     f"{microbatches} microbatches")
                return x.reshape(microbatches, b // microbatches,
                                 *x.shape[1:])

            micro = {k: split(v) for k, v in batch.items()}
            gsum = {n: torch.zeros_like(p, dtype=torch.float32)
                    for n, p in named}
            lsum = torch.zeros((), dtype=torch.float32, device=lm.device)
            for i in range(microbatches):
                l, g = grads_of({k: v[i] for k, v in micro.items()})
                for n, acc in gsum.items():
                    acc.add_(g[n].float())
                lsum = lsum + l
                del g
            grads = {n: acc.div_(microbatches) for n, acc in gsum.items()}
            loss = lsum / microbatches

        params, opt, metrics = apply_updates(opt_cfg, state.params, grads,
                                             state.opt)
        metrics = dict(metrics, loss=loss)
        return TrainState(params, opt), metrics

    return step


# ---------------------------------------------------------------------------
# gradient compression (explicit-DP mode)
# ---------------------------------------------------------------------------

def _axis_size(group) -> float:
    """The number of ranks in ``group``, as the float the reference's
    ``psum(1.0)`` gives; raises without an initialised process group."""
    if not dist.is_initialized():
        raise RuntimeError("the data-parallel collectives need an "
                           "initialised process group "
                           "(torch.distributed.init_process_group)")
    return float(dist.get_world_size(group))


def compressed_psum(g: torch.Tensor, group,
                    residual: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8-quantized all-reduce with error feedback over ``group`` (the
    process group of one mesh axis); returns ``(mean, new_residual)``.

    The quantization scale is SHARED across the axis (one scalar all-reduce
    MAX), so summing the int8 payloads dequantizes exactly:
    sum(q_i) * s = sum(q_i * s).  Per-rank rounding error goes into the
    residual and is re-injected next step.  The reference's float32
    operations in its order; round half to even, as ``jnp.round``; the
    payload is summed as int32, so no int8 sum can overflow.
    """
    n = _axis_size(group)
    x = g.float()
    if residual is not None:
        x = x + residual
    amax = x.abs().max()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    new_residual = x - q.float() * scale
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    mean = total.float() * scale / n
    return mean, new_residual


def _mean(x: torch.Tensor, group) -> torch.Tensor:
    """The float32 mean over ``group``: an all-reduce SUM, then / n."""
    n = _axis_size(group)
    x = x.float()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x / n


class DPState(NamedTuple):
    params: Tree
    opt: AdamWState
    residual: Tree              # like the params, float32; this rank's own


def make_dp_shard_map_step(lm: LM, opt_cfg: AdamWConfig, mesh, *,
                           compress: bool = True, axis: str = "data"):
    """Explicit data-parallel step: per-rank gradients, an all-reduce over
    ``mesh``'s ``axis`` (:func:`compressed_psum` with ``compress``, else
    the float32 mean), the same AdamW update on every rank.  Returns
    ``(init, step)``.

    Parameters are replicated across ``axis`` (pure DP): every rank builds
    ``lm`` from the same seed, and ``init(params)`` takes its parameters
    (:func:`init_train_state`'s).  ``step(state, local_batch)`` takes this
    rank's rows of the global batch (rank ``r`` of ``b`` rows each: rows
    ``[r*b, (r+1)*b)``) and returns ``(DPState, {"loss", "grad_norm",
    "lr"})``, the loss the mean over the axis.  Each rank keeps its own
    error-feedback residual.
    """
    group = mesh.get_group(axis)
    named, grads_of = _grads_fn(lm)

    def init(params: Tree) -> DPState:
        return DPState(params, init_state(params),
                       {k: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)
                        for k, p in params.items()})

    def step(state: DPState, local_batch) -> Tuple[DPState, Dict]:
        _check_params(named, state.params)
        loss, grads = grads_of(local_batch)
        residual = dict(state.residual)
        for k in list(grads):       # leaf by leaf, each gradient freed
            if compress:
                grads[k], residual[k] = compressed_psum(grads[k], group,
                                                        residual[k])
            else:
                grads[k] = _mean(grads[k], group)
        loss = _mean(loss, group)
        params, opt, metrics = apply_updates(opt_cfg, state.params, grads,
                                             state.opt)
        return DPState(params, opt, residual), dict(metrics, loss=loss)

    return init, step
