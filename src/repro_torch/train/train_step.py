"""The train step: loss -> grad -> clip -> AdamW, with optional microbatch
gradient accumulation (``repro/train/train_step.py``).

The reference jits a pure function of ``(state, batch)``.  Here the state's
parameters are the model's own ``nn.Parameter`` tensors: the step runs the
loss eagerly, takes its gradients with ``torch.autograd.grad`` and writes
the AdamW update into the parameters and moments in place, so a step holds
one copy of the state and one of the gradients.  Microbatches accumulate in
float32 in a Python loop where the reference uses ``lax.scan``.

The reference's explicit data-parallel mode (``make_dp_shard_map_step``
with the int8 :func:`compressed_psum`) needs several devices and is not
ported yet: both raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.models.model import LM
from repro_torch.train.optim import (AdamWConfig, AdamWState, Tree,
                                     apply_updates, init_state)

DP_WAITS = ("is not ported yet (ROADMAP.md queue 1 item 6: sharding and "
            "everything that needs more than one device)")


class TrainState(NamedTuple):
    params: Tree
    opt: AdamWState


def init_train_state(lm: LM) -> TrainState:
    """The model's parameters (by state-dict name) and a fresh AdamW
    state beside them."""
    params = dict(lm.named_parameters())
    return TrainState(params, init_state(params))


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
    named = list(lm.named_parameters())
    for _, p in named:
        p.requires_grad_(True)

    def grads_of(batch) -> Tuple[torch.Tensor, Tree]:
        with torch.enable_grad():
            loss = lm.loss(batch)
            grads = torch.autograd.grad(loss, [p for _, p in named])
        return loss.detach(), {n: g for (n, _), g in zip(named, grads)}

    def step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        if any(state.params.get(n) is not p for n, p in named):
            raise ValueError("the state's params are not the model's "
                             "parameters (use init_train_state(lm))")
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
            gsum = {n: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device) for n, p in named}
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


def compressed_psum(*_, **__):
    raise NotImplementedError(f"compressed_psum {DP_WAITS}")


def make_dp_shard_map_step(*_, **__):
    raise NotImplementedError(f"the dp_shard_map train step {DP_WAITS}")
