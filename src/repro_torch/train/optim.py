"""Optimizer substrate: AdamW with global-norm clipping and schedules
(``repro/train/optim.py``).

The state mirrors the parameters: float32 ``m`` and ``v`` per leaf plus an
int32 scalar step.  Parameters may be bf16: each update is computed in
float32 and cast back, the mixed-precision arrangement whose footprint is
2 + 4 + 4 bytes a parameter.

Trees are flat ``{name: tensor}`` dicts.  :func:`apply_updates` writes the
new parameters, ``m`` and ``v`` into the tensors it is given, in the
reference's order of float32 operations, ``UPDATE_CHUNK`` elements at a
time: the reference's several full float32 temporaries per leaf would be
2.5 GB each for Qwen3-8B's embedding.  Nothing waits for the device: the
norm, the clip scale and the learning rate stay 0-dim tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Mapping, NamedTuple, Tuple, Union

import torch

Tree = Dict[str, torch.Tensor]

UPDATE_CHUNK = 1 << 24      # elements a step: 64 MB per float32 temporary


class AdamWState(NamedTuple):
    step: torch.Tensor          # [] int32
    m: Tree                     # like the params, float32
    v: Tree                     # like the params, float32


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: Union[int, torch.Tensor]
             ) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio, in float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * frac


def init_state(params: Mapping[str, torch.Tensor]) -> AdamWState:
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    dev = next(iter(params.values())).device if params else None
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev), zeros,
                      {k: z.clone() for k, z in zeros.items()})


def _chunks(t: torch.Tensor):
    flat = t.view(-1)
    for lo in range(0, flat.numel(), UPDATE_CHUNK):
        yield flat[lo:lo + UPDATE_CHUNK]


@torch.no_grad()
def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every leaf."""
    total = None
    for leaf in tree.values():
        for c in _chunks(leaf):
            c = c.float()
            s = (c * c).sum()
            total = s if total is None else total + s
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Tree, grads: Mapping[str,
                  torch.Tensor], state: AdamWState
                  ) -> Tuple[Tree, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step, written into ``params``, ``state.m`` and
    ``state.v``; returns them with the new step and
    ``{"grad_norm", "lr"}``."""
    step = state.step + 1
    lr = schedule(cfg, step)

    gnorm = global_norm(grads)
    if cfg.grad_clip > 0:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)

    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)

    for k, p in params.items():
        for pc, gc, mc, vc in zip(_chunks(p), _chunks(grads[k]),
                                  _chunks(state.m[k]), _chunks(state.v[k])):
            # the reference's upd(), one rounding per operation
            g = gc.float() * scale
            mc.mul_(b1).add_(g * (1 - b1))
            vc.mul_(b2).add_(g * (1 - b2) * g)
            delta = (mc / bc1) / (torch.sqrt(vc / bc2) + cfg.eps)
            pf = pc.float()
            if cfg.weight_decay > 0:
                delta = delta + cfg.weight_decay * pf
            pc.copy_(pf - lr * delta)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, AdamWState(step, state.m, state.v), metrics
