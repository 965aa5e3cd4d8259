"""Mixture-of-Experts block: top-k routing, shared experts and GShard-style
capacity dispatch (``repro/models/moe.py``).

Every (token, k) slot, in slot order ``t*k + j``, takes its rank among the
earlier slots routed to the same expert; a slot whose rank is below the
capacity is copied into its expert's buffer row ``[E, cap, d]``, the
three expert products run as batched matrix products over ``E``, and the
weighted outputs come back to their tokens.  Slots at or past the
capacity are dropped, as in GShard / Switch.  ``cap`` follows the
reference's rule with ``n_tok = B*S`` at every call, so a decode step
(``S = 1``) routes ``B`` tokens against a capacity of ``B*k/E`` slots
times the capacity factor.

Two choices keep the port equal to the reference and the card
deterministic:

* the top-k is a stable descending sort, so equal probabilities go to the
  lower expert index, as ``jax.lax.top_k`` breaks ties;
* kept slots own distinct buffer rows, so dispatch is a plain indexed
  copy, and the combine weights the gathered outputs and sums the ``k``
  slots of each token in one reduction, with no atomic adds (the
  reference's ``.at[].add``; ``index_add_`` on the card adds in no fixed
  order).

On placed parameters the routing, the dispatch and the combine run on
every rank over the whole batch (``act_sharding.on_every_rank``: the
capacity ranks each slot among all of the batch's slots, and torch 2.11's
DTensor has no rule for the indexed copy), and the experts' products run
on DTensors under the rules' ``experts`` and ``moe_ff`` axes.  The
reference's ``shard`` hook (expert parallelism over a mesh axis by
``shard_map``) is not ported.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.dist.act_sharding import on_every_rank
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import activation_fn, declare, dtype_of


def capacity(n_tok: int, k: int, num_experts: int, factor: float) -> int:
    """Buffer rows per expert: the reference's expression, term for term
    (its float rounding decides the ceiling)."""
    return max(int(math.ceil(n_tok * k / num_experts * factor)), 1)


class MoEBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device: torch.device) -> None:
        super().__init__()
        assert cfg.moe is not None
        self.cfg = cfg
        m = cfg.moe
        d, E, f = cfg.d_model, m.num_experts, m.d_ff_expert
        dt = dtype_of(cfg.param_dtype)
        # the router is float32 whatever the parameters' dtype, as the
        # reference declares it
        declare(self, "router", (d, E), torch.float32, ("embed", "experts"),
                device, d ** -0.5)
        declare(self, "w_gate", (E, d, f), dt, ("experts", "embed", "moe_ff"),
                device, d ** -0.5)
        declare(self, "w_up", (E, d, f), dt, ("experts", "embed", "moe_ff"),
                device, d ** -0.5)
        declare(self, "w_down", (E, f, d), dt, ("experts", "moe_ff", "embed"),
                device, f ** -0.5)
        if m.shared_experts:
            ff = f * m.shared_experts
            declare(self, "sh_gate", (d, ff), dt, ("embed", "ff"), device,
                    d ** -0.5)
            declare(self, "sh_up", (d, ff), dt, ("embed", "ff"), device,
                    d ** -0.5)
            declare(self, "sh_down", (ff, d), dt, ("ff", "embed"), device,
                    ff ** -0.5)
        self.act = activation_fn(cfg.activation)

    def route(self, xt: torch.Tensor, router=None):
        """Routing in float32: (expert ids [T, k], weights [T, k])."""
        k = self.cfg.moe.experts_per_token
        router = self.router if router is None else router
        probs = torch.softmax(xt.float() @ router, dim=-1)
        top_w, top_e = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
        top_w, top_e = top_w[:, :k], top_e[:, :k]
        top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
        return top_e, top_w

    def dispatch(self, top_e: torch.Tensor, cap: int):
        """Each slot's buffer row, in slot order ``t*k + j``, and whether
        it is kept: (rows [T*k], kept [T*k]); a dropped slot's row is the
        spare ``E * cap``."""
        E = self.cfg.moe.num_experts
        slot_e = top_e.reshape(-1)
        # rank among earlier slots on the same expert: an inclusive running
        # count over the one-hot slots, minus one
        onehot = (slot_e[:, None] == torch.arange(E, device=slot_e.device)
                  ).to(torch.int32)
        rank = torch.cumsum(onehot, 0, dtype=torch.int32).gather(
            1, slot_e[:, None])[:, 0] - 1
        keep = rank < cap
        return torch.where(keep, slot_e * cap + rank, E * cap), keep

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = self.cfg.moe
        B, S, d = x.shape
        n_tok = B * S
        k, E = m.experts_per_token, m.num_experts
        xt = x.reshape(n_tok, d)
        cap = capacity(n_tok, k, E, m.capacity_factor)
        drop = E * cap                     # one spare row takes every drop

        # --- routing and capacity-based dispatch ------------------------------
        # placed: on every rank over the whole batch (a slot's rank counts
        # every earlier slot), on plain tensors
        def dispatch(xt, router):
            top_e, top_w = self.route(xt, router)
            buf_idx, keep = self.dispatch(top_e, cap)
            buf = xt.new_zeros((drop + 1, d))
            buf[buf_idx] = xt.repeat_interleave(k, dim=0)
            # dropped slots weigh 0
            w = top_w.reshape(-1).to(x.dtype) * keep.to(x.dtype)
            return buf[:-1].view(E, cap, d), buf_idx, w

        buf, buf_idx, w = on_every_rank(dispatch, xt, self.router)

        # --- expert FFNs, batched over E --------------------------------------
        g = self.act(torch.bmm(buf, self.w_gate.to(x.dtype)))
        u = torch.bmm(buf, self.w_up.to(x.dtype))
        h = torch.bmm(g * u, self.w_down.to(x.dtype))

        # --- combine ------------------------------------------------------------
        def combine(h, buf_idx, w):
            out = h.view(drop, d)[torch.clamp(buf_idx, max=drop - 1)] \
                * w[:, None]
            return out.view(n_tok, k, d).sum(1)

        y = on_every_rank(combine, h, buf_idx, w)

        # --- shared experts ---------------------------------------------------
        if m.shared_experts:
            sg = self.act(xt @ self.sh_gate.to(x.dtype))
            su = xt @ self.sh_up.to(x.dtype)
            y = y + (sg * su) @ self.sh_down.to(x.dtype)
        return y.view(B, S, d)
