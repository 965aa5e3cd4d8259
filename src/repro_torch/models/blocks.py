"""Layer blocks and the layer stack.

The reference (``repro/models/blocks.py``) stacks the parameters of n
identical blocks on a leading axis and applies them with ``lax.scan``,
so that XLA compiles one block body per group.  Eager PyTorch has no
compile to keep small, so :class:`ScanStack` is a ``ModuleList`` of n
blocks applied in a Python loop, and its cache is a list of per-layer
caches updated in place.  ``repro_torch.interop`` maps the reference's
stacked ``[n, ...]`` parameters onto the stack's layers, reading each
stack's ``prefix``: the reference's name of its block (``b``, ``m``,
``xm``), empty for a unit, which names its parts itself.

Every cache is updated in place, the recurrent states of ``Mamba2Layer``
and ``XLSTMLayer`` as much as the KV caches: ``prefill`` and ``decode``
return the cache they were given.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.attention import GQAttention, KVCache, MLAttention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (activation_fn, copy_state, declare,
                                      dtype_of, rms_norm)
from repro_torch.models.moe import MoEBlock
from repro_torch.models.ssm import Mamba2Block, SSMState
from repro_torch.models.xlstm import MLSTMBlock, SLSTMBlock


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device: torch.device,
                 d_ff: Optional[int] = None) -> None:
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        ff = d_ff or cfg.d_ff
        dt = dtype_of(cfg.param_dtype)
        if cfg.gated_mlp:
            declare(self, "w_gate", (d, ff), dt, device, d ** -0.5)
        declare(self, "w_up", (d, ff), dt, device, d ** -0.5)
        declare(self, "w_down", (ff, d), dt, device, ff ** -0.5)
        self.act = activation_fn(cfg.activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        u = x @ self.w_up.to(x.dtype)
        if self.cfg.gated_mlp:
            h = self.act(x @ self.w_gate.to(x.dtype)) * u
        else:
            h = self.act(u)
        return h @ self.w_down.to(x.dtype)


# ---------------------------------------------------------------------------
# standard pre-norm transformer block (attention + MLP/MoE)
# ---------------------------------------------------------------------------

class TransformerBlock(nn.Module):
    """Pre-norm block.  Variants: GQA/MLA attention, qk-norm, sliding
    window, softcap, MoE FFN, and (``cross=True``, vlm) GQA cross-
    attention to a ``kv_src`` of ``cfg.vlm.vision_dim``, MLA or not, as
    in the reference.  The FFN is the attribute ``moe`` or ``mlp``, the
    reference's parameter prefixes."""

    prefix = "b"

    def __init__(self, cfg: ModelConfig, *, device: torch.device,
                 window: int = 0, use_moe: bool = False,
                 cross: bool = False) -> None:
        super().__init__()
        self.cfg = cfg
        self.window = window
        dt = dtype_of(cfg.param_dtype)
        declare(self, "ln1", (cfg.d_model,), dt, device, None)
        declare(self, "ln2", (cfg.d_model,), dt, device, None)
        if cfg.mla is not None and not cross:
            self.attn = MLAttention(cfg, device=device)
        else:
            self.attn = GQAttention(
                cfg, device=device,
                kv_dim=cfg.vlm.vision_dim if cross and cfg.vlm else None)
        if use_moe:
            self.moe = MoEBlock(cfg, device=device)
        else:
            self.mlp = MLP(cfg, device=device)
        self.use_moe = use_moe

    def _ffn(self, h):
        return self.moe(h) if self.use_moe else self.mlp(h)

    def forward(self, x, positions, *, kv_src=None):
        cfg = self.cfg
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        kw = {} if kv_src is None else {"kv_src": kv_src}
        x = x + self.attn(h, positions, window=self.window, **kw)
        h = rms_norm(x, self.ln2, cfg.norm_eps)
        return x + self._ffn(h)

    def init_cache(self, batch: int, s_max: int) -> KVCache:
        return self.attn.init_cache(batch, s_max)

    def prefill(self, x, positions, cache: KVCache):
        cfg = self.cfg
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        a, cache = self.attn.prefill(h, positions, cache, window=self.window)
        x = x + a
        h = rms_norm(x, self.ln2, cfg.norm_eps)
        return x + self._ffn(h), cache

    def decode(self, x, cache: KVCache):
        cfg = self.cfg
        h = rms_norm(x, self.ln1, cfg.norm_eps)
        a, cache = self.attn.decode(h, cache, window=self.window)
        x = x + a
        h = rms_norm(x, self.ln2, cfg.norm_eps)
        return x + self._ffn(h), cache


class Mamba2Layer(nn.Module):
    """Pre-norm Mamba2 block (the zamba2 backbone layer)."""

    prefix = "m"

    def __init__(self, cfg: ModelConfig, *, device: torch.device) -> None:
        super().__init__()
        self.cfg = cfg
        declare(self, "ln", (cfg.d_model,), dtype_of(cfg.param_dtype),
                device, None)
        self.ssm = Mamba2Block(cfg, device=device)

    def forward(self, x, positions):
        return x + self.ssm(rms_norm(x, self.ln, self.cfg.norm_eps))

    def init_cache(self, batch: int, s_max: int) -> SSMState:
        return self.ssm.init_state(batch)

    def prefill(self, x, positions, cache: SSMState):
        y, state = self.ssm(rms_norm(x, self.ln, self.cfg.norm_eps),
                            return_state=True)
        copy_state(cache, state)
        return x + y, cache

    def decode(self, x, cache: SSMState):
        h = rms_norm(x, self.ln, self.cfg.norm_eps)
        return x + self.ssm.decode(h, cache), cache


class XLSTMLayer(nn.Module):
    """Pre-norm wrapper around an mLSTM (``kind="m"``) or sLSTM (``"s"``)
    block; its prefill runs the block's forward and keeps the final
    state."""

    def __init__(self, cfg: ModelConfig, kind: str, *,
                 device: torch.device) -> None:
        super().__init__()
        self.cfg = cfg
        self.prefix = "x" + kind
        declare(self, "ln", (cfg.d_model,), dtype_of(cfg.param_dtype),
                device, None)
        self.cell = (MLSTMBlock if kind == "m" else SLSTMBlock)(
            cfg, device=device)

    def forward(self, x, positions):
        return x + self.cell(rms_norm(x, self.ln, self.cfg.norm_eps))

    def init_cache(self, batch: int, s_max: int):
        return self.cell.init_state(batch)

    def prefill(self, x, positions, cache):
        y, state = self.cell(rms_norm(x, self.ln, self.cfg.norm_eps),
                             return_state=True)
        copy_state(cache, state)
        return x + y, cache

    def decode(self, x, cache):
        h = rms_norm(x, self.ln, self.cfg.norm_eps)
        return x + self.cell.decode(h, cache), cache


# ---------------------------------------------------------------------------
# ScanStack
# ---------------------------------------------------------------------------

class ScanStack(nn.ModuleList):
    """n structurally identical blocks applied in order.

    Keyword arguments of ``forward``, ``init_cache``, ``prefill`` and
    ``decode`` go to every block (a zamba2 unit's shared attention
    block, a vlm unit's image context).  With ``remat`` (the reference's
    ``jax.checkpoint`` per stacked block, ``cfg.remat != "none"``), a
    forward that autograd records keeps only each block's input and
    recomputes the block in the backward pass (its keyword tensors are
    saved as inputs, so the image context's gradient flows back to
    ``vision_norm``); prefill, decode and forwards without gradients run
    the blocks plainly."""

    def __init__(self, n: int, make_block: Callable[[], nn.Module], *,
                 remat: bool = False) -> None:
        super().__init__(make_block() for _ in range(n))
        self.remat = remat

    @property
    def prefix(self) -> str:
        """The reference's name of the stacked block ("" for a unit)."""
        return self[0].prefix

    def forward(self, x, positions, **kw):
        remat = self.remat and torch.is_grad_enabled() and x.requires_grad
        for block in self:
            if remat:
                # the blocks draw no random numbers: no RNG state to keep
                x = checkpoint(block, x, positions, use_reentrant=False,
                               preserve_rng_state=False, **kw)
            else:
                x = block(x, positions, **kw)
        return x

    def init_cache(self, batch: int, s_max: int, **kw) -> List:
        return [block.init_cache(batch, s_max, **kw) for block in self]

    def prefill(self, x, positions, caches: List, **kw):
        for block, cache in zip(self, caches):
            x, _ = block.prefill(x, positions, cache, **kw)
        return x, caches

    def decode(self, x, caches: List, **kw):
        for block, cache in zip(self, caches):
            x, _ = block.decode(x, cache, **kw)
        return x, caches
