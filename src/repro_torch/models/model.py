"""The LM of the dense and moe families: blocks per architecture and the
entry points the serving engine consumes (``repro/models/model.py``):

* ``LM(cfg, device=, generator=)`` builds and initialises on ``device``;
* ``forward(tokens)``                 -> logits [B, S, V]
* ``loss(batch)``                     -> scalar
* ``prefill(tokens, s_max)``          -> (logits [B, 1, V], caches)
* ``decode_step(tokens, caches)``     -> (logits [B, 1, V], caches)

Segments, as in the reference:

  dense  : [stack(block) x L]
  gemma3 : [unit(k local + 1 global) x U, local x tail]
  moe    : [dense0: block x first_dense_layers, moe: MoE block x rest]
           (MLA attention where the config has it: deepseek-v2)

The ``vlm``, ``hybrid``, ``ssm`` and ``audio`` families raise
``NotImplementedError`` (ROADMAP.md queue 1 items 2-5).

Training (``repro_torch.train``) turns the parameters' gradients on;
with ``cfg.remat != "none"`` each stack recomputes its blocks in the
backward pass, as the reference's ``jax.checkpoint`` per block.

The model is built where it runs: every parameter is allocated on
``device`` (``"cuda"`` by default, raising without a card; ``"meta"``
allocates nothing, for ``to_empty`` then :meth:`init_weights`) and drawn
there from a ``torch.Generator`` on that device, never as float32 on the
host (Qwen3-8B's 8.19 B parameters would take 33 GB there).  The caches
are updated in place; ``prefill`` and ``decode_step`` return them too.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn
import torch.nn.functional as F

from repro_torch.core.engine import resolve_device
from repro_torch.models.attention import WAITS
from repro_torch.models.blocks import ScanStack, TransformerBlock
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (cross_entropy, declare, dtype_of,
                                       init_normal, rms_norm)

FAMILIES = ("dense", "moe")


def model_device(device: Union[str, torch.device]) -> torch.device:
    """``resolve_device`` plus ``"meta"`` (shapes without storage)."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve_device(dev)


class GemmaUnit(nn.Module):
    """k sliding-window layers followed by one global-attention layer."""

    def __init__(self, cfg: ModelConfig, k: int, *,
                 device: torch.device) -> None:
        super().__init__()
        self.loc = ScanStack(k, lambda: TransformerBlock(
            cfg, device=device, window=cfg.sliding_window),
            remat=cfg.remat != "none")
        self.g = TransformerBlock(cfg, device=device, window=0)

    def forward(self, x, positions):
        return self.g(self.loc(x, positions), positions)

    def init_cache(self, batch: int, s_max: int):
        return (self.loc.init_cache(batch, s_max),
                self.g.init_cache(batch, s_max))

    def prefill(self, x, positions, cache):
        lc, gc = cache
        x, _ = self.loc.prefill(x, positions, lc)
        x, _ = self.g.prefill(x, positions, gc)
        return x, cache

    def decode(self, x, cache):
        lc, gc = cache
        x, _ = self.loc.decode(x, lc)
        x, _ = self.g.decode(x, gc)
        return x, cache


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, *,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"the {cfg.family!r} family ({cfg.name}) {WAITS}")
        dev = model_device(device)
        self.cfg = cfg
        d = cfg.d_model
        dt = dtype_of(cfg.param_dtype)
        self.compute_dtype = dtype_of(cfg.compute_dtype)
        # sqrt(d_model) rounded to the compute dtype, as the reference's
        # jnp.asarray(d ** 0.5, cdt)
        self.embed_scale = float(torch.tensor(d ** 0.5,
                                              dtype=self.compute_dtype))
        # vocab padded to a multiple of 256; padded logits are -1e30
        self.vocab_padded = -(-cfg.vocab // 256) * 256
        declare(self, "embed", (self.vocab_padded, d), dt, dev, 1.0)
        if not cfg.tie_embeddings:
            declare(self, "head", (d, self.vocab_padded), dt, dev, d ** -0.5)
        declare(self, "final_norm", (d,), dt, dev, None)

        L = cfg.num_layers
        remat = cfg.remat != "none"
        self.segments = nn.ModuleDict()
        if cfg.family == "moe":
            nd = cfg.moe.first_dense_layers
            if nd:
                self.segments["dense0"] = ScanStack(
                    nd, lambda: TransformerBlock(cfg, device=dev),
                    remat=remat)
            if L - nd:
                self.segments["moe"] = ScanStack(
                    L - nd, lambda: TransformerBlock(cfg, device=dev,
                                                     use_moe=True),
                    remat=remat)
        elif cfg.local_global_pattern:
            k = cfg.local_global_pattern
            units, tail = L // (k + 1), L % (k + 1)
            if units:
                self.segments["units"] = ScanStack(
                    units, lambda: GemmaUnit(cfg, k, device=dev),
                    remat=remat)
            if tail:
                self.segments["tail"] = ScanStack(
                    tail, lambda: TransformerBlock(
                        cfg, device=dev, window=cfg.sliding_window),
                    remat=remat)
        else:
            self.segments["blocks"] = ScanStack(
                L, lambda: TransformerBlock(cfg, device=dev), remat=remat)
        if dev.type != "meta":
            self.init_weights(generator if generator is not None
                              else torch.Generator(dev).manual_seed(0))

    def init_weights(self, generator: torch.Generator) -> None:
        """Draw every parameter from ``generator`` (on their device)."""
        init_normal(self, generator)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def param_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parameters())

    # -- shared plumbing ------------------------------------------------------
    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = F.embedding(tokens.long(), self.embed).to(self.compute_dtype)
        return x * self.embed_scale

    @staticmethod
    def _positions(x: torch.Tensor) -> torch.Tensor:
        B, S = x.shape[0], x.shape[1]
        return torch.arange(S, device=x.device)[None].expand(B, S)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        w = self.embed.T if cfg.tie_embeddings else self.head
        logits = (x @ w.to(x.dtype)).to(dtype_of(cfg.logits_dtype))
        if self.vocab_padded != cfg.vocab:
            real = torch.arange(self.vocab_padded, device=x.device) < cfg.vocab
            logits = torch.where(real, logits, -1e30)
        return logits

    # -- entry points ---------------------------------------------------------
    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self._embed(tokens)
        positions = self._positions(x)
        for seg in self.segments.values():
            x = seg(x, positions)
        return self._head(x)

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        logits = self.forward(batch["tokens"])
        return cross_entropy(logits, batch["labels"], batch.get("mask"))

    # -- serving --------------------------------------------------------------
    def init_caches(self, batch: int, s_max: int) -> List:
        return [seg.init_cache(batch, s_max)
                for seg in self.segments.values()]

    def prefill(self, tokens: torch.Tensor,
                s_max: int) -> Tuple[torch.Tensor, List]:
        x = self._embed(tokens)
        positions = self._positions(x)
        caches = self.init_caches(x.shape[0], s_max)
        for seg, cache in zip(self.segments.values(), caches):
            x, _ = seg.prefill(x, positions, cache)
        return self._head(x[:, -1:]), caches

    def decode_step(self, tokens: torch.Tensor,
                    caches: List) -> Tuple[torch.Tensor, List]:
        """tokens: [B, 1] -> (logits [B, 1, V], the caches, updated)."""
        x = self._embed(tokens)
        for seg, cache in zip(self.segments.values(), caches):
            x, _ = seg.decode(x, cache)
        return self._head(x), caches
