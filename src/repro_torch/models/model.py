"""The LM of every family: blocks per architecture and the entry points
the serving engine consumes (``repro/models/model.py``):

* ``LM(cfg, device=, generator=)`` builds and initialises on ``device``;
* ``forward(inputs, *, vision=None)``          -> logits [B, S, V]
* ``loss(batch)``                               -> scalar
* ``prefill(inputs, s_max, *, vision=None)``   -> (logits [B, 1, V], caches)
* ``decode_step(tokens, caches, *, vision=None)``
                                                -> (logits [B, 1, V], caches)

``inputs`` are token ids [B, S], or for the audio family the frame
embeddings [B, S, 512] (the reference's stub frontend); ``loss`` reads
``batch["tokens"]`` or ``batch["frames"]``, and ``batch["vision"]``.
``vision`` is the vlm family's image context [B, T, vision_dim] (stub
patch embeddings), normed by ``vision_norm`` once per call and attended
by every unit's cross-attention layer, in decode too (its K/V recomputed
at every step, as in the reference).  The audio family is an encoder:
``decode_step`` raises ``ValueError``.

Segments, as in the reference:

  dense  : [stack(block) x L]                 (audio too: hubert)
  gemma3 : [unit(k local + 1 global) x U, local x tail]
  moe    : [dense0: block x first_dense_layers, moe: MoE block x rest]
           (MLA attention where the config has it: deepseek-v2)
  vlm    : [unit(k self + 1 cross) x U, self x tail]
           (k = cross_attn_every - 1: Llama-3.2-Vision's 4 + 1)
  hybrid : [unit(shared attention + k Mamba2) x U, Mamba2 x tail]
           (zamba2: one attention block, ``LM.shared``, applied at the
           head of every unit, each unit with its own KV cache for it)
  ssm    : [unit(mLSTM + sLSTM) x U, mLSTM x tail]   (xlstm)

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
from repro_torch.models.blocks import (Mamba2Layer, ScanStack,
                                      TransformerBlock, XLSTMLayer)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (cross_entropy, declare, dtype_of,
                                       init_normal, rms_norm)

FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm", "audio")
FRAME_DIM = 512          # the audio family's stub frame embeddings


def model_device(device: Union[str, torch.device]) -> torch.device:
    """``resolve_device`` plus ``"meta"`` (shapes without storage)."""
    dev = torch.device(device)
    return dev if dev.type == "meta" else resolve_device(dev)


class GemmaUnit(nn.Module):
    """k sliding-window layers followed by one global-attention layer."""

    prefix = ""

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


class ZambaUnit(nn.Module):
    """The shared attention block, passed in at every call (the LM owns
    it; the unit does not register it), then k Mamba2 layers.  The unit's
    cache is its own KV cache for the shared block and the layers'
    states."""

    prefix = ""

    def __init__(self, cfg: ModelConfig, k: int, *,
                 device: torch.device) -> None:
        super().__init__()
        self.mam = ScanStack(k, lambda: Mamba2Layer(cfg, device=device),
                             remat=cfg.remat != "none")

    def forward(self, x, positions, *, shared: TransformerBlock):
        return self.mam(shared(x, positions), positions)

    def init_cache(self, batch: int, s_max: int, *,
                   shared: TransformerBlock):
        return (shared.init_cache(batch, s_max),
                self.mam.init_cache(batch, s_max))

    def prefill(self, x, positions, cache, *, shared: TransformerBlock):
        sc, mc = cache
        x, _ = shared.prefill(x, positions, sc)
        x, _ = self.mam.prefill(x, positions, mc)
        return x, cache

    def decode(self, x, cache, *, shared: TransformerBlock):
        sc, mc = cache
        x, _ = shared.decode(x, sc)
        x, _ = self.mam.decode(x, mc)
        return x, cache


class XLSTMUnit(nn.Module):
    """An mLSTM layer then an sLSTM layer (xLSTM[1:1])."""

    prefix = ""

    def __init__(self, cfg: ModelConfig, *, device: torch.device) -> None:
        super().__init__()
        self.xm = XLSTMLayer(cfg, "m", device=device)
        self.xs = XLSTMLayer(cfg, "s", device=device)

    def forward(self, x, positions):
        return self.xs(self.xm(x, positions), positions)

    def init_cache(self, batch: int, s_max: int):
        return (self.xm.init_cache(batch, s_max),
                self.xs.init_cache(batch, s_max))

    def prefill(self, x, positions, cache):
        x, _ = self.xm.prefill(x, positions, cache[0])
        x, _ = self.xs.prefill(x, positions, cache[1])
        return x, cache

    def decode(self, x, cache):
        x, _ = self.xm.decode(x, cache[0])
        x, _ = self.xs.decode(x, cache[1])
        return x, cache


class VLMUnit(nn.Module):
    """k self-attention layers, then one image cross-attention layer
    against the ``vision`` keyword.  The unit's cache is the self-
    attention stack's: the cross layer has none, and recomputes its K/V
    from ``vision`` at every call."""

    prefix = ""

    def __init__(self, cfg: ModelConfig, k: int, *,
                 device: torch.device) -> None:
        super().__init__()
        self.sa = ScanStack(k, lambda: TransformerBlock(cfg, device=device),
                            remat=cfg.remat != "none")
        self.x = TransformerBlock(cfg, device=device, cross=True)

    def forward(self, x, positions, *, vision: torch.Tensor):
        return self.x(self.sa(x, positions), positions, kv_src=vision)

    def init_cache(self, batch: int, s_max: int, *, vision=None):
        return self.sa.init_cache(batch, s_max)

    def prefill(self, x, positions, cache, *, vision: torch.Tensor):
        x, _ = self.sa.prefill(x, positions, cache)
        return self.x(x, positions, kv_src=vision), cache

    def decode(self, x, cache, *, vision: torch.Tensor):
        x, _ = self.sa.decode(x, cache)
        # the cross path applies no rope, so the positions (the
        # reference's zeros) are never read
        return self.x(x, None, kv_src=vision), cache


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, *,
                 device: Union[str, torch.device] = "cuda",
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r} ({cfg.name})")
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
        if cfg.family == "audio":
            # frames in, an untied head out, whatever tie_embeddings says
            declare(self, "frontend_proj", (FRAME_DIM, d), dt, dev,
                    FRAME_DIM ** -0.5)
            declare(self, "head", (d, self.vocab_padded), dt, dev, d ** -0.5)
        else:
            declare(self, "embed", (self.vocab_padded, d), dt, dev, 1.0)
            if not cfg.tie_embeddings:
                declare(self, "head", (d, self.vocab_padded), dt, dev,
                        d ** -0.5)
        declare(self, "final_norm", (d,), dt, dev, None)
        if cfg.family == "vlm":
            declare(self, "vision_norm", (cfg.vlm.vision_dim,), dt, dev,
                    None)

        L = cfg.num_layers
        # zamba2's shared attention block: one set of parameters
        self.shared = TransformerBlock(cfg, device=dev) \
            if cfg.family == "hybrid" else None
        self.segments = nn.ModuleDict()

        def stack(name: str, n: int, make) -> None:
            if n:
                self.segments[name] = ScanStack(
                    n, make, remat=cfg.remat != "none")

        if cfg.family == "hybrid":
            k = cfg.ssm.attn_every
            stack("units", L // k, lambda: ZambaUnit(cfg, k, device=dev))
            stack("tail", L % k, lambda: Mamba2Layer(cfg, device=dev))
        elif cfg.family == "ssm":
            stack("units", L // 2, lambda: XLSTMUnit(cfg, device=dev))
            stack("tail", L % 2, lambda: XLSTMLayer(cfg, "m", device=dev))
        elif cfg.family == "moe":
            nd = cfg.moe.first_dense_layers
            stack("dense0", nd, lambda: TransformerBlock(cfg, device=dev))
            stack("moe", L - nd, lambda: TransformerBlock(
                cfg, device=dev, use_moe=True))
        elif cfg.family == "vlm":
            k = cfg.vlm.cross_attn_every - 1
            stack("units", L // (k + 1), lambda: VLMUnit(cfg, k, device=dev))
            stack("tail", L % (k + 1), lambda: TransformerBlock(
                cfg, device=dev))
        elif cfg.local_global_pattern:
            k = cfg.local_global_pattern
            stack("units", L // (k + 1), lambda: GemmaUnit(cfg, k,
                                                           device=dev))
            stack("tail", L % (k + 1), lambda: TransformerBlock(
                cfg, device=dev, window=cfg.sliding_window))
        else:
            stack("blocks", L, lambda: TransformerBlock(cfg, device=dev))
        if dev.type != "meta":
            self.init_weights(generator if generator is not None
                              else torch.Generator(dev).manual_seed(0))

    def init_weights(self, generator: torch.Generator) -> None:
        """Draw every parameter from ``generator`` (on their device)."""
        init_normal(self, generator)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    @property
    def encoder_only(self) -> bool:
        """No decode step: the audio family, or a non-causal config."""
        return self.cfg.family == "audio" or self.cfg.is_encoder_only

    @property
    def reference_prefixes(self) -> Dict[str, str]:
        """Each stack's block name in the reference's parameter names, by
        its path (``tail``; a unit's inner stack as ``units.mam``), and
        ``shared`` for zamba2's shared block: the names
        ``interop.lm_reference_name`` maps this model's parameters by."""
        out = {}
        if self.shared is not None:
            out["shared"] = "shared"
        for name, seg in self.segments.items():
            out[name] = seg.prefix
            for child, sub in seg[0].named_children():
                if isinstance(sub, ScanStack):
                    out[f"{name}.{child}"] = sub.prefix
        return out

    def param_bytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.parameters())

    # -- shared plumbing ------------------------------------------------------
    def _embed(self, inputs: torch.Tensor) -> torch.Tensor:
        """Token ids [B, S], or audio frames [B, S, 512] projected to
        d_model (no sqrt(d) scale, as in the reference)."""
        cdt = self.compute_dtype
        if self.cfg.family == "audio":
            return inputs.to(cdt) @ self.frontend_proj.to(cdt)
        x = F.embedding(inputs.long(), self.embed).to(cdt)
        return x * self.embed_scale

    def _vision(self, vision: Optional[torch.Tensor]
                ) -> Optional[torch.Tensor]:
        """The vlm family's image context, in the compute dtype and
        normed by ``vision_norm``; None for the other families."""
        cfg = self.cfg
        if cfg.family != "vlm":
            return None
        if vision is None:
            raise ValueError(f"{cfg.name} needs the image context: "
                             f"vision=[B, {cfg.vlm.num_image_tokens}, "
                             f"{cfg.vlm.vision_dim}]")
        return rms_norm(vision.to(self.compute_dtype), self.vision_norm,
                        cfg.norm_eps)

    @staticmethod
    def _positions(x: torch.Tensor) -> torch.Tensor:
        B, S = x.shape[0], x.shape[1]
        return torch.arange(S, device=x.device)[None].expand(B, S)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        w = self.embed.T if cfg.tie_embeddings and cfg.family != "audio" \
            else self.head
        logits = (x @ w.to(x.dtype)).to(dtype_of(cfg.logits_dtype))
        if self.vocab_padded != cfg.vocab:
            real = torch.arange(self.vocab_padded, device=x.device) < cfg.vocab
            logits = torch.where(real, logits, -1e30)
        return logits

    def _kw(self, name: str, vision: Optional[torch.Tensor] = None
            ) -> Dict[str, object]:
        """The keyword arguments of segment ``name``'s blocks: zamba2's
        units get the shared attention block, the vlm units the normed
        image context."""
        if name != "units":
            return {}
        if self.shared is not None:
            return {"shared": self.shared}
        return {"vision": vision} if self.cfg.family == "vlm" else {}

    # -- entry points ---------------------------------------------------------
    def forward(self, inputs: torch.Tensor, *,
                vision: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self._embed(inputs)
        positions = self._positions(x)
        v = self._vision(vision)
        for name, seg in self.segments.items():
            x = seg(x, positions, **self._kw(name, v))
        return self._head(x)

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        inputs = batch["frames" if self.cfg.family == "audio" else "tokens"]
        logits = self.forward(inputs, vision=batch.get("vision"))
        return cross_entropy(logits, batch["labels"], batch.get("mask"))

    # -- serving --------------------------------------------------------------
    def init_caches(self, batch: int, s_max: int) -> List:
        return [seg.init_cache(batch, s_max, **self._kw(name))
                for name, seg in self.segments.items()]

    def prefill(self, inputs: torch.Tensor, s_max: int, *,
                vision: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, List]:
        x = self._embed(inputs)
        positions = self._positions(x)
        v = self._vision(vision)
        caches = self.init_caches(x.shape[0], s_max)
        for (name, seg), cache in zip(self.segments.items(), caches):
            x, _ = seg.prefill(x, positions, cache, **self._kw(name, v))
        return self._head(x[:, -1:]), caches

    def decode_step(self, tokens: torch.Tensor, caches: List, *,
                    vision: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, List]:
        """tokens: [B, 1] -> (logits [B, 1, V], the caches, updated).
        The vlm family needs ``vision`` at every step; an encoder (the
        audio family) has no decode step."""
        if self.encoder_only:
            raise ValueError(f"{self.cfg.name} is an encoder: it has no "
                             f"decode step")
        x = self._embed(tokens)
        v = self._vision(vision)
        for (name, seg), cache in zip(self.segments.items(), caches):
            x, _ = seg.decode(x, cache, **self._kw(name, v))
        return self._head(x), caches
