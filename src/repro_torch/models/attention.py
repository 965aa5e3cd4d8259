"""Grouped-query attention (covers MHA), sliding window, qk-norm, logit
softcap and image cross-attention (vlm), with the three entry modes of
the reference
(``repro/models/attention.py``) on one code path:

* ``forward``  -- full-sequence forward;
* ``prefill``  -- forward that also fills the KV cache;
* ``decode``   -- one new token against the cache.

The cache is heads-major, ``[B, KV, S_max, hd]`` (the reference's is
``[B, S_max, KV, hd]``), so each step's score and value products read
the cache in place as ``[B*KV, S, hd]`` matrices instead of copying it
into that shape.  The reference's ``kv_layout = "repeat"`` copies K/V to
all H heads only to suit a tensor-parallel mesh; the port's default,
``"grouped"``, folds the G query heads of each KV head into the rows of
one product and is numerically the same (the tests hold the two equal).

``MLAttention`` (DeepSeek-V2) caches only the compressed latent,
``[B, S_max, kv_lora + rope_dim]``; its prefill expands the latent to
per-head K/V, and its decode is the reference's absorbed form, which
scores against the latent itself.

Cross-attention (``forward(..., kv_src=vision)``) projects K and V from
the image context (``kv_dim`` wide), applies no rope to either side and
attends without a mask, densely, as the reference does; it has no cache.
``cfg.causal = False`` (the audio encoder) drops the causal mask on the
dense and the online path alike.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from repro_torch.models import flash
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, declare, dtype_of, rms_norm

@dataclass
class KVCache:
    """One layer's cache, updated in place by ``prefill`` and ``decode``."""

    k: torch.Tensor   # [B, KV, S_max, hd] (MLA: the latent [B, S_max, Dl])
    v: Optional[torch.Tensor]   # [B, KV, S_max, hd] (MLA: None)
    pos: int = 0      # filled length, one scalar for the whole batch


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

def attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
              window: int = 0) -> torch.Tensor:
    """[q, k] boolean mask. window > 0 => sliding-window attention."""
    m = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    return m


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

class GQAttention(nn.Module):
    # "grouped" (the port's) or "repeat" (the reference's, K/V copied to
    # every query head); numerically the same
    kv_layout = "grouped"

    def __init__(self, cfg: ModelConfig, *, device: torch.device,
                 kv_dim: Optional[int] = None) -> None:
        super().__init__()
        self.cfg = cfg
        d, H, KV, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim_)
        kvd = kv_dim or d
        dt = dtype_of(cfg.param_dtype)
        # wk / wv at the reference's stddev d ** -0.5, whatever kv_dim is
        declare(self, "wq", (d, H, hd), dt, device, d ** -0.5)
        declare(self, "wk", (kvd, KV, hd), dt, device, d ** -0.5)
        declare(self, "wv", (kvd, KV, hd), dt, device, d ** -0.5)
        declare(self, "wo", (H, hd, d), dt, device, (H * hd) ** -0.5)
        if cfg.qk_norm:
            declare(self, "q_norm", (hd,), dt, device, None)
            declare(self, "k_norm", (hd,), dt, device, None)

    # -- projections --------------------------------------------------------
    @staticmethod
    def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """einsum("bsd,dhk->bshk") as one matrix product."""
        return (x @ w.reshape(w.shape[0], -1).to(x.dtype)).unflatten(
            -1, w.shape[1:])

    def _qkv(self, x, positions, kv_src=None):
        """q from ``x``; k, v from ``kv_src`` (cross-attention: no rope)
        or from ``x`` (roped at ``positions``)."""
        cfg = self.cfg
        src = x if kv_src is None else kv_src
        q = self._proj(x, self.wq)
        k = self._proj(src, self.wk)
        v = self._proj(src, self.wv)
        if cfg.qk_norm:
            q = rms_norm(q, self.q_norm, cfg.norm_eps)
            k = rms_norm(k, self.k_norm, cfg.norm_eps)
        if kv_src is None:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    def _out(self, out: torch.Tensor) -> torch.Tensor:
        """einsum("bqhk,hkd->bqd") over [B, Sq, H*hd]."""
        wo = self.wo
        return out @ wo.reshape(-1, wo.shape[-1]).to(out.dtype)

    def _attend(self, q, k, v, mask):
        """q: [B,Sq,H,hd]; k/v: [B,KV,Sk,hd]; mask: [Sq|1, Sk] or None."""
        cfg = self.cfg
        B, Sq, H, hd = q.shape
        KV = k.shape[1]
        if self.kv_layout == "repeat" and KV != H:
            k = k.repeat_interleave(H // KV, dim=1)
            v = v.repeat_interleave(H // KV, dim=1)
            KV = H
        G = H // KV
        # [B,Sq,KV,G,hd] -> [B,KV,G*Sq,hd]: the G heads of a KV head are
        # rows of one product against that head's keys
        qg = q.reshape(B, Sq, KV, G, hd).permute(0, 2, 3, 1, 4).reshape(
            B, KV, G * Sq, hd)
        scores = (qg @ k.transpose(-1, -2)).float()       # [B,KV,G*Sq,Sk]
        scores = scores.view(B, KV, G, Sq, -1)
        scores *= hd ** -0.5
        if cfg.attn_logit_softcap > 0:
            c = cfg.attn_logit_softcap
            scores = c * torch.tanh(scores / c)
        if mask is not None:
            scores = torch.where(mask, scores, -1e30)
        w = torch.softmax(scores, dim=-1).to(q.dtype)
        out = w.view(B, KV, G * Sq, -1) @ v               # [B,KV,G*Sq,hd]
        out = out.view(B, KV, G, Sq, hd).permute(0, 3, 1, 2, 4)
        return self._out(out.reshape(B, Sq, H * hd))

    def _attend_seq(self, q, k, v, *, causal: bool, window: int):
        """Full-sequence attention (k/v: [B,Sk,KV,hd]); long contexts go
        through the online-softmax chunked path, as in the reference."""
        cfg = self.cfg
        B, Sq, H, hd = q.shape
        if flash.should_chunk(Sq, k.shape[1]):
            KV = k.shape[2]
            if self.kv_layout == "repeat" and KV != H:
                k = k.repeat_interleave(H // KV, dim=2)
                v = v.repeat_interleave(H // KV, dim=2)
                KV = H
            out = flash.online_attention(
                q.reshape(B, Sq, KV, H // KV, hd), k, v, causal=causal,
                window=window, softcap=cfg.attn_logit_softcap)
            return self._out(out.reshape(B, Sq, H * hd))
        pos = torch.arange(Sq, device=q.device)
        mask = attn_mask(pos, pos, causal=causal, window=window)
        return self._attend(q, k.transpose(1, 2), v.transpose(1, 2), mask)

    # -- entry points --------------------------------------------------------
    def forward(self, x, positions, *, window: int = 0,
                kv_src: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Self-attention, or with ``kv_src`` ([B, T, kv_dim]) cross-
        attention to it: no rope, no mask, no chunking."""
        q, k, v = self._qkv(x, positions, kv_src)
        if kv_src is not None:
            return self._attend(q, k.transpose(1, 2), v.transpose(1, 2),
                                None)
        return self._attend_seq(q, k, v, causal=self.cfg.causal,
                                window=window)

    def init_cache(self, batch: int, s_max: int) -> KVCache:
        cfg = self.cfg
        shape = (batch, cfg.num_kv_heads, s_max, cfg.head_dim_)
        kw = dict(dtype=dtype_of(cfg.compute_dtype), device=self.wq.device)
        return KVCache(torch.zeros(shape, **kw), torch.zeros(shape, **kw), 0)

    def prefill(self, x, positions, cache: KVCache, *, window: int = 0):
        q, k, v = self._qkv(x, positions)
        S = x.shape[1]
        cache.k[:, :, :S] = k.transpose(1, 2)
        cache.v[:, :, :S] = v.transpose(1, 2)
        cache.pos = S
        out = self._attend_seq(q, k, v, causal=self.cfg.causal,
                               window=window)
        return out, cache

    def decode(self, x, cache: KVCache, *, window: int = 0):
        """x: [B, 1, d]; attends over cache[:pos] + the new token."""
        pos = cache.pos
        s_max = cache.k.shape[2]
        if pos >= s_max:
            raise ValueError(f"KV cache full: {s_max} positions")
        positions = torch.full((x.shape[0], 1), pos, dtype=torch.int64,
                               device=x.device)
        q, k, v = self._qkv(x, positions)
        cache.k[:, :, pos] = k[:, 0]
        cache.v[:, :, pos] = v[:, 0]
        k_pos = torch.arange(s_max, device=x.device)
        valid = k_pos <= pos
        if window > 0:
            valid &= k_pos > pos - window
        out = self._attend(q, cache.k, cache.v, valid[None, :])
        cache.pos = pos + 1
        return out, cache


class MLAttention(nn.Module):
    """DeepSeek-V2 multi-head latent attention.

    ``forward`` and ``prefill`` expand the latent to per-head K/V and run
    dense or online attention (KV groups = H, group size 1).  ``decode``
    is the ABSORBED form: ``q_nope`` is folded through ``wkv_b``'s key
    half, so scores are taken against the cached latent itself and the
    latent context goes through ``wkv_b``'s value half and ``wo``; the
    cache is never expanded to per-head K/V, so a step costs O(S *
    (kv_lora + rope)) per head instead of O(S * head_dim * 2)."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device) -> None:
        super().__init__()
        assert cfg.mla is not None
        self.cfg = cfg
        m = cfg.mla
        d, H = cfg.d_model, cfg.num_heads
        dt = dtype_of(cfg.param_dtype)
        qdim = m.nope_head_dim + m.rope_head_dim
        if m.q_lora_rank:
            declare(self, "wq_a", (d, m.q_lora_rank), dt, device, d ** -0.5)
            declare(self, "q_norm", (m.q_lora_rank,), dt, device, None)
            declare(self, "wq_b", (m.q_lora_rank, H, qdim), dt, device,
                    d ** -0.5)
        else:
            declare(self, "wq", (d, H, qdim), dt, device, d ** -0.5)
        declare(self, "wkv_a", (d, m.kv_lora_rank + m.rope_head_dim), dt,
                device, d ** -0.5)
        declare(self, "kv_norm", (m.kv_lora_rank,), dt, device, None)
        declare(self, "wkv_b", (m.kv_lora_rank, H,
                                m.nope_head_dim + m.v_head_dim), dt, device,
                d ** -0.5)
        declare(self, "wo", (H, m.v_head_dim, d), dt, device,
                (H * m.v_head_dim) ** -0.5)

    def _q(self, x):
        """[B, S, H, nope + rope]."""
        m = self.cfg.mla
        if m.q_lora_rank:
            cq = x @ self.wq_a.to(x.dtype)
            cq = rms_norm(cq, self.q_norm, self.cfg.norm_eps)
            return GQAttention._proj(cq, self.wq_b)
        return GQAttention._proj(x, self.wq)

    def _latent(self, x, positions):
        """(normed latent c [B, S, r], roped shared key [B, S, rope])."""
        cfg, m = self.cfg, self.cfg.mla
        ckv = x @ self.wkv_a.to(x.dtype)
        c = rms_norm(ckv[..., :m.kv_lora_rank], self.kv_norm, cfg.norm_eps)
        k_rope = apply_rope(ckv[..., None, m.kv_lora_rank:], positions,
                            cfg.rope_theta)[..., 0, :]
        return c, k_rope

    _out = GQAttention._out        # einsum("bqhv,hvd->bqd"), [B,Sq,H*dv]

    def _full_attention(self, x, positions):
        """Expanded-KV attention, online above ``flash.DENSE_LIMIT``:
        (y [B, S, d], the cache's latent rows [B, S, r + rope])."""
        cfg, m = self.cfg, self.cfg.mla
        B, S, _ = x.shape
        H, dn = cfg.num_heads, m.nope_head_dim
        q = self._q(x)
        c, k_rope = self._latent(x, positions)
        kv = GQAttention._proj(c, self.wkv_b)          # [B,S,H,dn+dv]
        k_nope, v = kv[..., :dn], kv[..., dn:]
        q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
        qf = torch.cat([q[..., :dn], q_rope], -1)
        kf = torch.cat([k_nope, k_rope[:, :, None].expand(
            B, S, H, m.rope_head_dim)], -1)
        if flash.should_chunk(S, S):
            # MHA: KV groups = H, group size 1
            out = flash.online_attention(qf[:, :, :, None], kf, v,
                                         causal=cfg.causal)[:, :, :, 0]
        else:
            scale = (dn + m.rope_head_dim) ** -0.5
            # [B,H,S,hd] products
            sc = (qf.transpose(1, 2) @ kf.permute(0, 2, 3, 1)).float()
            sc = sc * scale
            if cfg.causal:
                pos = torch.arange(S, device=x.device)
                sc = torch.where(pos[None, :] <= pos[:, None], sc, -1e30)
            w = torch.softmax(sc, -1).to(x.dtype)
            out = (w @ v.transpose(1, 2)).transpose(1, 2)  # [B,S,H,dv]
        y = self._out(out.reshape(B, S, H * m.v_head_dim))
        return y, torch.cat([c, k_rope], -1)

    # -- entry points --------------------------------------------------------
    def forward(self, x, positions, *, window: int = 0) -> torch.Tensor:
        return self._full_attention(x, positions)[0]

    def init_cache(self, batch: int, s_max: int) -> KVCache:
        m = self.cfg.mla
        lat = torch.zeros((batch, s_max, m.kv_lora_rank + m.rope_head_dim),
                          dtype=dtype_of(self.cfg.compute_dtype),
                          device=self.wkv_a.device)
        return KVCache(lat, None, 0)

    def prefill(self, x, positions, cache: KVCache, *, window: int = 0):
        y, lat = self._full_attention(x, positions)
        S = x.shape[1]
        cache.k[:, :S] = lat
        cache.pos = S
        return y, cache

    def decode(self, x, cache: KVCache, *, window: int = 0):
        """Absorbed-form single-token decode against the latent cache."""
        cfg, m = self.cfg, self.cfg.mla
        B = x.shape[0]
        H, dn, r = cfg.num_heads, m.nope_head_dim, m.kv_lora_rank
        pos = cache.pos
        s_max = cache.k.shape[1]
        if pos >= s_max:
            raise ValueError(f"latent cache full: {s_max} positions")
        positions = torch.full((B, 1), pos, dtype=torch.int64,
                               device=x.device)
        q = self._q(x)[:, 0]                           # [B,H,dn+dr]
        q_rope = apply_rope(q[:, None, :, dn:], positions,
                            cfg.rope_theta)[:, 0]      # [B,H,dr]
        c, k_rope = self._latent(x, positions)
        cache.k[:, pos] = torch.cat([c, k_rope], -1)[:, 0]
        c_all = cache.k[..., :r]                       # [B,S,r]
        kr_all = cache.k[..., r:]                      # [B,S,dr] (roped)

        wkv_b = self.wkv_b.to(x.dtype)                 # [r,H,dn+dv]
        wk = wkv_b[..., :dn].permute(1, 2, 0)          # [H,dn,r]
        wv = wkv_b[..., dn:].transpose(0, 1)           # [H,r,dv]
        # absorb: q_lat[b,h,:] = q_nope[b,h,:] @ wk[h]
        q_lat = torch.bmm(q[..., :dn].transpose(0, 1), wk).transpose(0, 1)
        sc = (q_lat @ c_all.transpose(1, 2)
              + q_rope @ kr_all.transpose(1, 2)).float()  # [B,H,S]
        sc = sc * (dn + m.rope_head_dim) ** -0.5
        valid = torch.arange(s_max, device=x.device) <= pos
        sc = torch.where(valid, sc, -1e30)
        w = torch.softmax(sc, -1).to(x.dtype)
        ctx_lat = w @ c_all                            # [B,H,r]
        out = torch.bmm(ctx_lat.transpose(0, 1), wv)   # [H,B,dv]
        y = self._out(out.transpose(0, 1).reshape(B, H * m.v_head_dim))
        cache.pos = pos + 1
        return y[:, None], cache
