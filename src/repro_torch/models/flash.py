"""Online-softmax (flash-style) chunked attention in plain PyTorch.

The reference's formulation (``repro/models/flash.py``): an outer loop
over query blocks and an inner loop over key blocks carrying the running
(row-max, denominator, accumulator) in float32, so memory per step is
O(Qc * Kc) whatever the sequence length.  The same chunking, the same
masks, the same -1e30 fill, and ``p`` cast to the value dtype before the
PV product.  Blocks that a causal mask fully kills are still computed, as
in the reference.  ``should_chunk`` routes between this and the dense
path at the reference's ``DENSE_LIMIT``.

Supports: GQA grouping, causal and sliding-window masks, logit softcap,
bidirectional (encoder) attention.
"""

from __future__ import annotations

import torch

NEG = -1e30


def online_attention(
    q: torch.Tensor,         # [B, Sq, KV, G, hd]
    k: torch.Tensor,         # [B, Sk, KV, hd]
    v: torch.Tensor,         # [B, Sk, KV, hd]
    *,
    causal: bool,
    window: int = 0,
    softcap: float = 0.0,
    q_offset: int = 0,       # position of q[0] within the key timeline
    chunk_q: int = 1024,
    chunk_k: int = 1024,
) -> torch.Tensor:
    B, Sq, KV, G, hd = q.shape
    dv = v.shape[-1]                 # v head dim may differ (MLA)
    Sk = k.shape[1]
    Qc = min(chunk_q, Sq)
    Kc = min(chunk_k, Sk)
    if Sq % Qc or Sk % Kc:
        raise ValueError(f"online attention needs whole blocks: Sq={Sq} "
                         f"by {Qc}, Sk={Sk} by {Kc}")
    nq, nk = Sq // Qc, Sk // Kc
    scale = hd ** -0.5
    dev = q.device
    out = torch.empty((B, Sq, KV, G, dv), dtype=q.dtype, device=dev)

    for qi in range(nq):
        qb = q[:, qi * Qc:(qi + 1) * Qc]                   # [B,Qc,KV,G,hd]
        qpos = q_offset + qi * Qc + torch.arange(Qc, device=dev)
        m = torch.full((B, KV, G, Qc), NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((B, KV, G, Qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, G, Qc, dv), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            kb = k[:, ki * Kc:(ki + 1) * Kc]
            vb = v[:, ki * Kc:(ki + 1) * Kc]
            kpos = ki * Kc + torch.arange(Kc, device=dev)
            s = torch.einsum("bqkgh,bskh->bkgqs", qb, kb).float()
            s = s * scale
            if softcap > 0:
                s = softcap * torch.tanh(s / softcap)
            mask = torch.ones((Qc, Kc), dtype=torch.bool, device=dev)
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
            if window > 0:
                mask &= kpos[None, :] > qpos[:, None] - window
            s = torch.where(mask, s, NEG)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskh->bkgqh", p.to(qb.dtype), vb).float()
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        # [B,KV,G,Qc,dv] -> [B,Qc,KV,G,dv]
        out[:, qi * Qc:(qi + 1) * Qc] = o.permute(0, 3, 1, 2, 4).to(q.dtype)
    return out


DENSE_LIMIT = 1 << 22   # Sq*Sk above this routes to the online path


def should_chunk(sq: int, sk: int) -> bool:
    return sq * sk > DENSE_LIMIT and sq > 1
