"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel form) and sLSTM
(scalar memory, a loop over time), per Beck et al. 2024 (arXiv:2405.04517),
as the reference has them (``repro/models/xlstm.py``).

mLSTM trains and prefills in chunks of 256 positions: within a chunk an
attention-like product with the stabilised log-sigmoid forget decays,
across chunks a recurrence over the stabilised matrix state
``(C [B, H, dk, dv], n, m)``, here a Python loop over the chunks.  Its
decode is the recurrent cell on that state.  sLSTM's recurrent gate
connections leave no parallel form, so forward, prefill and decode all
run its cell one position at a time.  The stabilisers start at ``-1e30``,
as in the reference.  Decode states are updated in place.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import copy_state, declare, dtype_of, rms_norm

M_START = -1e30       # the stabiliser before any input


@dataclass
class MLSTMState:
    """One mLSTM layer's decode state (float32), updated in place."""

    c: torch.Tensor   # [B, H, dk, dv]
    n: torch.Tensor   # [B, H, dk]
    m: torch.Tensor   # [B, H]


@dataclass
class SLSTMState:
    """One sLSTM layer's state (float32, [B, d] each)."""

    c: torch.Tensor
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor


class MLSTMBlock(nn.Module):
    """Up-projection (factor 2) -> mLSTM cell -> gated skip ->
    down-projection."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device) -> None:
        super().__init__()
        assert cfg.xlstm is not None
        self.cfg = cfg
        d = cfg.d_model
        inner = int(d * cfg.xlstm.mlstm_proj_factor)
        self.inner = inner
        self.dk = cfg.xlstm.mlstm_head_dim
        self.heads = max(inner // self.dk, 1)
        self.dv = inner // self.heads
        H = self.heads
        dt = dtype_of(cfg.param_dtype)
        declare(self, "up", (d, 2 * inner), dt, device, d ** -0.5)
        declare(self, "wq", (inner, H, self.dk), dt, device, d ** -0.5)
        declare(self, "wk", (inner, H, self.dk), dt, device, d ** -0.5)
        declare(self, "wv", (inner, H, self.dv), dt, device, d ** -0.5)
        declare(self, "wif", (inner, 2 * H), torch.float32, device,
                d ** -0.5)
        declare(self, "norm", (inner,), dt, device, None)
        declare(self, "down", (inner, d), dt, device, inner ** -0.5)

    def _proj(self, x):
        """q, k, v head-major [B, H, S, dk|dv]; the gates [B, H, S] f32."""
        B, S, _ = x.shape
        u, z = (x @ self.up.to(x.dtype)).chunk(2, dim=-1)

        def heads(w):
            return (u @ w.to(x.dtype).reshape(self.inner, -1)).reshape(
                B, S, self.heads, -1).transpose(1, 2)

        gates = (u.float() @ self.wif).transpose(1, 2)
        i_raw, f_raw = gates.chunk(2, dim=1)
        return z, heads(self.wq), heads(self.wk), heads(self.wv), i_raw, \
            f_raw

    def _out(self, h, z):
        h = rms_norm(h, self.norm, self.cfg.norm_eps) * F.silu(z)
        return h @ self.down.to(h.dtype)

    def forward(self, x, *, return_state: bool = False, chunk: int = 256):
        """The chunkwise-parallel mLSTM: equal to the recurrent cell."""
        B, S, _ = x.shape
        H, dk, dv = self.heads, self.dk, self.dv
        Q = min(chunk, S)
        assert S % Q == 0, (S, Q)
        z, q, k, v, i_raw, f_raw = self._proj(x)
        logf = F.logsigmoid(f_raw)                        # [B,H,S] f32
        qs = q.float() * dk ** -0.5
        ks, vs = k.float(), v.float()
        causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
        C = torch.zeros((B, H, dk, dv), dtype=torch.float32, device=x.device)
        n = torch.zeros((B, H, dk), dtype=torch.float32, device=x.device)
        m_prev = torch.full((B, H), M_START, dtype=torch.float32,
                            device=x.device)
        hs = []
        for lo in range(0, S, Q):
            qb, kb, vb = (t[:, :, lo:lo + Q] for t in (qs, ks, vs))
            ib = i_raw[:, :, lo:lo + Q]
            Fb = torch.cumsum(logf[:, :, lo:lo + Q], dim=-1)  # [B,H,Q]
            Ftb = Fb[..., -1]                                  # [B,H]
            # rel[i, j] = F_i - F_j + itilde_j for j <= i
            rel = (Fb[..., :, None] - Fb[..., None, :]
                   + ib[..., None, :]).masked_fill(~causal, float("-inf"))
            m_in = torch.clamp(rel.amax(-1), min=M_START)      # [B,H,Q]
            g_tail = Ftb[..., None] - Fb + ib                  # [B,H,Q]
            m_state = g_tail.amax(-1)                          # [B,H]
            # the combined stabiliser of each position
            m_i = torch.maximum(m_in, Fb + m_prev[..., None])
            sc = (qb @ kb.transpose(-1, -2)) * torch.exp(
                rel - m_i[..., None])                          # [B,H,Q,Q]
            w_inter = torch.exp(Fb + m_prev[..., None] - m_i)  # [B,H,Q]
            num = sc @ vb + w_inter[..., None] * (qb @ C)
            den = sc.sum(-1) + w_inter * (qb @ n[..., None])[..., 0]
            den = torch.maximum(den.abs(), torch.exp(-m_i))
            hs.append(num / den[..., None])                    # [B,H,Q,dv]
            # the state at the chunk's end
            m_next = torch.maximum(Ftb + m_prev, m_state)
            wk = torch.exp(g_tail - m_next[..., None])         # [B,H,Q]
            decay = torch.exp(Ftb + m_prev - m_next)           # [B,H]
            kw = kb * wk[..., None]
            C = decay[..., None, None] * C + kw.transpose(-1, -2) @ vb
            n = decay[..., None] * n + kw.sum(2)
            m_prev = m_next
        h = torch.cat(hs, dim=2).transpose(1, 2).reshape(
            B, S, self.inner).to(x.dtype)
        out = self._out(h, z)
        if return_state:
            return out, MLSTMState(C, n, m_prev)
        return out

    def init_state(self, batch: int) -> MLSTMState:
        dev = self.up.device
        f32 = torch.float32
        return MLSTMState(
            torch.zeros((batch, self.heads, self.dk, self.dv), dtype=f32,
                        device=dev),
            torch.zeros((batch, self.heads, self.dk), dtype=f32, device=dev),
            torch.full((batch, self.heads), M_START, dtype=f32, device=dev))

    def decode(self, x, state: MLSTMState):
        """x: [B, 1, d] -> [B, 1, d]; ``state`` is advanced in place."""
        B = x.shape[0]
        z, q, k, v, i_raw, f_raw = self._proj(x)
        q, k, v = (t[:, :, 0].float() for t in (q, k, v))  # [B,H,dk|dv]
        i_t, logf = i_raw[..., 0], F.logsigmoid(f_raw[..., 0])   # [B,H]
        m_new = torch.maximum(logf + state.m, i_t)
        a = torch.exp(logf + state.m - m_new)
        b = torch.exp(i_t - m_new)
        state.c.mul_(a[..., None, None]).add_(
            b[..., None, None] * (k[..., :, None] * v[..., None, :]))
        state.n.mul_(a[..., None]).add_(b[..., None] * k)
        state.m.copy_(m_new)
        # q scaled by dk^-1/2, as in the parallel form
        qs = q * self.dk ** -0.5
        num = (qs[..., None, :] @ state.c)[..., 0, :]       # [B,H,dv]
        den = (qs * state.n).sum(-1).abs()
        den = torch.maximum(den, torch.exp(-m_new))
        y = (num / den[..., None]).to(x.dtype).reshape(B, 1, self.inner)
        return self._out(y, z)


class SLSTMBlock(nn.Module):
    """sLSTM with per-head recurrent gate connections, then a gated FFN of
    projection factor 4/3 (rounded up to a multiple of 128)."""

    def __init__(self, cfg: ModelConfig, *, device: torch.device) -> None:
        super().__init__()
        assert cfg.xlstm is not None
        self.cfg = cfg
        d = cfg.d_model
        self.inner = d
        self.heads = cfg.num_heads
        self.hd = d // self.heads
        ff = -(-int(d * cfg.xlstm.slstm_proj_factor) // 128) * 128
        dt = dtype_of(cfg.param_dtype)
        f32 = torch.float32
        declare(self, "wx", (d, 4 * d), f32, device, d ** -0.5)
        declare(self, "r", (self.heads, self.hd, 4 * self.hd), f32, device,
                self.hd ** -0.5)
        declare(self, "norm", (d,), dt, device, None)
        declare(self, "up", (d, 2 * ff), dt, device, d ** -0.5)
        declare(self, "down", (ff, d), dt, device, ff ** -0.5)

    def init_state(self, batch: int) -> SLSTMState:
        def zeros():
            return torch.zeros((batch, self.inner), dtype=torch.float32,
                               device=self.wx.device)
        return SLSTMState(zeros(), zeros(), zeros(),
                          torch.full_like(zeros(), M_START))

    def _cell(self, xt, state: SLSTMState) -> SLSTMState:
        """One position. xt: [B, 4d] pre-activations from the input side;
        the new state, whose ``h`` is the output."""
        B = xt.shape[0]
        rec = torch.bmm(state.h.reshape(B, self.heads, self.hd)
                        .transpose(0, 1), self.r)             # [H, B, 4hd]
        rec = rec.transpose(0, 1).reshape(B, 4 * self.inner)
        zi, ii, fi, oi = (xt + rec).chunk(4, dim=-1)
        ft = F.logsigmoid(fi)
        m_new = torch.maximum(ft + state.m, ii)           # ii: log-space gate
        a = torch.exp(ft + state.m - m_new)
        b = torch.exp(ii - m_new)
        c = a * state.c + b * torch.tanh(zi)
        n = a * state.n + b
        # maximum, not clamp: at n == 1 (the first position) the gradient
        # splits between the two, as jnp.maximum's does
        h = torch.sigmoid(oi) * c / torch.maximum(n, n.new_ones(()))
        return SLSTMState(c, n, h, m_new)

    def _ffn(self, h, dtype):
        h = rms_norm(h.to(dtype), self.norm, self.cfg.norm_eps)
        u, g = (h @ self.up.to(dtype)).chunk(2, dim=-1)
        return (F.gelu(u, approximate="tanh") * g) @ self.down.to(dtype)

    def forward(self, x, *, return_state: bool = False):
        B, S, _ = x.shape
        xg = x.float() @ self.wx                          # [B,S,4d]
        state = self.init_state(B)
        hs = []
        for t in range(S):
            state = self._cell(xg[:, t], state)
            hs.append(state.h)
        out = self._ffn(torch.stack(hs, dim=1), x.dtype)
        if return_state:
            return out, state
        return out

    def decode(self, x, state: SLSTMState):
        """x: [B, 1, d] -> [B, 1, d]; ``state`` is advanced in place."""
        new = self._cell(x[:, 0].float() @ self.wx, state)
        copy_state(state, new)
        return self._ffn(new.h[:, None], x.dtype)
