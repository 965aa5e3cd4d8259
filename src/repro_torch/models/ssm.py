"""Mamba2 (SSD) block, the state-space half of the zamba2 hybrid
(``repro/models/ssm.py``).

Training and prefill run the chunked SSD: within each chunk of ``Q``
positions an attention-like product with the decays ``exp(g_q - g_k)``,
across chunks a recurrence over the chunk states, here a Python loop over
the ``S / Q`` chunks.  Decode keeps the recurrent state ``[B, H, N, P]``
and the last ``W - 1`` conv inputs, and updates both in place.

The reference writes the intra-chunk and state products as three-operand
einsums.  ``torch.einsum`` contracts left to right without planning, so
here they are explicit products and ``matmul`` s over head-major layouts:
the largest array is the reference's own ``[B, nc, Q, Q, H]`` decay
matrix (held as ``[B, nc, H, Q, Q]``).  The decays are float32 and cast
to the compute dtype where the reference casts them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist.act_sharding import by_rows, whole
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ONES, declare, dtype_of, rms_norm


@dataclass
class SSMState:
    """One Mamba2 layer's decode state, updated in place."""

    s: torch.Tensor      # [B, H, N, P]
    conv: torch.Tensor   # [B, W-1, conv_dim] rolling conv inputs


class Mamba2Block(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device: torch.device) -> None:
        super().__init__()
        assert cfg.ssm is not None
        self.cfg = cfg
        s = cfg.ssm
        d = cfg.d_model
        inner = s.expand * d
        self.inner = inner
        self.heads = s.num_heads or inner // s.head_dim
        self.P = inner // self.heads
        self.N = s.state_dim
        self.conv_dim = inner + 2 * self.N   # x, B and C share the conv
        dt = dtype_of(cfg.param_dtype)
        f32 = torch.float32
        declare(self, "in_proj", (d, 2 * inner + 2 * self.N + self.heads),
                dt, ("embed", "ff"), device, d ** -0.5)
        declare(self, "conv_w", (s.conv_width, self.conv_dim), dt,
                (None, "ff"), device, s.conv_width ** -0.5)
        declare(self, "A_log", (self.heads,), f32, (None,), device, None)
        declare(self, "D", (self.heads,), f32, (None,), device, ONES)
        declare(self, "dt_bias", (self.heads,), f32, (None,), device, None)
        declare(self, "norm", (inner,), dt, ("ff",), device, None)
        declare(self, "out_proj", (inner, d), dt, ("ff", "embed"), device,
                inner ** -0.5)

    # -- shared pieces --------------------------------------------------------
    # placed: the projections are made whole on the dim they split, which
    # the rules shard ("ff"); torch 2.11's DTensor gives a split of a
    # sharded dim one placement for a mesh of two dims

    def _project(self, x):
        proj = whole(x @ self.in_proj.to(x.dtype), -1)
        return proj.split([self.inner, self.conv_dim, self.heads], dim=-1)

    def _split_xbc(self, xbc):
        return whole(xbc, -1).split([self.inner, self.N, self.N], dim=-1)

    def _gates(self, dt_raw, A_log=None, dt_bias=None):
        dt_bias = self.dt_bias if dt_bias is None else dt_bias
        A_log = self.A_log if A_log is None else A_log
        dt = F.softplus(dt_raw.float() + dt_bias)
        return dt, -torch.exp(A_log)                      # [.., H], [H] < 0

    def _out(self, y, z):
        y = rms_norm(y * F.silu(z), self.norm, self.cfg.norm_eps)
        return y @ self.out_proj.to(y.dtype)

    # -- training / prefill: chunked SSD --------------------------------------
    def forward(self, x, *, return_state: bool = False):
        s = self.cfg.ssm
        B, S, _ = x.shape
        assert S % min(s.chunk, S) == 0, \
            f"seq {S} not divisible by chunk {min(s.chunk, S)}"
        z, xbc, dt_raw = self._project(x)
        # placed: each rank its own batch rows, every head (torch 2.11's
        # DTensor gives the conv's pad a malformed layout, and refuses the
        # chunk products' flatten of a sharded batch and heads)
        y, s_c, tail = by_rows(self._ssd, (xbc, dt_raw),
                               (self.conv_w, self.A_log, self.D,
                                self.dt_bias))
        out = self._out(y.reshape(B, S, self.inner), z)
        if return_state:
            return out, SSMState(s_c, tail)
        return out

    def _ssd(self, xbc, dt_raw, conv_w, A_log, D, dt_bias):
        """The causal conv and the chunked SSD on plain tensors: (y [B, S,
        H, P] with the D skip, the final state [B, H, N, P], the last W - 1
        conv inputs)."""
        s = self.cfg.ssm
        B, S, _ = xbc.shape
        H, P, N, Q = self.heads, self.P, self.N, min(s.chunk, S)
        W, dtp = s.conv_width, xbc.dtype

        # causal depthwise conv over (x, B, C)
        w = conv_w.to(dtp)
        xbc_pad = F.pad(xbc, (0, 0, W - 1, 0))
        conv = sum(xbc_pad[:, i:i + S] * w[i] for i in range(W))
        xs, Bm, Cm = self._split_xbc(F.silu(conv))

        dt, A = self._gates(dt_raw, A_log, dt_bias)       # [B,S,H], [H]
        xh = xs.reshape(B, S, H, P)
        nc = S // Q
        # head-major chunks: [B, nc, H, Q, P], [B, nc, 1, Q, N], [B, nc, H, Q]
        xbar = (xh * dt[..., None].to(dtp)).reshape(B, nc, Q, H, P) \
            .permute(0, 1, 3, 2, 4)
        Bc = Bm.reshape(B, nc, 1, Q, N)
        Cc = Cm.reshape(B, nc, 1, Q, N)
        g = torch.cumsum((dt * A).reshape(B, nc, Q, H), dim=2) \
            .permute(0, 1, 3, 2)                          # log decay, f32

        # intra-chunk (attention-like, causal within the chunk)
        rel = g[..., :, None] - g[..., None, :]           # [B,nc,H,Q,Q]
        causal = torch.ones(Q, Q, dtype=torch.bool, device=xbc.device).tril()
        L = torch.exp(rel.masked_fill(~causal, float("-inf"))).to(dtp)
        cb = Cc @ Bc.transpose(-1, -2)                    # [B,nc,1,Q,Q]
        y = (cb * L) @ xbar                               # [B,nc,H,Q,P]

        # chunk summary states [B, nc, H, N, P]
        decay_tail = torch.exp(g[..., -1:] - g).to(dtp)   # [B,nc,H,Q]
        states = Bc.transpose(-1, -2) @ (xbar * decay_tail[..., None])

        # inter-chunk recurrence, one chunk at a time
        chunk_decay = torch.exp(g[..., -1]).to(dtp)       # [B,nc,H]
        s_c = torch.zeros((B, H, N, P), dtype=dtp, device=xbc.device)
        s_prevs = []
        for c in range(nc):
            s_prevs.append(s_c)
            s_c = s_c * chunk_decay[:, c, :, None, None] + states[:, c]
        s_prevs = torch.stack(s_prevs, dim=1)             # [B,nc,H,N,P]
        y = y + (Cc @ s_prevs) * torch.exp(g).to(dtp)[..., None]

        y = y.permute(0, 1, 3, 2, 4).reshape(B, S, H, P)
        y = y + xh * D.to(dtp)[None, None, :, None]
        return y, s_c, xbc_pad[:, S:]

    # -- decode ---------------------------------------------------------------
    def init_state(self, batch: int) -> SSMState:
        dt = dtype_of(self.cfg.compute_dtype)
        dev = self.in_proj.device
        return SSMState(
            torch.zeros((batch, self.heads, self.N, self.P), dtype=dt,
                        device=dev),
            torch.zeros((batch, self.cfg.ssm.conv_width - 1, self.conv_dim),
                        dtype=dt, device=dev))

    def decode(self, x, state: SSMState):
        """x: [B, 1, d] -> [B, 1, d]; ``state`` is advanced in place."""
        B, dtp = x.shape[0], x.dtype
        z, xbc, dt_raw = self._project(x)
        window = torch.cat([state.conv, xbc], dim=1)      # [B, W, conv_dim]
        conv = F.silu((window * self.conv_w.to(dtp)).sum(1))[:, None]
        xs, Bm, Cm = self._split_xbc(conv)
        dt, A = self._gates(dt_raw)                       # [B,1,H]
        xh = xs.reshape(B, 1, self.heads, self.P)
        a = torch.exp(dt * A)[:, 0]                       # [B,H]
        xbar = (xh * dt[..., None].to(dtp))[:, 0]         # [B,H,P]
        st = state.s
        st.mul_(a[..., None, None].to(st.dtype))
        st.add_(Bm[:, 0, None, :, None] * xbar[:, :, None, :])
        y = (Cm[:, 0, None, None, :] @ st)[:, :, 0]       # [B,H,P]
        y = y + xh[:, 0] * self.D.to(dtp)[None, :, None]
        state.conv.copy_(window[:, 1:])
        return self._out(y.reshape(B, 1, self.inner), z)
