"""Model configuration covering every assigned architecture family.

One dataclass drives dense, MoE, MLA, hybrid-SSM, xLSTM, encoder-only and
VLM assemblies.  The exact per-architecture instances live in
``repro_torch/configs/<id>.py`` (full scale) with reduced smoke variants.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    experts_per_token: int = 0
    shared_experts: int = 0
    d_ff_expert: int = 0            # per-expert hidden dim
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    first_dense_layers: int = 0     # leading layers use dense FFN (deepseek)


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention compression dims."""
    q_lora_rank: int = 0            # 0 => full-rank q projection
    kv_lora_rank: int = 512
    rope_head_dim: int = 64         # decoupled rope dims per head
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64             # N (per the assignment: ssm_state=64)
    conv_width: int = 4
    expand: int = 2                 # inner dim = expand * d_model
    num_heads: int = 0              # 0 => inner_dim // head_dim
    head_dim: int = 64
    chunk: int = 256                # SSD chunk length
    attn_every: int = 6             # hybrid: shared attention block period
    shared_attn: bool = True        # zamba2: the attention block is shared


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 2            # one sLSTM block every N blocks
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 1.3333
    mlstm_head_dim: int = 256


@dataclass(frozen=True)
class VLMConfig:
    cross_attn_every: int = 5       # cross-attention layer period
    vision_dim: int = 1280          # stub frontend embedding width
    num_image_tokens: int = 1601    # tokens per image tile (stub)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 => d_model // num_heads
    max_seq: int = 8192

    # attention details
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0        # 0 => global attention
    local_global_pattern: int = 0  # k => k local layers then 1 global (gemma3)
    attn_logit_softcap: float = 0.0
    causal: bool = True            # False => encoder-only (hubert)

    # mlp
    activation: str = "silu"       # silu | gelu | relu2
    gated_mlp: bool = True         # gated (SwiGLU-style) vs plain 2-matrix

    # norms
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    vlm: Optional[VLMConfig] = None

    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    logits_dtype: str = "float32"

    # execution
    remat: str = "block"           # none | block | full
    scan_layers: bool = True

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_encoder_only(self) -> bool:
        return not self.causal

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline
        MODEL_FLOPS = 6*N*D accounting."""
        d, L = self.d_model, self.num_layers
        hd = self.head_dim_
        n = self.vocab * d  # embed
        if not self.tie_embeddings:
            n += self.vocab * d
        for i in range(L):
            n += self._block_params(i)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE counts only routed-in experts)."""
        d, L = self.d_model, self.num_layers
        n = self.vocab * d
        if not self.tie_embeddings:
            n += self.vocab * d
        for i in range(L):
            n += self._block_params(i, active_only=True)
        return n

    # -- internals ---------------------------------------------------------
    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim_
        if self.mla is not None:
            m = self.mla
            qdim = self.num_heads * (m.nope_head_dim + m.rope_head_dim)
            n = (d * m.q_lora_rank + m.q_lora_rank * qdim) if m.q_lora_rank \
                else d * qdim
            n += d * (m.kv_lora_rank + m.rope_head_dim)
            n += m.kv_lora_rank * self.num_heads * (m.nope_head_dim + m.v_head_dim)
            n += self.num_heads * m.v_head_dim * d
            return n
        q = d * self.num_heads * hd
        kv = 2 * d * self.num_kv_heads * hd
        o = self.num_heads * hd * d
        return q + kv + o

    def _ffn_params(self, dff: int) -> int:
        mult = 3 if self.gated_mlp else 2
        return mult * self.d_model * dff

    def _block_params(self, i: int, active_only: bool = False) -> int:
        d = self.d_model
        if self.family == "ssm" and self.xlstm is not None:
            inner = int(d * self.xlstm.mlstm_proj_factor)
            return 2 * d * inner + 3 * inner * inner // 4 + inner * d  # approx
        if self.family == "hybrid" and self.ssm is not None:
            s = self.ssm
            inner = s.expand * d
            n = d * 2 * inner + inner * d + inner * (2 * s.state_dim)
            if (i % s.attn_every) == 0 and not (s.shared_attn and i > 0):
                n += self._attn_params() + self._ffn_params(self.d_ff)
            return n
        n = self._attn_params()
        if self.moe is not None and i >= self.moe.first_dense_layers:
            m = self.moe
            per_expert = self._ffn_params(m.d_ff_expert)
            if active_only:
                n += (m.experts_per_token + m.shared_experts) * per_expert
            else:
                n += (m.num_experts + m.shared_experts) * per_expert
            n += d * m.num_experts  # router
        else:
            n += self._ffn_params(self.d_ff)
        n += 2 * d  # norms
        return n

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw = dict(
        num_layers=max(2, min(4, cfg.num_layers)),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(4, max(1, cfg.num_kv_heads)),
        d_ff=128,
        vocab=256,
        head_dim=16,
        max_seq=64,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4,
            experts_per_token=min(2, cfg.moe.experts_per_token),
            shared_experts=min(1, cfg.moe.shared_experts),
            d_ff_expert=64,
            first_dense_layers=min(1, cfg.moe.first_dense_layers))
    if cfg.mla is not None:
        kw["mla"] = dataclasses.replace(
            cfg.mla, q_lora_rank=32 if cfg.mla.q_lora_rank else 0,
            kv_lora_rank=32, rope_head_dim=8, nope_head_dim=16, v_head_dim=16)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, state_dim=16, head_dim=16,
                                        chunk=16, attn_every=2)
    if cfg.xlstm is not None:
        kw["xlstm"] = dataclasses.replace(cfg.xlstm, mlstm_head_dim=32)
    if cfg.vlm is not None:
        kw["vlm"] = dataclasses.replace(cfg.vlm, cross_attn_every=2,
                                        vision_dim=64, num_image_tokens=16)
    if cfg.local_global_pattern:
        kw["local_global_pattern"] = 2
        kw["sliding_window"] = 16
    elif cfg.sliding_window:
        kw["sliding_window"] = 16
    return cfg.scaled(name=cfg.name + "-smoke", **kw)
