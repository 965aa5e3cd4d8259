"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242; hf]"""

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    head_dim=80,
    max_seq=4096,
    activation="gelu",
    ssm=SSMConfig(state_dim=64, conv_width=4, expand=2, head_dim=64,
                  chunk=256, attn_every=6, shared_attn=True),
)
