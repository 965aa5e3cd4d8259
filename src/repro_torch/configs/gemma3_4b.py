"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144 — 5:1 local:global sliding-window pattern, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    d_ff=10240,
    vocab=262144,
    head_dim=256,
    max_seq=131072,
    sliding_window=1024,
    local_global_pattern=5,      # 5 local layers, then 1 global
    attn_logit_softcap=50.0,
    rope_theta=1_000_000.0,
    activation="gelu",
    tie_embeddings=True,
)
