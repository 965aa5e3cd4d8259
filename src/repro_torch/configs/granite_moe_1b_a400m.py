"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512,
vocab=49155, 32 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""

from repro_torch.models.config import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=8,
    d_ff=512,
    vocab=49155,
    head_dim=64,
    max_seq=4096,
    activation="silu",
    tie_embeddings=True,
    moe=MoEConfig(num_experts=32, experts_per_token=8, shared_experts=0,
                  d_ff_expert=512, capacity_factor=1.25),
)
