"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff=1536 vocab=102400,
MLA kv_lora=512, MoE: 2 shared + 160 routed experts, top-6.
[arXiv:2405.04434; hf]"""

from repro_torch.models.config import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=12288,                  # dense FFN of the first layer
    vocab=102400,
    head_dim=128,
    max_seq=131072,
    rope_theta=10_000.0,
    activation="silu",
    moe=MoEConfig(num_experts=160, experts_per_token=6, shared_experts=2,
                  d_ff_expert=1536, capacity_factor=1.25,
                  first_dense_layers=1),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
)
