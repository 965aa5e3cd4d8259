"""nemotron-4-15b [dense]: 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000 — GQA, squared-ReLU MLP.  [arXiv:2402.16819; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=24576,
    vocab=256000,
    head_dim=128,
    max_seq=4096,
    rope_theta=10_000.0,
    activation="relu2",
    gated_mlp=False,
)
