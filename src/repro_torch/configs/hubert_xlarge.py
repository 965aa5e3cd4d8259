"""hubert-xlarge [audio]: 48L d_model=1280 16H d_ff=5120 vocab=504 —
encoder-only (no causal mask, no decode); the conv feature frontend is a
STUB (input_specs provides precomputed 512-d frame embeddings).
[arXiv:2106.07447; unverified]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab=504,
    head_dim=80,
    max_seq=32768,
    causal=False,
    activation="gelu",
    gated_mlp=False,
)
