"""llama-3.2-vision-11b [vlm]: 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256 — cross-attention image layers every 5th layer; the vision
frontend is a STUB (input_specs provides precomputed patch embeddings).
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""

from repro_torch.models.config import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    head_dim=128,
    max_seq=131072,
    rope_theta=500_000.0,
    activation="silu",
    vlm=VLMConfig(cross_attn_every=5, vision_dim=1280, num_image_tokens=1601),
)
