"""Assigned architecture configs (one module per arch) + registry.

``get_config(arch_id)`` returns the full-scale ModelConfig exactly as
assigned; ``get_smoke(arch_id)`` the reduced same-family variant used by the
CPU smoke tests.  ``SHAPES`` defines the four assigned input shapes and
``applicable_shapes`` encodes the skip rules of DESIGN.md §5.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

from repro_torch.models.config import ModelConfig, smoke_variant

ARCH_IDS = [
    "gemma3_4b",
    "qwen3_8b",
    "starcoder2_3b",
    "nemotron_4_15b",
    "zamba2_2p7b",
    "deepseek_v2_236b",
    "granite_moe_1b_a400m",
    "llama32_vision_11b",
    "hubert_xlarge",
    "xlstm_350m",
]

# assigned LM shape grid: name -> (seq_len, global_batch, kind)
SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4_096, 256, "train"),
    "prefill_32k": (32_768, 32, "prefill"),
    "decode_32k": (32_768, 128, "decode"),
    "long_500k": (524_288, 1, "decode"),
}

# archs with an O(1)-state decode path run long_500k; encoder-only skips
# all decode shapes (DESIGN.md §5)
LONG_OK = {"zamba2_2p7b", "xlstm_350m"}
ENCODER_ONLY = {"hubert_xlarge"}


def get_config(arch_id: str) -> ModelConfig:
    arch_id = arch_id.replace("-", "_").replace(".", "p")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def get_smoke(arch_id: str) -> ModelConfig:
    return smoke_variant(get_config(arch_id))


def applicable_shapes(arch_id: str) -> List[str]:
    arch_id = arch_id.replace("-", "_").replace(".", "p")
    out = ["train_4k", "prefill_32k"]
    if arch_id not in ENCODER_ONLY:
        out.append("decode_32k")
        if arch_id in LONG_OK:
            out.append("long_500k")
    return out


def skip_reason(arch_id: str, shape: str) -> str:
    arch_id = arch_id.replace("-", "_").replace(".", "p")
    if shape in applicable_shapes(arch_id):
        return ""
    if arch_id in ENCODER_ONLY:
        return "encoder-only: no decode step"
    return "full quadratic attention: no sub-quadratic long-context path"
