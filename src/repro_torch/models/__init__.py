from repro_torch.models.config import ModelConfig, smoke_variant
from repro_torch.models.model import LM
