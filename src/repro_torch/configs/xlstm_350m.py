"""xlstm-350m [ssm]: 24L d_model=1024 4H vocab=50304 — alternating
sLSTM + mLSTM blocks (d_ff=0: blocks carry their own projections).
[arXiv:2405.04517; unverified]"""

from repro_torch.models.config import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab=50304,
    head_dim=256,
    max_seq=524288,
    xlstm=XLSTMConfig(slstm_every=2, mlstm_proj_factor=2.0,
                      slstm_proj_factor=1.3333, mlstm_head_dim=256),
)
