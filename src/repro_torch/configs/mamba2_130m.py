"""mamba2-130m [ssm] — attention-free SSD (state-space duality).

24L d_model=768 vocab=50280, ssm_state=128 [arXiv:2405.21060].
d_inner = 2*768 = 1536, head_dim=64 -> 24 SSD heads.
"""
from repro_torch.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=24,                   # SSD heads (d_inner / head_dim)
    n_kv_heads=24,
    d_ff=0,                       # attention-free, no MLP block
    vocab=50280,
    attention="none",
    pos_embed="none",
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk_size=128),
)
