"""jamba-v0.1-52b [hybrid] — Mamba + attention 1:7 interleave, MoE 16e top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536 [arXiv:2403.19887].
Attention at layer i where i % 8 == 4 (1 attention : 7 mamba);
MoE at odd layers (period 2, offset 1). No positional embedding (Jamba
relies on Mamba for position). The Mamba mixer here is the SSD (Mamba2)
formulation — noted adaptation in DESIGN.md.
"""
from repro_torch.config import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=65536,
    attention="full",
    pos_embed="none",
    hybrid_attn_period=8,
    hybrid_attn_offset=4,
    moe=MoEConfig(n_routed=16, top_k=2, d_ff=14336,
                  layer_offset=1, layer_period=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk_size=128),
)
