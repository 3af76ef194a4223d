"""llama-3.2-vision-11b [vlm] — language decoder with cross-attention image layers.

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256
[hf:meta-llama/Llama-3.2-11B-Vision]. Cross-attention at layers
3,8,...,38 (period 5, offset 3). Vision encoder + projector stubbed:
input_specs() supplies projected patch embeddings (batch, 1601, d_model).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=128256,
    cross_attn_period=5,
    cross_attn_offset=3,
    n_frontend_tokens=1601,       # 1 tile x (40x40 patches + 1 cls)
    rope_theta=500000.0,
)
