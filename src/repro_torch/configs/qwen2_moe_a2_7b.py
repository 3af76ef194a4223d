"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts, top-4.

24L d_model=2048 16H (kv=16) expert d_ff=1408 vocab=151936
[hf:Qwen/Qwen1.5-MoE-A2.7B]. Shared expert width 4*1408 = 5632.
"""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=5632,                    # width used if a layer were dense (unused: all layers MoE)
    vocab=151936,
    qkv_bias=True,
    moe=MoEConfig(n_routed=60, top_k=4, d_ff=1408,
                  n_shared=4, shared_d_ff=5632,
                  layer_offset=0, layer_period=1),
    rope_theta=1000000.0,
)
