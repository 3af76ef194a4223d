"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8 experts, MTP.

61L d_model=7168 128H (MLA; assignment lists kv=128) moe d_ff=2048
vocab=129280, 256 routed experts top-8 [arXiv:2412.19437].
First 3 layers are dense FFN (width 18432, per the paper's own config);
the assignment's d_ff=2048 is the per-routed-expert width.
"""
from repro_torch.config import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,
    d_ff=18432,                  # dense layers 0..2 (DeepSeek-V3 paper value)
    vocab=129280,
    attention="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_routed=256, top_k=8, d_ff=2048, n_shared=1,
                  layer_offset=3, layer_period=1),
    mtp=True,
    rope_theta=10000.0,
    norm_eps=1e-6,
)
