"""whisper-small [audio] — encoder-decoder transformer backbone.

12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865 [arXiv:2212.04356].
Conv/mel frontend is stubbed: input_specs() supplies precomputed frame
embeddings (batch, 1500, d_model). LayerNorm + GELU + learned positions,
per the Whisper architecture. max_position is widened beyond Whisper's 448
so the assigned 32k decoder shapes are expressible.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,                  # decoder layers
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab=51865,
    norm_type="layer",
    mlp_type="gelu",
    pos_embed="learned",
    max_position=65536,
    encoder_layers=12,
    encoder_seq=1500,             # 30 s of audio at 50 Hz after conv frontend
    n_frontend_tokens=1500,
    attention="full",
)
