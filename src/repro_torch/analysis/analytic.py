"""Analytic FLOP / HBM-byte models per (arch, shape, step).

Why analytic: XLA's HloCostAnalysis counts while-loop bodies once, so a
scan-over-layers model under-reports flops/bytes by ~n_layers on the CPU
dry-run backend (EXPERIMENTS.md §Roofline documents the cross-check).
These closed forms are the primary compute/memory roofline terms; the
collective term comes from the trip-corrected HLO parse (analysis/hlo.py).

Conventions: ideal causal attention (half the square), bf16 tensors,
MoE counts only active (shared + top-k) experts, remat adds one forward
recompute to training.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.config import INPUT_SHAPES, ModelConfig


def _per_token_matmul_flops(cfg: ModelConfig) -> float:
    """2 * active-params matmul flops per token (excluding attention
    score/value products)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    total = 2.0 * d * cfg.padded_vocab            # unembedding
    for i in range(cfg.n_layers):
        kind = cfg.layer_kind(i)
        if kind == "attn":
            if cfg.attention == "mla":
                m = cfg.mla
                total += 2 * d * m.q_lora_rank
                total += 2 * m.q_lora_rank * hq * m.qk_head_dim
                total += 2 * d * (m.kv_lora_rank + m.qk_rope_head_dim)
                # absorbed q/out projections (per-token, per-head latent)
                total += 2 * hq * m.qk_nope_head_dim * m.kv_lora_rank * 2
                total += 2 * hq * m.v_head_dim * d
            else:
                total += 2 * d * (hq + 2 * hkv) * hd + 2 * hq * hd * d
        else:  # ssm mixer
            s = cfg.ssm
            din = s.d_inner(d)
            total += 2 * d * (2 * din + 2 * s.n_groups * s.d_state
                              + s.n_heads(d))
            total += 2 * din * d
            # SSD state update+readout: 2 * d_inner * d_state each
            total += 4 * din * s.d_state
        if cfg.is_cross_layer(i) or cfg.is_encdec:
            total += 2 * d * (hq + hkv * 2) * hd + 2 * hq * hd * d
        if cfg.is_moe_layer(i):
            moe = cfg.moe
            total += 2 * 3 * d * (moe.top_k * moe.d_ff + moe.shared_width)
            total += 2 * d * moe.n_routed  # router
        elif cfg.layer_kind(i) == "attn" or cfg.d_ff:
            mult = 3 if cfg.mlp_type == "swiglu" else 2
            total += 2 * mult * d * cfg.d_ff
    return total


def _attn_context_flops(cfg: ModelConfig, q_tokens: float,
                        kv_len: float, causal: bool) -> float:
    """QK^T + PV flops for q_tokens queries against kv_len keys (per seq)."""
    hq, hd = cfg.n_heads, cfg.resolved_head_dim
    if cfg.attention == "mla":
        hd_eff = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        hd_v = cfg.mla.kv_lora_rank
    else:
        hd_eff = hd_v = hd
    pairs = q_tokens * kv_len * (0.5 if causal and q_tokens == kv_len else 1.0)
    n_attn = sum(1 for i in range(cfg.n_layers) if cfg.layer_kind(i) == "attn")
    per_layer = 2 * pairs * hq * (hd_eff + hd_v)
    cross = 0.0
    if cfg.cross_attn_period or cfg.is_encdec:
        n_cross = sum(1 for i in range(cfg.n_layers)
                      if cfg.is_cross_layer(i) or cfg.is_encdec)
        cross = n_cross * 2 * q_tokens * cfg.n_frontend_tokens * hq * 2 * hd
    return n_attn * per_layer + cross


def _kv_cache_bytes(cfg: ModelConfig, kv_len: float, batch: float,
                    dtype_bytes: int = 0) -> float:
    from repro_torch.models.model import effective_window
    if not dtype_bytes:
        dtype_bytes = 1 if cfg.kv_dtype == "int8" else 2
    win = effective_window(cfg)
    total = 0.0
    for i in range(cfg.n_layers):
        if cfg.layer_kind(i) == "attn":
            eff = min(kv_len, win + 128) if win else kv_len
            if cfg.attention == "mla":
                per_tok = cfg.mla.cache_dim * 2  # k_eff + v_eff rows
            else:
                per_tok = 2 * cfg.n_kv_heads * cfg.resolved_head_dim
            total += eff * per_tok * dtype_bytes * batch
        else:
            s = cfg.ssm
            total += (s.n_heads(cfg.d_model) * s.head_dim * s.d_state * 4
                      * batch)
        if cfg.is_cross_layer(i) or cfg.is_encdec:
            total += (cfg.n_frontend_tokens * 2 * cfg.n_kv_heads
                      * cfg.resolved_head_dim * dtype_bytes * batch)
    return total


def weight_stream_bytes(cfg: ModelConfig, n_params: float) -> float:
    """Bytes to stream `n_params` weights through HBM once. bf16 models
    stream 2 B/param; a weight-only-int8 model (cfg.quant, DESIGN.md
    §2.9) streams 1 B/param plus the per-output-channel f32 scales —
    one f32 per d_model-long input column, i.e. ~4/d_model extra bytes
    per param, accounted but negligible. The KV-cache side of the dtype
    story lives in `_kv_cache_bytes` (cfg.kv_dtype quantizes cached
    *activations*; cfg.quant quantizes *weights* — orthogonal knobs)."""
    if getattr(cfg, "quant", "") == "int8":
        return n_params * (1.0 + 4.0 / max(cfg.d_model, 1))
    return n_params * 2.0


@dataclass
class Estimate:
    flops: float            # global, one step
    hbm_bytes: float        # global, one step


def estimate(cfg: ModelConfig, shape_name: str, step: str,
             n_active_params: int, n_total_params: int,
             gamma: int = 16) -> Estimate:
    ishape = INPUT_SHAPES[shape_name]
    B, S = ishape.global_batch, ishape.seq_len
    P_act, P_tot = float(n_active_params), float(n_total_params)

    if step == "train":
        tokens = B * S
        fwd = _per_token_matmul_flops(cfg) * tokens \
            + B * _attn_context_flops(cfg, S, S, causal=True)
        flops = 4 * fwd            # fwd + bwd(2x) + remat recompute(1x)
        # params read fwd+bwd + grad write + optimizer touch; activations
        # at checkpoint boundaries r/w
        act = tokens * cfg.d_model * cfg.n_layers * 2 * 4.0
        hbm = P_tot * 2 * 4 + act
    elif step == "prefill":
        tokens = B * S
        flops = _per_token_matmul_flops(cfg) * tokens \
            + B * _attn_context_flops(cfg, S, S, causal=True)
        hbm = weight_stream_bytes(cfg, P_act) + _kv_cache_bytes(cfg, S, B) \
            + tokens * cfg.d_model * cfg.n_layers * 2 * 2.0
        # weights stream once more per microbatch
        hbm += weight_stream_bytes(cfg, P_act)
    else:  # decode / verify: q_tokens per request
        q = gamma if step == "verify" else 1
        tokens = B * q
        flops = _per_token_matmul_flops(cfg) * tokens \
            + B * _attn_context_flops(cfg, q, S, causal=False)
        hbm = weight_stream_bytes(cfg, P_act) + _kv_cache_bytes(cfg, S, B) \
            + tokens * cfg.d_model * cfg.n_layers * 2 * 2.0
    return Estimate(flops=flops, hbm_bytes=hbm)
