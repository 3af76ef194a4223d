"""Transformer building blocks on tensors (port of `repro.models.layers`):
norms, rotary embeddings, MLPs and their initialisers."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models.quantize import qdot


def dense_init(gen: torch.Generator, shape, device, scale=None):
    """Normal(0, scale) f32 weight, drawn from `gen`; scale defaults to
    1/sqrt(fan_in)."""
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    # scaled in place: no second copy of a large (expert-stacked) weight
    return w.mul_(1.0 / math.sqrt(shape[0]) if scale is None else scale)


def embed_init(gen: torch.Generator, shape, device):
    """Normal(0, 0.02) f32 embedding table, drawn from `gen`."""
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return w.mul_(0.02)


# ---------------- norms ----------------

def norm_params(cfg: ModelConfig, d: int, device):
    if cfg.norm_type == "layer":
        return {"scale": torch.ones(d, device=device),
                "bias": torch.zeros(d, device=device)}
    return {"scale": torch.ones(d, device=device)}


def apply_norm(p, x, cfg: ModelConfig):
    """RMSNorm or LayerNorm in f32, cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    if cfg.norm_type == "layer":
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"] + p["bias"]
    else:  # rmsnorm
        ms = (x * x).mean(dim=-1, keepdim=True)
        y = x * torch.rsqrt(ms + cfg.norm_eps) * p["scale"]
    return y.to(dt)


def rms_norm_headwise(scale, x, eps=1e-6):
    """qk-norm: RMS norm over the last (head) dim."""
    dt = x.dtype
    x = x.float()
    ms = (x * x).mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(ms + eps) * scale).to(dt)


# ---------------- rotary embeddings ----------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., T, H, D) or (..., T, D); positions broadcastable to (..., T)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (D/2,)
    ang = positions[..., None].float() * freqs             # (..., T, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.dim() == positions.dim() + 2:                     # head axis present
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------- MLPs ----------------

def mlp_params(gen: torch.Generator, cfg: ModelConfig, d_model: int,
               d_ff: int, device):
    if cfg.mlp_type == "gelu":
        return {
            "wi": dense_init(gen, (d_model, d_ff), device),
            "bi": torch.zeros(d_ff, device=device),
            "wo": dense_init(gen, (d_ff, d_model), device),
            "bo": torch.zeros(d_model, device=device),
        }
    return {  # swiglu
        "wg": dense_init(gen, (d_model, d_ff), device),
        "wu": dense_init(gen, (d_model, d_ff), device),
        "wd": dense_init(gen, (d_ff, d_model), device),
    }


def apply_mlp(p, x, cfg: ModelConfig):
    """SwiGLU (or GELU with biases); matmuls promote as the reference."""
    if cfg.mlp_type == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(qdot(x, p["wi"]) + p["bi"], approximate="tanh")
        return qdot(h, p["wo"]) + p["bo"]
    return qdot(F.silu(qdot(x, p["wg"])) * qdot(x, p["wu"]), p["wd"])
