"""Weight products of the model, plain path (port of
`repro.models.quantize`).

The int8 weight-only drafter path (`{"w8", "scale"}` leaves and its
fused GEMV kernel) is not ported yet: `resolve_drafter_quant` refuses any
drafter that resolves to int8 (ROADMAP queue 1 item 8) instead of
quietly serving it at full precision.

JAX promotes a bf16 x f32 product to f32; torch refuses mixed dtypes, so
the promotion is written out here.
"""
from __future__ import annotations

import torch

INT8_ROADMAP = ("int8 weight-only drafters are not ported yet "
                "(ROADMAP queue 1 item 8)")


def _promote(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def is_quantized(leaf) -> bool:
    """True iff `leaf` is a quantized-weight dict (``{"w8", "scale"}``)."""
    return isinstance(leaf, dict) and "w8" in leaf and "scale" in leaf


def qdot(x, w):
    """``x @ w`` with JAX's type promotion (bf16 x f32 -> f32)."""
    if is_quantized(w):
        raise NotImplementedError(INT8_ROADMAP)
    x, w = _promote(x, w)
    return x @ w


def embed_lookup(emb, tokens, dtype):
    """Embedding row gather, cast to the activation dtype."""
    if is_quantized(emb):
        raise NotImplementedError(INT8_ROADMAP)
    return emb[tokens.long()].to(dtype)


def tied_logits(emb, x):
    """``x @ embed.T`` with the table cast DOWN to x's dtype, as the
    reference does (a bf16 product for bf16 activations)."""
    if is_quantized(emb):
        raise NotImplementedError(INT8_ROADMAP)
    return x @ emb.t().to(x.dtype)


def dequantize_weight(q, dtype=torch.float32):
    """Plain weights as `dtype` (the int8 form is not ported)."""
    if is_quantized(q):
        raise NotImplementedError(INT8_ROADMAP)
    return q.to(dtype)


def resolve_drafter_quant(drafters, pool_default: str = "none"):
    """Resolve each drafter's weight mode (``cfg.quant`` or the pool
    default). Full-precision specs pass through; int8 raises."""
    out = []
    for cfg, params, domain in drafters:
        eff = cfg.quant or pool_default
        if eff == "int8":
            raise NotImplementedError(f"drafter {cfg.name!r}: {INT8_ROADMAP}")
        out.append((cfg, params, domain))
    return out
