"""Weight products of the model and weight-only int8 drafters (port of
`repro.models.quantize`).

Per-output-channel symmetric quantization of a drafter's dense and
embedding weights: each quantized leaf becomes ``{"w8": int8, "scale":
f32}`` where ``scale`` keeps the reduced axis as a size-1 dim
(``absmax / 127`` over the input axis for dense kernels, ``(1, N)``;
over ``d_model`` for the embedding table, ``(V, 1)``). Rounding is
round-half-to-even, as in the reference, so ``w8`` and ``scale`` are
bitwise the reference's for the same weights.

Quantized products go through the fused int8 GEMV
(`kernels.int8_gemv.ops.int8_gemv`): on CUDA tensors its Hopper kernel,
for any number of rows, or an error; on CPU tensors its plain version.
It accumulates in f32 and casts the result to the activation dtype once,
as the Pallas kernel does; the reference's XLA `qdot` rounds a bf16
product to bf16 instead (ROADMAP queue 3). Only drafter proposals can
change from that: the target's greedy walk never reads drafter logits.

JAX promotes a bf16 x f32 product to f32; torch refuses mixed dtypes, so
the promotion of the plain product is written out here.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.int8_gemv import ops as int8_ops

# dense 2-D kernels eligible for weight-only int8 (the reference's set)
_DENSE_KEYS = frozenset({
    "wq", "wk", "wv", "wo", "wi", "wg", "wu", "wd", "in_proj", "out_proj",
})
# MLA's latent projections are consumed through reshaped einsums (no
# single ``x @ w`` site to dispatch)
_MLA_KEYS = frozenset({"wdq", "wuq", "wdkv", "wkr", "wuk", "wuv"})


def _promote(a, b):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def is_quantized(leaf) -> bool:
    """True iff `leaf` is a quantized-weight dict (``{"w8", "scale"}``)."""
    return isinstance(leaf, dict) and "w8" in leaf and "scale" in leaf


def quantize_weight(w, axis: int = -2):
    """Symmetric per-channel int8 quantization of one weight tensor.

    `axis` is the reduced (input) axis: ``-2`` for dense ``(..., K, N)``
    kernels (scale ``(..., 1, N)``), ``-1`` for the embedding table
    ``(V, D)`` (scale ``(V, 1)``, serving the row lookup and the tied
    logits head). Leading axes are carried through."""
    wf = w.float()
    absmax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones_like(absmax))
    w8 = torch.clamp(torch.round(wf / scale), -127, 127)
    return {"w8": w8.to(torch.int8), "scale": scale}


def dequantize_weight(q, dtype=torch.float32):
    """Inverse of :func:`quantize_weight` (up to rounding); plain weights
    are cast to `dtype`."""
    if not is_quantized(q):
        return q.to(dtype)
    return (q["w8"].float() * q["scale"]).to(dtype)


def qdot(x, w):
    """``x @ w`` for a plain weight (with JAX's type promotion) or a
    quantized dict (``(x @ w8) * scale`` through the int8 GEMV, in x's
    dtype)."""
    if is_quantized(w):
        return int8_ops.int8_gemv(x, w["w8"], w["scale"])
    x, w = _promote(x, w)
    return x @ w


def embed_lookup(emb, tokens, dtype):
    """Embedding row gather for plain or quantized tables, in `dtype`."""
    idx = tokens.long()
    if is_quantized(emb):
        return emb["w8"][idx].to(dtype) * emb["scale"][idx].to(dtype)
    return emb[idx].to(dtype)


def tied_logits(emb, x):
    """``x @ embed.T``: a plain table is cast DOWN to x's dtype, as the
    reference does (a bf16 product for bf16 activations); a quantized
    table goes through the int8 GEMV read as its transpose, its per-row
    scales being per-output-column scales of the head."""
    if is_quantized(emb):
        return int8_ops.int8_gemv(x, emb["w8"].t(), emb["scale"])
    return x @ emb.t().to(x.dtype)


def _quantize_sublayer(p: dict) -> dict:
    out = {}
    for k, v in p.items():
        if k in ("mixer", "cross", "ffn") and isinstance(v, dict):
            if any(m in v for m in _MLA_KEYS):
                raise ValueError(
                    "int8 drafter quantization does not support MLA "
                    "mixers (latent projections are einsum-consumed); "
                    "use a dense-attention or SSM drafter")
            if "router" in v:  # MoE ffn: routed experts take plain weights
                out[k] = v
                continue
            out[k] = {kk: (quantize_weight(vv)
                           if kk in _DENSE_KEYS and not is_quantized(vv)
                           else vv)
                      for kk, vv in v.items()}
        else:
            out[k] = v
    return out


def quantize_params(params: dict, cfg=None) -> dict:
    """Calibrate-and-swap: quantize a checkpoint's dense weights.

    Returns new params where every eligible dense kernel of every layer
    and the embedding table (plus the untied head) are ``{"w8",
    "scale"}`` dicts; norms and biases pass through. Idempotent. `cfg`
    is accepted for symmetry with the reference (the walk is structural).
    """
    del cfg
    out = {}
    for k, v in params.items():
        if k == "embed":
            out[k] = v if is_quantized(v) else quantize_weight(v, axis=-1)
        elif k == "head":
            out[k] = v if is_quantized(v) else quantize_weight(v, axis=-2)
        elif k == "layers":
            out[k] = [_quantize_sublayer(p) for p in v]
        else:  # final_norm, pos
            out[k] = v
    return out


def resolve_drafter_quant(drafters, pool_default: str = "none"):
    """Apply per-node quantization to engine drafter specs.

    `drafters` is the engine's ``(ModelConfig, params, domain)`` list.
    Each node's mode is ``cfg.quant`` when set, else the pool-wide
    ``CoSineConfig.drafter_quant`` — so one pool can run an int8 node
    beside full-precision ones. Returns new specs with the resolved mode
    stamped into each cfg and params quantized where requested."""
    out = []
    for cfg, params, domain in drafters:
        eff = cfg.quant or pool_default
        if eff == "int8":
            cfg = cfg if cfg.quant == "int8" else \
                cfg.with_overrides(quant="int8")
            params = quantize_params(params, cfg)
        out.append((cfg, params, domain))
    return out
