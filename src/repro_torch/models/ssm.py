"""Mamba2 SSD (state-space duality) mixer (port of `repro.models.ssm`).

The scan goes through `kernels.ssd_scan.ops.ssd_slots`: on CUDA tensors
the hand-written Hopper kernel, for every sequence length (decode, chain
verification, commit and prefill chunks), reading and writing the
layer's recurrent state in place; on CPU tensors its plain version. A
self-contained call under autograd (training) differentiates through
`ssd_ops.scan`. The plain chunked scan `ssd_chunked` is re-exported
here; `ssd_reference` (the naive recurrence over time) is the oracle of
the tests.

SSM state does not page: the recurrent state (`ssm`, (B, H, P, N)), the
conv tail (`conv`, (B, d_conv - 1, conv_dim)) and `pos` are O(1) per
request, so a paged cache keeps them slot-indexed exactly like the
resident one. They stay float32 whatever the cache dtype, as in the
reference.

Unlike the reference, which returns a write delta for its caller to
scatter, the port writes the new state of the active slots IN PLACE
(`slot_idx`), or of the rows of a plain batch cache, and only when
`write` is set. The scan kernel reads the `ssm` rows through `slot_idx`
and writes them back itself (no gather, no scatter); `conv` and `pos`
are gathered and written here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, SSMConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ops import ssd_chunked
from repro_torch.models.layers import dense_init
from repro_torch.models.quantize import qdot

__all__ = ["ssm_params", "make_ssm_state", "ssd_chunked", "ssd_reference",
           "ssm_mixer"]


# ---------------------------------------------------------------- params

def ssm_params(gen, cfg: ModelConfig, device):
    """Random f32 mixer parameters drawn from `gen`, with the reference's
    deterministic A_log, D_skip, dt_bias and norm initialisation."""
    s: SSMConfig = cfg.ssm
    D = cfg.d_model
    din = s.d_inner(D)
    H = s.n_heads(D)
    G, N = s.n_groups, s.d_state
    conv_dim = din + 2 * G * N
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(gen, (D, 2 * din + 2 * G * N + H), device),
        "conv_w": dense_init(gen, (s.d_conv, conv_dim), device, scale=0.2),
        "conv_b": torch.zeros(conv_dim, **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, **f32)),
        "D_skip": torch.ones(H, **f32),
        # softplus^-1(0.01)
        "dt_bias": torch.log(torch.expm1(torch.full((H,), 0.01, **f32))),
        "norm_scale": torch.ones(din, **f32),
        "out_proj": dense_init(gen, (din, D), device),
    }


def make_ssm_state(batch, cfg: ModelConfig, dtype=torch.float32,
                   device=None):
    """Empty per-row SSM state: zero recurrent state, conv tail and pos."""
    s = cfg.ssm
    D = cfg.d_model
    H, P, N = s.n_heads(D), s.head_dim, s.d_state
    conv_dim = s.d_inner(D) + 2 * s.n_groups * N
    return {
        "ssm": torch.zeros((batch, H, P, N), dtype=dtype, device=device),
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


# ------------------------------------------------------------- SSD oracle

def ssd_reference(x, dt, A, B, C, initial_state=None):
    """Naive O(L) recurrence: h_t = exp(dt A) h + dt B x; y = C h."""
    b, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Bh = B.float().repeat_interleave(rep, dim=2)
    Ch = C.float().repeat_interleave(rep, dim=2)
    s = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    dtf = dt.float()
    ys = []
    for t in range(L):
        dec = torch.exp(dtf[:, t] * A)                          # (b, H)
        s = s * dec[:, :, None, None] + torch.einsum(
            "bhn,bh,bhp->bhpn", Bh[:, t], dtf[:, t], x[:, t].float())
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], s))
    return torch.stack(ys, dim=1).to(x.dtype), s


# ------------------------------------------------------------ mixer apply

def _causal_conv(xbc, w, bias):
    """Depthwise causal conv along time. xbc: (B, L, C), w: (K, C)."""
    K = w.shape[0]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = sum(pad[:, i: i + xbc.shape[1], :] * w[i] for i in range(K))
    return out + bias


def _split_in_proj(z_xbc_dt, cfg: ModelConfig):
    s = cfg.ssm
    D = cfg.d_model
    din = s.d_inner(D)
    GN = s.n_groups * s.d_state
    H = s.n_heads(D)
    z = z_xbc_dt[..., :din]
    xbc = z_xbc_dt[..., din: 2 * din + 2 * GN]
    dt = z_xbc_dt[..., 2 * din + 2 * GN:]
    assert dt.shape[-1] == H
    return z, xbc, dt


def _gated_rmsnorm(y, z, scale, eps):
    dt_ = y.dtype
    y = y.float() * F.silu(z.float())
    ms = (y * y).mean(dim=-1, keepdim=True)
    return (y * torch.rsqrt(ms + eps) * scale).to(dt_)


def ssm_mixer(p, cfg: ModelConfig, x, state=None, slot_idx=None, write=True,
              token_mask=None):
    """Full-sequence SSD mixer, with or without a carried state.

    x: (B, L, d_model). Returns (out, state or None).

    state: None (self-contained), a plain batch state (make_ssm_state of B
    rows) or, with slot_idx (B,), a resident slot pool whose row
    slot_idx[b] row b of x advances. The scan reads and (with `write`)
    writes the recurrent state of those rows in place; the conv tail and
    pos are gathered here and, with `write`, written back in place (the
    returned state is the argument). write=False scores without
    committing anything (returns None).

    token_mask: (B, L) bool — real tokens True, a suffix of shape padding
    False (chunked prefill's pad-and-mask final chunk). Masked tokens get
    dt = 0, so the recurrence passes the state through them unchanged
    (exp(0) decay, zero input); the carried conv history is taken at each
    row's real-token count, so it holds the last real tokens.
    """
    s = cfg.ssm
    D = cfg.d_model
    din, H, P = s.d_inner(D), s.n_heads(D), s.head_dim
    G, N = s.n_groups, s.d_state
    B_, L, _ = x.shape

    if state is None:
        st = None
    elif slot_idx is None:
        st = state
    else:
        # the scan reads the recurrent state through slot_idx itself
        idx = slot_idx.long()
        st = {f: state[f].index_select(0, idx) for f in ("conv", "pos")}
    if token_mask is not None:
        assert st is not None, "token_mask requires a carried state"

    # JAX's promotion: a bf16 x f32 product is f32, so is everything after
    z, xbc, dt = _split_in_proj(qdot(x, p["in_proj"]), cfg)
    new_conv = None
    if st is not None:
        # prepend the conv history
        hist = st["conv"].to(xbc.dtype)
        xbc_ext = torch.cat([hist, xbc], dim=1)
        conv_out = _causal_conv(xbc_ext, p["conv_w"],
                                p["conv_b"])[:, hist.shape[1]:]
        if token_mask is None or s.d_conv <= 1:
            new_conv = xbc_ext[:, -(s.d_conv - 1):, :] if s.d_conv > 1 \
                else hist
        else:
            # the last d_conv-1 real rows: real tokens are a prefix, so
            # row b's window ends at hist_len + n_valid[b] in xbc_ext
            n_valid = token_mask.sum(-1).long()                  # (B,)
            idx = n_valid[:, None] + torch.arange(
                s.d_conv - 1, device=x.device)                   # (B, K-1)
            new_conv = torch.gather(
                xbc_ext, 1, idx[:, :, None].expand(-1, -1, xbc_ext.shape[2]))
    else:
        conv_out = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xbc = F.silu(conv_out)

    xs = xbc[..., :din].reshape(B_, L, H, P)
    Bmat = xbc[..., din: din + G * N].reshape(B_, L, G, N)
    Cmat = xbc[..., din + G * N:].reshape(B_, L, G, N)
    dt = F.softplus(dt.float() + p["dt_bias"])
    if token_mask is not None:
        # dt = 0 makes a masked token a no-op in the recurrence: decay
        # exp(0 * A) = 1 and input weight dt * B x = 0
        dt = torch.where(token_mask[:, :, None], dt, torch.zeros_like(dt))
    A = -torch.exp(p["A_log"])

    y = ssd_ops.ssd_slots(xs, dt, A, Bmat, Cmat, s.chunk_size,
                          None if state is None else state["ssm"],
                          slot_idx, write=write)
    y = y + p["D_skip"][:, None] * xs
    y = y.reshape(B_, L, din)
    y = _gated_rmsnorm(y, z, p["norm_scale"], cfg.norm_eps)
    out = qdot(y, p["out_proj"])

    if state is None or not write:
        return out, None
    adv = L if token_mask is None else token_mask.sum(-1).to(torch.int32)
    new = {"conv": new_conv, "pos": st["pos"] + adv}
    for f, v in new.items():
        dst = state[f]
        if slot_idx is None:
            dst.copy_(v)
        else:
            dst[slot_idx.long()] = v.to(dst.dtype)
    return out, state
