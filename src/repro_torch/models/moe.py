"""Mixture-of-experts FFN: shared + routed top-k experts (port of
`repro.models.moe`).

The reference's algorithm, on tensors: the token copies are sorted by
expert (stable), each expert's contiguous group runs through its own
gate, up and down products (the reference's `lax.ragged_dot`, an XLA
grouped matmul; no Pallas kernel, so no hand-written one is owed), and
the weighted copies are summed back to their tokens. Exact: no token is
dropped, so serving stays lossless.

Two choices differ from the reference on purpose:

* The per-expert loop needs the group sizes on the host: one small
  device-to-host copy per MoE layer (`group_sizes_host`) on the current
  stream, never a device-wide synchronize. Empty groups launch nothing.
* A token's k weighted copies are un-permuted to (N, k, d) and summed
  over k in f32, then cast once to the activation dtype. The reference
  scatter-adds them (`.at[].add`) into a zero array of the activation
  dtype, which on CUDA would be atomics in no fixed order; with bf16
  activations it also rounds each copy to bf16 before adding (ROADMAP
  queue 3). At f32 the two agree to summation order.

Products promote bf16 x f32 to f32 explicitly (`quantize.qdot`), as
JAX's `ragged_dot` does. The router stays plain on int8 drafters
(`quantize.quantize_params` leaves the whole MoE FFN alone).

`dense_moe_reference` is the reference's O(N * E) oracle, for tests;
nothing on the serving path calls it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, MoEConfig
from repro_torch.models.layers import apply_mlp, dense_init, mlp_params
from repro_torch.models.quantize import qdot
from repro_torch.obs.wall import note_host_read


def moe_params(gen: torch.Generator, cfg: ModelConfig, moe: MoEConfig,
               device):
    """Router, stacked routed experts and the optional shared expert,
    drawn from `gen` (f32; the reference's shapes and scales: the routed
    stacks' fan-in is their leading E axis, as `dense_init` reads it)."""
    d, E, f = cfg.d_model, moe.n_routed, moe.d_ff
    p = {
        "router": dense_init(gen, (d, E), device, scale=0.02),
        "w_gate": dense_init(gen, (E, d, f), device),
        "w_up": dense_init(gen, (E, d, f), device),
        "w_down": dense_init(gen, (E, f, d), device),
    }
    if moe.n_shared:
        p["shared"] = mlp_params(gen, cfg, d, moe.shared_width, device)
    return p


def route_topk(logits, top_k: int):
    """Softmax router with renormalised top-k weights.

    Returns (weights (N, k) f32, idx (N, k) int64, probs (N, E) f32)."""
    probs = torch.softmax(logits.float(), dim=-1)
    w, idx = torch.topk(probs, top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, idx, probs


def group_sizes_host(expert_of_copy, n_experts: int) -> list:
    """Copies routed to each expert, read to the host (the one
    device-to-host copy of a MoE layer, on the current stream)."""
    sizes = torch.bincount(expert_of_copy, minlength=n_experts)
    note_host_read("moe_sizes", sizes.numel() * sizes.element_size())
    return sizes.tolist()


def apply_moe(p, x, cfg: ModelConfig, moe: MoEConfig):
    """x: (..., d). Returns (out (..., d): the routed sum in x's dtype,
    promoted with the shared expert's product as in the reference;
    aux_loss, an f32 scalar)."""
    shape = x.shape
    d = shape[-1]
    flat = x.reshape(-1, d)
    N = flat.shape[0]
    E, k = moe.n_routed, moe.top_k

    w, idx, probs = route_topk(qdot(flat, p["router"]), k)

    # ---- sort the token copies by expert (stable, as the reference) ----
    expert_of_copy = idx.reshape(-1)                       # (N * k,)
    order = torch.argsort(expert_of_copy, stable=True)
    token_of_copy = order // k
    weight_of_copy = w.reshape(-1)[order]
    sizes = group_sizes_host(expert_of_copy, E)

    xs = flat[token_of_copy]                               # (N * k, d)
    parts = []
    start = 0
    for e, n in enumerate(sizes):
        if n == 0:
            continue
        xe = xs[start: start + n]
        h = F.silu(qdot(xe, p["w_gate"][e])) * qdot(xe, p["w_up"][e])
        parts.append(qdot(h, p["w_down"][e]))
        start += n
    y = torch.cat(parts) * weight_of_copy[:, None]         # f32

    # ---- back to the tokens: un-permute, sum each token's k copies ----
    y_copy = torch.empty_like(y)
    y_copy[order] = y
    out = y_copy.view(N, k, d).float().sum(dim=1).to(flat.dtype)

    if moe.n_shared:
        out = out + apply_mlp(p["shared"], flat, cfg)

    # Switch-style load-balance auxiliary loss: E * sum_e f_e * P_e
    frac_tokens = F.one_hot(idx, E).float().sum(1).mean(0)  # (E,)
    mean_prob = probs.mean(0)
    aux = E * torch.sum(frac_tokens / k * mean_prob)

    return out.reshape(shape), aux


def dense_moe_reference(p, x, cfg: ModelConfig, moe: MoEConfig):
    """O(N * E) oracle: every token through every expert, top-k weighted."""
    shape = x.shape
    flat = x.reshape(-1, shape[-1])
    N = flat.shape[0]
    E, k = moe.n_routed, moe.top_k
    w, idx, _ = route_topk(qdot(flat, p["router"]), k)
    wfull = torch.zeros((N, E), dtype=torch.float32, device=x.device)
    wfull.scatter_(1, idx, w)
    xf = flat.float()
    h = F.silu(torch.einsum("nd,edf->nef", xf, p["w_gate"].float()))
    h = h * torch.einsum("nd,edf->nef", xf, p["w_up"].float())
    y = torch.einsum("nef,efd->ned", h, p["w_down"].float())
    out = torch.einsum("ned,ne->nd", y, wfull).to(flat.dtype)
    if moe.n_shared:
        out = out + apply_mlp(p["shared"], flat, cfg)
    return out.reshape(shape)
