"""Plain reference of the Qwen1.5-MoE / Qwen2-MoE decoder.

The dense reference (`dense.py`) with every layer's FFN a mixture of
experts, as published for Qwen1.5-MoE-A2.7B: a router (a d x E product)
whose softmax, taken in float32, picks each token's `num_experts_per_tok`
experts; each routed expert a SwiGLU of width `moe_intermediate_size`;
a shared expert, a SwiGLU of width `shared_expert_intermediate_size`,
that every token passes through.

Two departures of the serving program's semantics from the published
model, which this reference follows, since it judges the program's
tokens:

* the top-k routing weights are renormalised to sum to 1 (the published
  config sets `norm_topk_prob: false`, which leaves them as softmax
  probabilities);
* the shared expert's output is added as it is; the published model
  scales it by sigmoid(x . w_gate), a learned scalar gate per token,
  which the program has no parameter for.

A token's k weighted expert outputs are summed in float32 in the order
of its top-k ranking, and the sum is cast to the activation type before
the shared expert's float32 output is added (the program's rounding
points). Experts run one at a time over the tokens routed to them, so a
whole sequence fits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import dense


def ffn_specs(cfg: dict, prefix: tuple) -> list:
    """(path, shape, init) of one MoE FFN: router, the routed experts'
    stacked gate, up and down weights, the shared expert."""
    d, E, f = (cfg["hidden_size"], cfg["num_experts"],
               cfg["moe_intermediate_size"])
    return [(prefix + ("router",), (d, E), "router"),
            (prefix + ("w_gate",), (E, d, f), "dense"),
            (prefix + ("w_up",), (E, d, f), "dense"),
            (prefix + ("w_down",), (E, f, d), "dense"),
            *dense.mlp_specs(d, cfg["shared_expert_intermediate_size"],
                             prefix + ("shared",))]


def param_specs(cfg: dict) -> list:
    """Every parameter, in the program's layout (see `dense.param_specs`)."""
    return dense.param_specs(cfg, ffn_specs)


def moe_ffn(p, h, cfg, num):
    """The MoE FFN over h (T, d) in the activation type; returns (T, d)
    float32."""
    T = h.shape[0]
    k = cfg["num_experts_per_tok"]
    probs = torch.softmax(dense.mm(h, p["router"], num), dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)                      # (T, k)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    y = torch.zeros((T, k, h.shape[1]), dtype=torch.float32, device=h.device)
    for e in torch.unique(idx).tolist():
        tok, slot = (idx == e).nonzero(as_tuple=True)
        xe = h[tok]
        he = F.silu(dense.mm(xe, p["w_gate"][e], num)) * dense.mm(
            xe, p["w_up"][e], num)
        y[tok, slot] = dense.mm(he, p["w_down"][e], num) * w[tok, slot,
                                                                 None]
    routed = num.act(y.sum(dim=1))
    return routed + dense.mlp(p["shared"], h, num)


def forward(cfg, params, tokens, out_positions, *, positions=None,
            allowed=None, control=None):
    """Logits at `out_positions` (see `dense.forward`)."""
    return dense.forward(cfg, params, tokens, out_positions,
                         positions=positions, allowed=allowed,
                         control=control, ffn=moe_ffn)
