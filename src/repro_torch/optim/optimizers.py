"""Optimizers over the port's parameter trees (port of
`repro.optim.optimizers`): AdamW, SGD with momentum, Adafactor.

A tree is nested dicts, lists and tuples with tensor leaves (the port's
params hold a `layers` list). Each optimizer is an `Optimizer(init,
update)` pair with the reference's arithmetic: `update(grads, state,
params)` returns (updates, new state) and `apply_updates` adds the
updates to the parameters in place. Not `torch.optim`: its AdamW applies
the weight decay to the parameter before the step, where the reference
adds it to the step, and its Adafactor is another algorithm.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


def tree_map(fn, tree, *rest, is_leaf=None):
    """`fn` over the leaves of `tree` (and the same positions of `rest`),
    rebuilding its dicts, lists and tuples; `is_leaf(x)` stops the walk
    at x."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of `tree` in `tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


class Optimizer(NamedTuple):
    """`init(params) -> state`; `update(grads, state, params) ->
    (updates, state)`."""
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]


@torch.no_grad()
def apply_updates(params, updates):
    """params += updates, in place, each leaf kept in its dtype (the
    reference's `(p + u).astype(p.dtype)`); returns params."""
    tree_map(lambda p, u: p.add_(u), params, updates)
    return params


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def sgd(lr: float = 1e-2, momentum: float = 0.9) -> Optimizer:
    """SGD with (heavy-ball) momentum."""
    def init(params):
        return tree_map(torch.zeros_like, params) if momentum else None

    def update(grads, state, params=None):
        if momentum:
            state = tree_map(lambda m, g: momentum * m + g, state, grads)
            upd = tree_map(lambda m: -lr * m, state)
        else:
            upd = tree_map(lambda g: -lr * g, grads)
        return upd, state

    return Optimizer(init, update)


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.01) -> Optimizer:
    """Adam with decoupled weight decay added to the step, f32 moments
    and an int32 step count, as the reference."""
    def init(params):
        def zeros():
            return tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        dev = tree_leaves(params)[0].device
        return {"m": zeros(), "v": zeros(),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params):
        t = state["t"] + 1
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * g.float().square(),
                     state["v"], grads)
        tf = t.float()
        bc1 = 1 - _f32(b1).to(tf.device) ** tf
        bc2 = 1 - _f32(b2).to(tf.device) ** tf

        def u(m, v, p):
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            return -lr * (step + weight_decay * p.float())

        return tree_map(u, m, v, params), {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def adafactor(lr: float = 1e-2, eps: float = 1e-30, decay: float = 0.8,
              clip_threshold: float = 1.0) -> Optimizer:
    """Factored second-moment optimizer (Shazeer & Stern): a matrix's
    second moment kept as row and column means."""
    def is_factored(p):
        return p.dim() >= 2 and p.shape[-1] >= 8 and p.shape[-2] >= 8

    def init(params):
        def one(p):
            if is_factored(p):
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}
        dev = tree_leaves(params)[0].device
        return {"s": tree_map(one, params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def _state_leaf(x):
        return isinstance(x, dict) and ("v" in x or "vr" in x)

    def update(grads, state, params):
        t = state["t"] + 1
        beta = 1.0 - (t.float() + 1.0) ** -decay

        def one(s, g):
            g = g.float()
            g2 = g.square() + eps
            if "vr" in s:
                vr = beta * s["vr"] + (1 - beta) * g2.mean(-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(-2)
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(vr.mean(-1)[..., None, None],
                                       min=eps))
                upd = g * torch.rsqrt(denom + eps)
                ns = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                upd = g * torch.rsqrt(v + eps)
                ns = {"v": v}
            rms = torch.sqrt(upd.square().mean() + eps)
            upd = upd / torch.clamp(rms / clip_threshold, min=1.0)
            return {"__u": -lr * upd, "__s": ns}

        pairs = tree_map(one, state["s"], grads, is_leaf=_state_leaf)
        is_pair = lambda x: isinstance(x, dict) and "__u" in x
        upd = tree_map(lambda pr: pr["__u"], pairs, is_leaf=is_pair)
        news = tree_map(lambda pr: pr["__s"], pairs, is_leaf=is_pair)
        return upd, {"s": news, "t": t}

    return Optimizer(init, update)


def get_optimizer(name: str, lr: float) -> Optimizer:
    """"adamw", "sgd" or "adafactor" at learning rate `lr`."""
    if name == "adamw":
        return adamw(lr)
    if name == "sgd":
        return sgd(lr)
    if name == "adafactor":
        return adafactor(lr)
    raise KeyError(name)
