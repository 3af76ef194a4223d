"""Training loop (port of `repro.launch.train`): drafter domain
fine-tuning and target pretraining on the synthetic multi-domain corpus.

A step differentiates `models.model.lm_loss`; on CUDA every attention
forward runs on the hand-written flash-attention kernel, with its
gradient from `kernels.flash_attention.ops.attention_grad`, and every
SSD scan on the SSD scan kernel, with its gradient from
`kernels.ssd_scan.ops.ssd_grad`.

Usage (runs on CUDA unless `--device cpu`):
  PYTHONPATH=src python -m repro_torch.launch.train --steps 200 --device cpu
"""
from __future__ import annotations

import argparse
from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.data.synthetic import SyntheticCorpus, token_batches
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.optim.optimizers import (Optimizer, apply_updates,
                                          get_optimizer, tree_leaves,
                                          tree_map)


def value_and_grad(params, cfg: ModelConfig, tokens, frontend=None,
                   remat: bool = True):
    """(loss, {"lm", "aux"}, grads) of `lm_loss` at `params`: the
    reference's `jax.value_and_grad(lm_loss, has_aux=True)`. The leaves
    require gradients for the call only; `grads` is a tree like `params`
    (zeros for a leaf the loss does not reach)."""
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    try:
        loss, parts = M.lm_loss(params, cfg, tokens, frontend=frontend,
                                remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for t in leaves:
            t.requires_grad_(False)
    it = iter(g if g is not None else torch.zeros_like(p)
              for g, p in zip(grads, leaves))
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            tree_map(lambda _: next(it), params))


def make_train_step(cfg: ModelConfig, opt: Optimizer, remat: bool = True):
    """Returns train_step(params, opt_state, tokens[, frontend]) ->
    (params, opt_state, metrics): one `value_and_grad` and one optimizer
    update, applied to `params` in place."""

    def train_step(params, opt_state, tokens, frontend=None):
        loss, parts, grads = value_and_grad(params, cfg, tokens, frontend,
                                            remat)
        updates, opt_state = opt.update(grads, opt_state, params)
        apply_updates(params, updates)
        return params, opt_state, {"loss": loss, **parts}

    return train_step


def train_model(cfg: ModelConfig, corpus: SyntheticCorpus,
                domain: Optional[str], steps: int, batch: int = 8,
                seq: int = 64, lr: float = 3e-3, seed: int = 0,
                optimizer: str = "adamw", params=None, log_every: int = 50,
                verbose: bool = True, device=None):
    """Train (or fine-tune, if params are given: a copy of them) on one
    domain or the mixture; returns (params, losses). The parameters
    require gradients only inside a step (`value_and_grad`), so they come
    back ready to serve. Runs on CUDA unless device="cpu"."""
    dev = resolve_device(device)
    if params is None:
        params = M.init_params(cfg, seed=seed, device=dev)
    else:
        params = tree_map(lambda t: t.detach().to(dev, copy=True), params)
    opt = get_optimizer(optimizer, lr)
    opt_state = opt.init(params)
    step_fn = make_train_step(cfg, opt, remat=False)

    losses = []
    for i, rows in enumerate(token_batches(corpus, domain, batch, seq,
                                           steps)):
        params, opt_state, metrics = step_fn(
            params, opt_state, torch.as_tensor(rows, device=dev))
        losses.append(float(metrics["loss"]))
        if verbose and (i % log_every == 0 or i == steps - 1):
            print(f"  [{cfg.name}|{domain or 'mixture'}] step {i:4d} "
                  f"loss {losses[-1]:.4f}")
    return params, losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--vocab", type=int, default=256)
    ap.add_argument("--domain", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args()

    from repro_torch.configs.drafters import tiny_target
    cfg = tiny_target(args.vocab)
    corpus = SyntheticCorpus(args.vocab)
    params, losses = train_model(cfg, corpus, args.domain, args.steps,
                                 args.batch, args.seq, device=args.device)
    print(f"final loss: {losses[-1]:.4f} (start {losses[0]:.4f})")


if __name__ == "__main__":
    main()
