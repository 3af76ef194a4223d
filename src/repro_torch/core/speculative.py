"""Speculative verification: distribution-preserving rejection sampling
(Leviathan et al., the paper's §2.1 acceptance mechanism) plus the greedy
variant used for the paper's experiments (§6.1: greedy sampling for both
draft generation and verification). Port of `repro.core.speculative` on
torch tensors.

Alignment convention: `target_logits[:, i]` is the target distribution for
draft token i, i.e. conditioned on everything *before* it (the engine
assembles this from the previous step's tail logits + the verify pass);
`bonus_logits` is the distribution after the last draft token.

All functions are vectorized over the batch with fixed shapes
(acceptance counts are data, not shapes). Randomness comes from an
explicit `torch.Generator` (the reference takes a JAX key): the same
seed gives other draws than JAX, so the two are compared in
distribution, or on inputs that leave no choice.
"""
from __future__ import annotations

from typing import Optional

import torch


def accept_counts_greedy(draft_tokens, target_argmax):
    """Greedy acceptance: token i is accepted iff every token <= i matches
    the target argmax. draft_tokens, target_argmax: (B, G) -> (B,) counts."""
    match = (draft_tokens == target_argmax)
    return torch.cumprod(match.to(torch.int64), dim=-1).sum(dim=-1)


def _place(draft_tokens, n_acc, fix):
    """(B, G+1): the draft tokens with `fix` written at column n_acc."""
    B = draft_tokens.shape[0]
    out = torch.cat([draft_tokens, draft_tokens.new_zeros((B, 1))], dim=1)
    out[torch.arange(B, device=out.device), n_acc] = fix.to(out.dtype)
    return out


def verify_greedy(draft_tokens, target_logits, bonus_logits):
    """Greedy speculative verification.

    draft_tokens: (B, G); target_logits: (B, G, V); bonus_logits: (B, V).
    Returns:
      out_tokens (B, G+1): accepted prefix + 1 correction/bonus token
      n_out (B,): number of valid tokens (n_accepted + 1)
    Matches incremental greedy decoding exactly (losslessness invariant).
    """
    G = draft_tokens.shape[1]
    full = torch.cat([target_logits, bonus_logits[:, None]], dim=1)
    tgt = torch.argmax(full, dim=-1)                            # (B, G+1)
    n_acc = accept_counts_greedy(draft_tokens, tgt[:, :G])      # (B,)
    fix = torch.gather(tgt, 1, n_acc[:, None])[:, 0]
    return _place(draft_tokens, n_acc, fix), n_acc + 1


def verify_rejection(generator: Optional[torch.Generator], draft_tokens,
                     draft_logprobs, target_logits, bonus_logits,
                     temperature: float = 1.0):
    """Stochastic rejection-sampling verification (lossless in
    distribution).

    generator:      the `torch.Generator` the draws come from (None: the
                    default generator of the logits' device)
    draft_tokens:   (B, G) tokens sampled from the drafter(s)
    draft_logprobs: (B, G, V) drafter log-distributions at each position
    target_logits:  (B, G, V); bonus_logits: (B, V)
    Accept token i with prob min(1, p(x)/q(x)); at the first rejection
    resample from norm(max(0, p - q)); if all accepted, sample the bonus
    token from the target's post-draft distribution.

    Returns (out_tokens (B, G+1), n_out (B,)).
    """
    B, G, V = target_logits.shape
    p = torch.softmax(target_logits.float() / temperature, -1)
    q = torch.exp(draft_logprobs.float())

    idx = draft_tokens.long()[..., None]
    p_tok = torch.gather(p, -1, idx)[..., 0]                    # (B, G)
    q_tok = torch.gather(q, -1, idx)[..., 0]
    u = torch.rand((B, G), generator=generator, device=p.device)
    accept = u < torch.clamp(p_tok / torch.clamp(q_tok, min=1e-20), max=1.0)
    n_acc = torch.cumprod(accept.to(torch.int64), -1).sum(-1)   # (B,)

    # residual distribution at the first rejected position
    at = torch.clamp(n_acc, max=G - 1)[:, None, None].expand(B, 1, V)
    resid = torch.clamp(torch.gather(p, 1, at)[:, 0]
                        - torch.gather(q, 1, at)[:, 0], min=0.0)
    # all-accepted rows instead sample the bonus token from the target
    p_bonus = torch.softmax(bonus_logits.float() / temperature, -1)
    resid = torch.where((n_acc == G)[:, None], p_bonus, resid)
    resid = resid / torch.clamp(resid.sum(-1, keepdim=True), min=1e-20)
    fix = torch.multinomial(resid, 1, generator=generator)[:, 0]
    return _place(draft_tokens, n_acc, fix), n_acc + 1


def sample_from_logits(generator: Optional[torch.Generator], logits,
                       temperature: float = 0.0):
    """Greedy (temperature 0) or categorical sampling. logits: (..., V)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, -1)
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=generator).reshape(
        probs.shape[:-1])
