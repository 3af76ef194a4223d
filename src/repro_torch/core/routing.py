"""Adaptive request routing (paper §4.2, Eq. (1)–(3)).

Each request r keeps a routing vector M_r over drafters. After every
verification, the router folds in (a) the drafter's generation confidence
c_{n,i} and (b) the verification-aligned accuracy d_{n,i} (Eq. 1: cosine
similarity between target-embedding of the accepted token and of the
drafter's token, zero beyond the acceptance length), combined by the
normalized harmonic mean (Eq. 2) and EMA-smoothed. Routing (Eq. 3) mixes
top-score selection T(.) with random selection R(.), gated on the recent
acceptance length vs. threshold tau.

Evidence is participants-only: `update` folds in rows for the drafters
that actually drafted the request. Under route-faithful sub-batched
drafting (DESIGN.md §2.4) non-participant rows of the proposal matrices
hold no live tokens at all, so this is load-bearing, not just a
preference (property-tested in tests/test_subbatch.py). The routes this
class emits are likewise real content now — each selected node decodes
the request in its own sub-batch — so `node_lag`'s down-weighting and
the scheduler's hot-node trim act on true per-node occupancy.

Note (DESIGN.md): the paper states alpha > beta for exploration, which
would make exploration *more* greedy than exploitation; we implement the
evidently-intended semantics (exploration mode uses a lower top-scoring
fraction alpha < beta).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from repro_torch.config import CoSineConfig


def cosine_sim(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    num = (a * b).sum(-1)
    den = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1)
    return num / np.maximum(den, 1e-9)


def verification_accuracy(embed: np.ndarray, drafter_tokens: np.ndarray,
                          accepted_tokens: Sequence[int]) -> np.ndarray:
    """Eq. (1). drafter_tokens: (K,) one drafter's proposals;
    accepted_tokens: the L_acc tokens the verifier committed.
    embed: (V, d) target embedding table (H(.)).
    Returns d (K,) in [0, 1] (cosine clipped at 0)."""
    K = len(drafter_tokens)
    L = min(len(accepted_tokens), K)
    d = np.zeros(K, np.float32)
    if L:
        ha = embed[np.asarray(accepted_tokens[:L], np.int32)]
        hd = embed[np.asarray(drafter_tokens[:L], np.int32)]
        d[:L] = np.clip(cosine_sim(ha, hd), 0.0, 1.0)
    return d


def routing_score(conf: np.ndarray, acc: np.ndarray) -> float:
    """Eq. (2): mean over positions of the normalized harmonic interaction
    c*d / (c*d + (1-c)(1-d)) — in (0, 1)."""
    c = np.clip(conf, 1e-6, 1 - 1e-6)
    d = np.clip(acc, 1e-6, 1 - 1e-6)
    num = c * d
    den = num + (1 - c) * (1 - d)
    return float(np.mean(num / den))


class AdaptiveRouter:
    """Maintains M (requests x drafters) and applies the Eq. (3) policy."""

    def __init__(self, n_drafters: int, cfg: CoSineConfig,
                 embed: np.ndarray, seed: int = 0):
        self.n = n_drafters
        self.cfg = cfg
        self.embed = embed
        self.rng = np.random.default_rng(seed)
        self.scores: Dict[int, np.ndarray] = {}
        # chronic-lateness EMA per drafter *node* (cluster feedback,
        # DESIGN.md §2.4): 0 = always on time, -> 1 = always cut. Both
        # the top-scoring order and the exploration draw of Eq. (3) are
        # down-weighted by it, so straggling nodes stop being selected
        # unless their routing score earns the extra latency.
        self.node_lag = np.zeros(n_drafters, np.float32)

    def vector(self, rid: int) -> np.ndarray:
        if rid not in self.scores:
            self.scores[rid] = np.full(self.n, 0.5, np.float32)
        return self.scores[rid]

    def set_prior(self, rid: int, drafter_logliks: Sequence[float]):
        """Content-based warm start (paper §5's pre-inference request
        analysis): initialize M_r from each drafter's likelihood of the
        prompt, z-scored into (0.2, 0.8)."""
        ll = np.asarray(drafter_logliks, np.float32)
        z = (ll - ll.mean()) / (ll.std() + 1e-6)
        self.scores[rid] = np.clip(0.5 + 0.15 * z, 0.2, 0.8).astype(np.float32)

    def update(self, rid: int, drafter_tokens: np.ndarray,
               drafter_conf: np.ndarray, accepted_tokens: Sequence[int],
               participated: Sequence[int]):
        """drafter_tokens/conf: (N, K) this iteration's proposals."""
        m = self.vector(rid).copy()
        ema = self.cfg.routing_ema
        for nd in participated:
            acc = verification_accuracy(self.embed, drafter_tokens[nd],
                                        accepted_tokens)
            s = routing_score(drafter_conf[nd], acc)
            m[nd] = ema * m[nd] + (1 - ema) * s
        self.scores[rid] = m
        return m

    def note_node_outcome(self, node: int, role: str,
                          ema: float = 0.8):
        """Cluster feedback after each cohort: how late was `node`?
        role: "fused" (on time) | "side" (late, salvaged) | "dropped"."""
        lateness = {"fused": 0.0, "side": 0.5, "dropped": 1.0}[role]
        self.node_lag[node] = ema * self.node_lag[node] \
            + (1.0 - ema) * lateness

    def _effective(self, m: np.ndarray) -> np.ndarray:
        """Routing scores discounted by chronic node lateness."""
        return m * (1.0 - self.cfg.straggler_penalty * self.node_lag)

    def route(self, rid: int, l_acc: float) -> List[int]:
        """Eq. (3): pick `drafters_per_request` drafters; each pick is
        top-scoring with prob coef, random otherwise. Both modes are
        down-weighted by chronic node lateness: the top order uses the
        lag-discounted scores, and the exploration draw is biased away
        from nodes that keep getting cut from cohorts."""
        m_eff = self._effective(self.vector(rid))
        coef = self.cfg.alpha if l_acc < self.cfg.tau else self.cfg.beta
        chosen: List[int] = []
        avail = list(range(self.n))
        order = sorted(avail, key=lambda i: -m_eff[i])
        for _ in range(min(self.cfg.drafters_per_request, self.n)):
            if self.rng.random() < coef:
                pick = next(i for i in order if i not in chosen)
            else:
                rest = [i for i in avail if i not in chosen]
                w = np.clip(1.0 - self.cfg.straggler_penalty
                            * self.node_lag[rest], 1e-3, None)
                pick = int(self.rng.choice(rest, p=w / w.sum()))
            chosen.append(pick)
        return sorted(chosen)

    def drop(self, rid: int):
        self.scores.pop(rid, None)
