"""Synthetic multi-domain corpus generator.

Emulates the paper's five evaluation domains (PIQA physics / MedQA
medicine / FIQA finance / Alpaca instructions / OASST2 conversation) with
structurally distinct token sources: each domain is a random first-order
Markov chain over a disjoint-biased slice of the vocabulary with its own
temperature and loop structure. Drafters fine-tuned on one domain really
do draft that domain better — which is what exercises CoSine's routing
(Fig. 3a / Table 2 analogues are measured, not assumed).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

DOMAINS = ("piqa", "medqa", "fiqa", "alpaca", "oasst2")


@dataclass
class DomainSource:
    name: str
    trans: np.ndarray          # (V, V) row-stochastic transition matrix
    init: np.ndarray           # (V,) initial distribution

    def sample(self, rng: np.random.Generator, length: int) -> np.ndarray:
        out = np.empty(length, np.int32)
        out[0] = rng.choice(len(self.init), p=self.init)
        for i in range(1, length):
            out[i] = rng.choice(len(self.init), p=self.trans[out[i - 1]])
        return out


def _make_domain(name: str, vocab: int, seed: int,
                 sharpness: float = 8.0, support: int = 24) -> DomainSource:
    """Sparse, peaked Markov chain biased to a domain-specific vocab slice."""
    rng = np.random.default_rng(seed)
    k = DOMAINS.index(name) if name in DOMAINS else seed
    lo = (k * vocab // (len(DOMAINS) + 1)) % vocab
    hi = min(lo + max(vocab // 2, 8), vocab)
    trans = np.full((vocab, vocab), 1e-3)
    for v in range(vocab):
        nxt = rng.choice(np.arange(lo, hi), size=min(support, hi - lo),
                         replace=False)
        trans[v, nxt] += rng.dirichlet(np.ones(len(nxt))) * sharpness
    trans /= trans.sum(1, keepdims=True)
    init = np.zeros(vocab)
    init[lo:hi] = 1.0 / (hi - lo)
    return DomainSource(name, trans, init)


class SyntheticCorpus:
    def __init__(self, vocab: int, seed: int = 0,
                 domains: Sequence[str] = DOMAINS,
                 sharpness: float = 8.0, support: int = 24):
        self.vocab = vocab
        self.domains: Dict[str, DomainSource] = {
            d: _make_domain(d, vocab, seed * 31 + i, sharpness, support)
            for i, d in enumerate(domains)
        }
        self.rng = np.random.default_rng(seed)

    def sample(self, domain: str, length: int) -> np.ndarray:
        return self.domains[domain].sample(self.rng, length)

    def batch(self, domain: str, batch: int, length: int) -> np.ndarray:
        return np.stack([self.sample(domain, length) for _ in range(batch)])

    def mixed_batch(self, batch: int, length: int,
                    proportions: Optional[Dict[str, float]] = None):
        """Mixture batch + per-row domain labels (training the target)."""
        names = list(self.domains)
        p = (np.array([proportions[n] for n in names])
             if proportions else np.ones(len(names)) / len(names))
        p = p / p.sum()
        labels = [names[self.rng.choice(len(names), p=p)] for _ in range(batch)]
        rows = np.stack([self.sample(d, length) for d in labels])
        return rows, labels

    def prompts(self, n: int, length: int, seed: int = 0):
        """Evenly-mixed evaluation prompts with domain labels (paper §6.1:
        8192 prompts sampled across the five datasets).

        A pure function of (n, length, seed): sampling uses the local
        generator, NOT the corpus training stream (`self.rng`), so
        callers get identical prompts regardless of what ran before —
        the CI bench-regression gate relies on this (benchmark rows must
        not depend on run order)."""
        rng = np.random.default_rng(seed)
        names = list(self.domains)
        out = []
        for i in range(n):
            d = names[i % len(names)]
            out.append((self.domains[d].sample(rng, length), d))
        rng.shuffle(out)
        return out


def token_batches(corpus: SyntheticCorpus, domain: Optional[str],
                  batch: int, length: int, steps: int):
    """Iterator of (batch, length+1) training batches (inputs+shift labels)."""
    for _ in range(steps):
        if domain is None:
            rows, _ = corpus.mixed_batch(batch, length + 1)
        else:
            rows = corpus.batch(domain, batch, length + 1)
        yield rows
