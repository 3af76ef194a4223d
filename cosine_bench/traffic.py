"""The one traffic generator: it reads a mix's parameters
(`traffic/<name>.json`) and makes its requests from the run's seed, with
numpy alone.

Every mix is a closed loop: `clients` clients, each sending its next
request as soon as its last one completes. A mix fixes the set of
request sizes, and the seed only orders it: the prompt and output
lengths are stratified quantiles of their lognormal (median, sigma),
clipped to [min, max], paired and put in an order by permutations of
fixed seed, so every seed serves the same multiset of (prompt, output)
pairs. The seed shuffles the pairs within consecutive blocks of
`clients`, so that the requests in flight at any time are the same sizes
whatever the seed, and draws the token ids (uniform over the vocabulary)
and the order of the domain labels (a Zipf(s) split of the requests over
the drafters' domains, fixed counts).

The clients start out of phase, as in a loop that has run for a while:
the first block holds the request each client is in the middle of. Of
such a request, with output length L, the client still waits for
r = max(1, round(L (k + 1/2) / clients)) tokens, k = 0 .. clients - 1
(the residual life of an output length, stratified); its prompt carries
the L - r tokens served before, so its context is as long as it would be
at that point. Which client joins at which phase is part of the fixed
pairing; the seed orders the block as any other.

Parameters:

  clients    concurrent clients of the closed loop
  requests   how many requests the plan holds (clients cycle over it)
  prompt     {"median", "sigma", "min", "max"} prompt tokens, lognormal
  output     {"median", "sigma", "min", "max"} new tokens, lognormal
  domains    {"zipf": s}: labels over the configuration's drafters

A mix may carry keys that say where its numbers come from ("source")
and what it cuts from its source ("reduced"); the generator reads none
of them.

The plans copy the idea of the reference benchmark's generators
(`launch/serve.py::make_arrivals`, `benchmarks/traffic.py`), whose
rates are fixed in simulated milliseconds; here the loop is closed and
paced by the program itself.
"""
from __future__ import annotations

import json
import statistics
from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np

HERE = Path(__file__).resolve().parent

#: seed of the fixed pairing of prompt with output lengths, of the fixed
#: order of the pairs and of the first block's phases
PAIRING_SEED = 20240601


@dataclass
class RequestSpec:
    prompt: np.ndarray          # (P,) int32 token ids
    max_new: int
    domain: str


@dataclass
class Plan:
    requests: List[RequestSpec]
    clients: int


def load(name: str, root: Path = HERE / "traffic") -> dict:
    """The parameters of the mix `name` (`traffic/<name>.json`)."""
    return json.loads((Path(root) / f"{name}.json").read_text())


def lengths(spec: dict, n: int) -> np.ndarray:
    """n stratified lognormal lengths (ascending), clipped to [min, max]."""
    nd = statistics.NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    x = spec["median"] * np.exp(spec["sigma"] * z)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def zipf_counts(n: int, k: int, s: float) -> np.ndarray:
    """n labels over k classes in proportion 1 / rank^s (largest
    remainders round)."""
    w = 1.0 / np.arange(1, k + 1) ** s
    exact = n * w / w.sum()
    counts = np.floor(exact).astype(np.int64)
    order = np.argsort(-(exact - counts), kind="stable")
    counts[order[: n - counts.sum()]] += 1
    return counts


def generate(mix: dict, seed: int, vocab: int, domains: List[str]) -> Plan:
    """The plan of `mix` for `seed`: the same sizes for every seed, in a
    seed's order, with a seed's token ids."""
    n, k = int(mix["requests"]), int(mix["clients"])
    fixed = np.random.default_rng(PAIRING_SEED)
    p_len = lengths(mix["prompt"], n)
    o_len = lengths(mix["output"], n)[fixed.permutation(n)]
    base = fixed.permutation(n)
    # the first block: each client joins its request at a phase
    head = base[:k]
    phase = (fixed.permutation(k) + 0.5) / k
    left = np.maximum(1, np.rint(o_len[head] * phase)).astype(np.int64)
    p_len, o_len = p_len.copy(), o_len.copy()
    p_len[head] += o_len[head] - left
    o_len[head] = left
    counts = zipf_counts(n, len(domains), float(mix["domains"]["zipf"]))
    labels = np.repeat(np.arange(len(domains)), counts)
    rng = np.random.default_rng([int(seed) & (2 ** 64 - 1), 7])
    order = np.concatenate([rng.permutation(base[i: i + k])
                            for i in range(0, n, k)])
    labels = labels[rng.permutation(n)]
    reqs = [RequestSpec(
        prompt=rng.integers(0, vocab, int(p_len[i]), dtype=np.int64
                            ).astype(np.int32),
        max_new=int(o_len[i]), domain=domains[int(labels[j])])
        for j, i in enumerate(order)]
    return Plan(reqs, clients=k)
