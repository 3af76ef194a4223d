"""Serving launcher (port of `repro.launch.serve`): bring up a CoSine
deployment from checkpoints (or freshly trained tiny models) and serve a
synthetic request stream.

  PYTHONPATH=src python -m repro_torch.launch.serve --strategy cosine \
      --requests 8 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --ckpt-dir checkpoints \
      --strategy cosine --mode volatile

Runs on CUDA unless `--device cpu`. Checkpoints are the reference's
msgpack files (`checkpoint/store.py`: `target.msgpack` and
`drafter_<domain>.msgpack`), written by either package.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from repro_torch.checkpoint.store import load_checkpoint
from repro_torch.config import CoSineConfig
from repro_torch.configs.drafters import tiny_drafter, tiny_target
from repro_torch.data.synthetic import DOMAINS, SyntheticCorpus
from repro_torch.serving.engine import STRATEGIES, SpeculativeEngine

VOCAB = 96


def make_arrivals(mode: str, n: int, seed: int = 0):
    """Arrival timestamps (ms): Poisson gaps at a low or a high rate, or
    (volatile) alternating bursts and lulls (a copy of the reference
    benchmark's `make_arrivals`)."""
    rng = np.random.default_rng(seed)
    if mode == "low":
        gaps = rng.exponential(400.0, n)
    elif mode == "high":
        gaps = rng.exponential(120.0, n)
    else:  # volatile: alternating bursts and lulls
        gaps = np.concatenate([
            rng.exponential(60.0, n // 2), rng.exponential(500.0, n - n // 2)])
        rng.shuffle(gaps)
    return np.cumsum(gaps)


def build_models(ckpt_dir, corpus, steps, device=None):
    """(target, drafters) for the engine: the tiny target and one tiny
    drafter a domain, read from `ckpt_dir` when it holds
    `target.msgpack`, else trained inline (the target on the mixture for
    2 x `steps`, each drafter on its domain for `steps`)."""
    from repro_torch.launch.train import train_model
    tcfg, dcfg = tiny_target(VOCAB), tiny_drafter(VOCAB)
    if ckpt_dir and os.path.exists(os.path.join(ckpt_dir, "target.msgpack")):
        tparams, _ = load_checkpoint(os.path.join(ckpt_dir, "target.msgpack"),
                                     tcfg, device)
        drafters = []
        for dom in DOMAINS:
            dp, _ = load_checkpoint(
                os.path.join(ckpt_dir, f"drafter_{dom}.msgpack"), dcfg,
                device)
            drafters.append((dcfg, dp, dom))
        return (tcfg, tparams), drafters
    print("(no checkpoints found — training tiny models inline)")
    tparams, _ = train_model(tcfg, corpus, None, steps * 2, batch=16, seq=64,
                             verbose=False, device=device)
    drafters = []
    for i, dom in enumerate(DOMAINS):
        dp, _ = train_model(dcfg, corpus, dom, steps, batch=16, seq=64,
                            seed=i + 1, verbose=False, device=device)
        drafters.append((dcfg, dp, dom))
    return (tcfg, tparams), drafters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--strategy", choices=STRATEGIES, default="cosine")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--mode", choices=["offline", "low", "high", "volatile"],
                    default="offline")
    ap.add_argument("--ckpt-dir", type=str, default="checkpoints")
    ap.add_argument("--train-steps", type=int, default=150)
    ap.add_argument("--draft-len", type=int, default=5)
    ap.add_argument("--drafters-per-request", type=int, default=2)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args()

    corpus = SyntheticCorpus(VOCAB, seed=0, sharpness=120.0, support=5)
    target, drafters = build_models(args.ckpt_dir, corpus, args.train_steps,
                                    device=args.device)
    cos = CoSineConfig(n_drafters=len(drafters), draft_len=args.draft_len,
                       drafters_per_request=args.drafters_per_request,
                       tree_width=2)
    eng = SpeculativeEngine(target, drafters, cos, strategy=args.strategy,
                            max_len=512, device=args.device)

    if args.mode == "offline":
        arrivals = np.zeros(args.requests)
    else:
        arrivals = make_arrivals(args.mode, args.requests, seed=5)

    for (p, dom), t in zip(corpus.prompts(args.requests, 16, seed=13),
                           arrivals):
        eng.submit(p, max_new_tokens=args.max_new, domain=dom,
                   arrival_ms=float(t))
    stats = eng.run()
    lat = [(r.finish_ms - r.arrival_ms) / max(len(r.generated), 1)
           for r in eng.pool.completed]
    print(f"strategy={args.strategy} requests={len(eng.pool.completed)} "
          f"tokens={stats.total_committed}")
    print(f"  throughput {stats.throughput_tps:.1f} tok/s | "
          f"latency {np.mean(lat):.1f} ms/tok (p95 {np.percentile(lat, 95):.1f}) | "
          f"acceptance {stats.mean_acceptance:.2f} tokens/iteration")


if __name__ == "__main__":
    main()
