"""Online serving on the PyTorch port: a CoSine deployment handling a
Poisson request stream across the synthetic corpus's five domains, with
continuous batching, adaptive routing, token fusion and the Alg. 2
scheduler.

  PYTHONPATH=src python examples/torch_serve_online.py [--requests 12] \
      [--mode volatile] [--backend sim|async] [--device cuda|cpu] \
      [--trace DIR]

`--backend sim` (the default) serves the stream with every strategy on
the simulated clock and prints a comparison table; per-request
completions are printed as tokens commit (the engine's `on_commit`
hook). `--backend async` serves it on the wall-clock `AsyncTorchBackend`
behind an asyncio front-end: the engine loop runs in a thread (on CUDA
the target verifies on a stream of its own while the drafters draft the
next cohort on another), tokens stream into per-request asyncio queues
as they commit, and each request's consumer prints its stream as it
grows.

With --trace [DIR] the cosine run's (or the async run's) telemetry is
exported as DIR/torch_serve_online_<run>.json — a Perfetto-loadable
trace plus a sibling .metrics.json — and can be summarized with

  PYTHONPATH=src python -m repro_torch.obs.summarize DIR/torch_serve_online_cosine.json

Runs on CUDA unless `--device cpu` is given. The port does not train
yet, so the target and the five domain drafters are seeded random
weights (`init_params`, float32) at `tiny_target`/`tiny_drafter` widths.
"""
import argparse
import asyncio
import os

import numpy as np

from repro_torch.config import CoSineConfig
from repro_torch.configs.drafters import tiny_drafter, tiny_target
from repro_torch.data.synthetic import DOMAINS, SyntheticCorpus
from repro_torch.models.model import init_params
from repro_torch.serving.engine import SpeculativeEngine

VOCAB = 96
SHARPNESS = 120.0
SUPPORT = 5


def make_arrivals(mode: str, n: int, seed: int = 0):
    """Arrival timestamps (ms): Poisson gaps at a low or a high rate, or
    (volatile) alternating bursts and lulls."""
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


class Deployment:
    """Seeded target and domain drafters on one device."""

    def __init__(self, device: str):
        self.device = device
        self.corpus = SyntheticCorpus(VOCAB, seed=0, sharpness=SHARPNESS,
                                      support=SUPPORT)
        tcfg = tiny_target(VOCAB).with_overrides(dtype="float32")
        dcfg = tiny_drafter(VOCAB).with_overrides(dtype="float32")
        self.target = (tcfg, init_params(tcfg, 0, device=device))
        self.drafters = [(dcfg, init_params(dcfg, i + 1, device=device), dom)
                         for i, dom in enumerate(DOMAINS)]

    def engine(self, strategy: str, backend=None) -> SpeculativeEngine:
        cos = CoSineConfig(n_drafters=len(self.drafters), draft_len=5,
                           drafters_per_request=2, tree_width=2)
        return SpeculativeEngine(self.target, self.drafters, cos,
                                 strategy=strategy, max_len=512, seed=0,
                                 backend=backend, device=self.device)


def _export(eng, trace_dir: str, run: str) -> None:
    from repro_torch.obs.export import export_engine_trace
    os.makedirs(trace_dir, exist_ok=True)
    path = os.path.join(trace_dir, f"torch_serve_online_{run}.json")
    export_engine_trace(eng, path)
    print(f"  trace -> {path} (+ sibling .metrics.json)")


def _attach_completion_printer(eng):
    """Print each request the moment its last token commits."""
    def on_commit(req, toks, now_ms):
        if req.done:
            print(f"    [t={now_ms:8.1f}ms] rid={req.rid} done "
                  f"({len(req.generated)} tokens)")
    eng.on_commit = on_commit


def run_sync(dep, args, arrivals, prompts):
    print(f"== {args.requests} requests, {args.mode} arrivals, simulated "
          f"clock ==")
    print(f"{'strategy':<10} {'ms/token':>9} {'p95':>8} {'tok/s':>8} "
          f"{'acc/iter':>9}")
    for strategy in ("ar", "vanilla", "specinfer", "pipeinfer", "cosine"):
        eng = dep.engine(strategy)
        if args.stream:
            _attach_completion_printer(eng)
        for (p, dom), t in zip(prompts, arrivals):
            eng.submit(p, max_new_tokens=args.max_new, domain=dom,
                       arrival_ms=float(t))
        stats = eng.run()
        lat = [(r.finish_ms - r.arrival_ms) / max(len(r.generated), 1)
               for r in eng.pool.completed]
        print(f"{strategy:<10} {np.mean(lat):>9.1f} "
              f"{np.percentile(lat, 95):>8.1f} "
              f"{stats.throughput_tps:>8.1f} {stats.mean_acceptance:>9.2f}")
        if args.trace and strategy == "cosine":
            _export(eng, args.trace, "cosine")


async def run_async(dep, args, arrivals, prompts):
    """Asyncio front-end on the wall-clock backend: the engine loop in a
    worker thread, per-request token streams as asyncio queues fed from
    the engine's on_commit hook."""
    loop = asyncio.get_running_loop()
    eng = dep.engine(args.strategy, backend="async")
    queues = {}

    def on_commit(req, toks, now_ms):
        q = queues.get(req.rid)
        if q is not None:
            loop.call_soon_threadsafe(q.put_nowait, (list(toks), req.done))

    eng.on_commit = on_commit

    async def consume(rid, dom):
        got, q = [], queues[rid]
        while True:
            toks, done = await q.get()
            got.extend(toks)
            print(f"  rid={rid} [{dom:>9}] +{len(toks):2d} tokens "
                  f"({len(got):3d} total)" + ("  <done>" if done else ""))
            if done:
                return got

    print(f"== async: {args.requests} requests, {args.strategy}, "
          f"wall-clock backend on {dep.device} ==")
    for (p, dom), t in zip(prompts, arrivals):
        r = eng.submit(p, max_new_tokens=args.max_new, domain=dom,
                       arrival_ms=float(t))
        queues[r.rid] = asyncio.Queue()
    consumers = [asyncio.create_task(consume(r.rid, r.domain or "-"))
                 for r in eng.pool.pending(float("inf"))]
    try:
        stats = await loop.run_in_executor(None, eng.run)
        await asyncio.gather(*consumers)
    finally:
        eng.backend.shutdown()

    done = eng.pool.completed
    lat = [(r.finish_ms - r.arrival_ms) / max(len(r.generated), 1)
           for r in done]
    print(f"\n{len(done)} completed | ms/token {np.mean(lat):.1f} "
          f"(wall) | p95 {np.percentile(lat, 95):.1f} | "
          f"verifier util {stats.verifier_utilization:.2f} | "
          f"{stats.total_committed} tokens in {stats.sim_ms:.0f}ms wall")
    if args.trace:
        _export(eng, args.trace, "async")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--mode", choices=["low", "high", "volatile"],
                    default="volatile")
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--backend", choices=["sim", "async"], default="sim",
                    help="sim: simulated-clock comparison across all "
                         "strategies; async: wall-clock asyncio "
                         "front-end with streaming tokens")
    ap.add_argument("--strategy", default="cosine",
                    choices=["vanilla", "specinfer", "pipeinfer", "cosine"],
                    help="strategy for the async front-end")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--no-stream", dest="stream", action="store_false",
                    help="suppress per-request completion lines in the "
                         "sim comparison")
    ap.add_argument("--trace", type=str, nargs="?", const="traces",
                    default=None, metavar="DIR",
                    help="export the cosine (or async) run's Perfetto "
                         "trace + metrics JSON into DIR (default ./traces)")
    args = ap.parse_args(argv)

    dep = Deployment(args.device)
    arrivals = make_arrivals(args.mode, args.requests, seed=5)
    prompts = dep.corpus.prompts(args.requests, 16, seed=13)
    if args.backend == "async":
        asyncio.run(run_async(dep, args, arrivals, prompts))
    else:
        run_sync(dep, args, arrivals, prompts)


if __name__ == "__main__":
    main()
