"""A tiny cell on the CPU for the tests: the data under `data/`."""
from pathlib import Path

DATA = Path(__file__).resolve().parent / "data"
ROOT = DATA.parents[2]


def bench(family="dense", per_layer=(), end_to_end=("tokens_per_s",
                                                     "ttft_p50_ms",
                                                     "setup_s")):
    """A BENCHMARK.json-like dict with one tiny cell, "tiny.t4"."""
    return {
        "configs": [{"name": "tiny",
                     "file": f"cosine_bench/tests/data/tiny-{family}.json"}],
        "workloads": [{"name": "tiny.t4", "config": "tiny",
                       "traffic": "tiny4", "chips": 1}],
        "end_to_end": [{"name": n, "unit": "u"} for n in end_to_end],
        "per_layer": [{"name": n, "unit": "u"} for n in per_layer]}


def run(seed=5, seconds=1.5, trace=False, family="dense", **kw):
    """`run.run_cell` of the tiny cell on the CPU."""
    import time

    from cosine_bench import run as run_mod
    b = kw.pop("bench", None) or bench(family)
    return run_mod.run_cell(b, "tiny.t4", seed, seconds, trace, device="cpu",
                            t_start=time.perf_counter(),
                            root=kw.pop("root", ROOT),
                            traffic_dir=kw.pop("traffic_dir", DATA), **kw)
