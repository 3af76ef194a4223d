"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 cosine_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, this folder and
the program (`src/repro_torch`). It needs as many CUDA devices as the
cell asks for and exits with code 3, printing no result, where there are
fewer. The last line of standard output is the result: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, `breakdown` (traced runs) and,
last, `compared`: each number the correctness check compared with its
limit, which the last lines of standard error repeat.

Caches of the program's builds stay inside the checkout (`build/`). The
process must not load JAX or the JAX package: it exits with code 4,
printing no result, if `sys.modules` holds `jax`, `jaxlib`, `flax` or
`repro` once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names the process may not hold (whole names: the
#: program's package, `repro_torch`, begins with one of them)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: each build and kernel cache the program or PyTorch may write, at a
#: fixed path inside the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "TRITON_CACHE_DIR": "build/triton",
              "CUDA_CACHE_PATH": "build/cuda_cache"}


def forbidden_modules(modules=None) -> list:
    """Top-level names in `modules` (default `sys.modules`) that are in
    `FORBIDDEN`, compared whole."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None
                                          else modules)}
    return sorted(names & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as `nvidia-smi` reads them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return res.stdout.strip().splitlines()[0] if res.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: float = T_START, root: Path = ROOT,
             traffic_dir=None):
    """One run of cell `name`: (result dict, lines for standard error).
    `device="cpu"` drives the same run on the host, and `root` and
    `traffic_dir` find other data (tests); the command does neither."""
    import torch

    from cosine_bench import check, serve, spec, traffic
    phases = [("imports", time.perf_counter())]
    cell = spec.cell(bench, name)
    conf = spec.config(bench, cell, root)
    mix = traffic.load(cell["traffic"], traffic_dir or traffic.HERE / "traffic")
    plan = traffic.generate(mix, seed,
                            conf["vocab_size"], conf["drafters"]["domains"])
    cuda = torch.device(device).type == "cuda"
    if cuda:
        # the one kernel library the served forms need, built (first run
        # of a checkout) and loaded as part of set-up
        from repro_torch.kernels.flash_attention import ops as fa
        fa.LIBRARY.load()
    phases.append(("library", time.perf_counter()))
    err = []
    cellrun = serve.Cell(torch, conf, plan, seed, seconds, trace, device,
                         t_start, phases)
    try:
        run = cellrun.run()
    except Exception:                     # the run's result is "not correct"
        err.append(traceback.format_exc())
        run = None
    sent = cellrun.sent
    if run is None:
        attempted = len(sent)
        failed = sum(1 for s in sent if s.done is None)
        ok, n_cmp, nums = False, {}, {
            "max_logit_gap": {"value": None,
                              "limit": conf["correct"]["max_logit_gap"]}}
        metrics, prof = {}, None
    else:
        attempted = run["live_at_open"] + sum(
            1 for s in sent if run["t_open"] <= s.sent < run["t_close"])
        failed = 0
        run.update(conf=conf, cell=cell)
        metrics = {}
        for m, unit in spec.metrics(bench, name, trace):
            v = spec.reader(m)(run)
            if v is not None:
                metrics[m] = {"value": v, "unit": unit}
        prof = run["profile"]
        ok, n_cmp, nums = check.compare(torch, conf, sent, seed, device,
                                        cellrun.verify_rows)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["chips"]),
           "memory_peak_bytes": run["memory_peak_bytes"] if run else 0}
    if trace:
        dev.update(busy_s=(prof or {}).get("busy_s", 0.0),
                   window_s=(prof or {}).get("window_s", 0.0))
    if cuda:
        dev["power"] = power_limit()
    result = {"correct": bool(ok), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and prof and "breakdown" in prof:
        result["breakdown"] = prof["breakdown"]
    result["compared"] = nums
    if run is not None:
        gaps = [b - a for a, b in zip(run["iteration_ends"],
                                      run["iteration_ends"][1:])]
        t_prof = prof["t0"] if prof else run["t_close"]
        before = [g for g, b in zip(gaps, run["iteration_ends"][1:])
                  if b <= t_prof]
        err.append(
            f"set-up {run['setup_s']:.3f} s: "
            + ", ".join(f"{k} {v:.3f}" for k, v in
                        run["setup_phases"].items())
            + f" (ramp steps, s and clients with a first token: "
            f"{[(round(a, 2), b) for a, b in run['ramp_steps']]}); "
            f"iterations {len(gaps)}, mean "
            f"{sum(before) / max(len(before), 1):.3f} s before the "
            f"profiled stretch"
            + (f", {len(gaps) - len(before)} in it" if prof else ""))
        done = sum(1 for s in sent
                   if s.done is not None and run["t_open"] <= s.done
                   < run["t_close"])
        err.append(
            f"window {run['window_s']:.3f} s, {run['iterations']} "
            f"iterations, {attempted} requests attempted, {done} "
            f"completed; draft-ahead survived {run['survived']}, "
            f"invalidated {run['invalidated']}; compared {n_cmp}"
            + (f"; trace read in {prof['read_s']:.1f} s over "
               f"{prof['iterations']} iterations" if prof else ""))
    for k, v in nums.items():
        err.append(f"compared {k} {v['value']} limit {v['limit']}")
    return result, err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / sub)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from cosine_bench import spec
    bench = spec.load(ROOT)
    try:
        cell = spec.cell(bench, args.workload)
    except KeyError as e:
        print(e, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, err = run_cell(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"the process loaded {', '.join(bad)}: no result",
              file=sys.stderr)
        return 4
    for line in err:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
