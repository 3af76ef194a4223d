"""The control of the correctness check, and the program's readings
beside it, on the chip.

    python3 cosine_bench/control.py --workload <name> --seeds 11 12 13 --seconds 51

For each seed, in one process: the cell is served as a benchmark run
serves it (set-up, ramp, a window of `--seconds`), the program's state is
freed, and the run's sample of delivered tokens (`check.sample`) is read
by the reference, with the run's sample of verification rows
(`check.sample_rows`): the program's numbers (`check.NUMBERS` over the
pooled gaps, as `check.compare` takes them: the widest gap of a token
below the reference's best logit, the share of tokens not its first),
and the same numbers of the token that the reference ranks first in
each lower precision (TF32 products, fp8 activations), at the same
positions. One JSON line a seed goes to standard output. Each limit
in the configuration file has to lie between the program's readings and
its control's (PERF.md gives the readings it was set from).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: every control the references compute (a configuration names its own)
CONTROLS = ("tf32", "fp8")


def readings(bench, name, seed, seconds, device="cuda", t_start=None,
             root=ROOT, traffic_dir=None):
    """The numbers of one seed's run of cell `name`: the program's, and
    each control's on the same sample (`check.NUMBERS`)."""
    import numpy as np
    import torch

    from cosine_bench import check, serve, spec, traffic
    cell = spec.cell(bench, name)
    conf = spec.config(bench, cell, root)
    mix = traffic.load(cell["traffic"], traffic_dir or traffic.HERE / "traffic")
    plan = traffic.generate(mix, seed, conf["vocab_size"],
                            conf["drafters"]["domains"])
    c = serve.Cell(torch, conf, plan, seed, seconds, False, device,
                   t_start or time.perf_counter())
    c.run()
    reqs = check.sample(c.sent, seed)
    rows = check.sample_rows(c.verify_rows, seed)
    by_rid = {s.rid: s for s in c.sent}
    params = check.reference_params(torch, conf, seed, device)
    out = {"workload": name, "seed": seed}
    for kind in (None,) + CONTROLS:
        gd = np.concatenate(check.gaps(torch, conf, params, reqs, device,
                                       control=kind))
        gv = np.concatenate(check.verify_gaps(torch, conf, params, rows,
                                              by_rid, device, control=kind))
        g = np.concatenate([gd, gv])
        out[kind or "program"] = {k: f(g) for k, f in check.NUMBERS.items()}
        out[(kind or "program") + ".verified"] = {
            k: f(gv) for k, f in check.NUMBERS.items()}
        out["tokens"] = {"delivered": int(gd.size), "verified": int(gv.size)}
    del params
    out["limits"] = conf["correct"]["limits"]
    out["control"] = conf["correct"]["control"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 3
    from cosine_bench import spec
    bench = spec.load(ROOT)
    t = T_START
    for seed in args.seeds:
        print(json.dumps(readings(bench, args.workload, seed, args.seconds,
                                  t_start=t)), flush=True)
        t = time.perf_counter()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
