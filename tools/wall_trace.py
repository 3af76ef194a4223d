#!/usr/bin/env python3
"""The program's own wall spans and host-read counters in one run of a
benchmark cell, read the way per-layer metrics would read them.

Runs one cell exactly as `cosine_bench/run.py` does (`run.run_cell`),
and keeps, from the engine it builds, the tracer's spans and the
`host.*` counters after every step; with `--trace 1` also the profiled
stretch's events. The harness's files are used as they are: this script
wraps its calls from outside. Prints the harness's result line, then a
line of readings over the harness's host window [`t_open`, `host_t1`]
(which leaves the profiled stretch out) and the profiled stretch:

  draft_step_ms_p50    median wall ms of the engine's `draft.step` spans
  draft_offcpu_frac    % of those spans' wall time off the CPU:
                       1 - sum(cpu_ms) / sum(wall), the time the thread
                       waited for the interpreter lock or was blocked
  verify_offcpu_frac   the same over the server's `verify.launch` spans
  host_syncs_per_iter  host reads (`host.syncs`, every site and thread)
                       over the iterations of the host window
  admit_wait_p50_ms    median over the requests that arrived in the host
                       window of `admit` - `arrival`; one not admitted by
                       its end counts its wait so far
  draft_step_device_ms device time launched inside the `repro_torch:
                       draft.step` ranges of the profiled stretch, a range

and a table of every span name in the host window (count, wall, CPU,
self time, off-CPU share), host reads by site and thread, the device
time launched inside each span name's ranges, and, after the run, a
calibration of the off-CPU reading on this host (`calibrate`). Needs a
CUDA card.

    python3 tools/wall_trace.py --workload qwen1.5-4b.chat16 --seed 7 --trace 1
    python3 tools/wall_trace.py --workload qwen1.5-4b.chat16 --seed 7 \
        --readings 0 --enable-tracing 0

`--readings 0` installs no hook (only `--enable-tracing` acts), for
timing the program with its tracing on and off. Each run's line is
appended to `chiprun_out/wall_trace.jsonl`.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
#: profiler range names whose launched device time is reported
RANGE_NAMES = ("draft.step", "draft.extend", "commit.drafters", "prefill",
               "verify.launch", "commit.launch", "prefill.launch")


def nearest_rank(values, q):
    """The q-th quantile by nearest rank (None for no values)."""
    if not values:
        return None
    v = sorted(values)
    return v[max(math.ceil(q * len(v)) - 1, 0)]


def offcpu_pct(spans):
    """% of the spans' wall time off the CPU (None for no wall time)."""
    wall = sum(s["t1"] - s["t0"] for s in spans) * 1e3
    if wall <= 0:
        return None
    return 100.0 * (1.0 - sum(s["cpu_ms"] for s in spans) / wall)


def readings(spans, snaps, t_open, host_t1, device=None):
    """The six readings (see the module docstring) from the program's
    spans (dicts on the perf_counter clock: name, track, t0, t1, cpu_ms,
    parent, seq, rid), the per-step counter snapshots [(perf_counter,
    {counter: value})] and the host window; `device` maps a range name
    to (ranges, device us) in the profiled stretch."""
    def window(name):
        return [s for s in spans if s["name"] == name
                and t_open <= s["t0"] < host_t1]

    steps = window("draft.step")
    out = {"draft_step_ms_p50": None, "draft_offcpu_frac": offcpu_pct(steps),
           "verify_offcpu_frac": offcpu_pct(window("verify.launch")),
           "host_syncs_per_iter": None, "admit_wait_p50_ms": None,
           "draft_step_device_ms": None}
    p50 = nearest_rank([s["t1"] - s["t0"] for s in steps], 0.5)
    if p50 is not None:
        out["draft_step_ms_p50"] = p50 * 1e3
    before = [s for s in snaps if s[0] <= t_open]
    inside = [s for s in snaps if t_open < s[0] <= host_t1]
    if before and inside:
        def syncs(c):
            return sum(v for k, v in c.items() if k.startswith("host.syncs"))
        n = syncs(inside[-1][1]) - syncs(before[-1][1])
        if any(k.startswith("host.syncs") for k in inside[-1][1]):
            out["host_syncs_per_iter"] = n / len(inside)
    admits = {s["rid"]: s["t0"] for s in spans if s["name"] == "admit"}
    if admits:
        waits = []
        for s in spans:
            if s["name"] == "arrival" and t_open <= s["t0"] < host_t1:
                t = admits.get(s["rid"])
                waits.append((t if t is not None and t <= host_t1
                              else host_t1) - s["t0"])
        p50 = nearest_rank(waits, 0.5)
        out["admit_wait_p50_ms"] = None if p50 is None else p50 * 1e3
    n, us = (device or {}).get("draft.step", (0, 0.0))
    if n:
        out["draft_step_device_ms"] = us / 1e3 / n
    return out


def span_table(spans, t_open, host_t1):
    """{track/name: [count, wall ms, self ms, cpu ms, off-CPU %]} over
    the wall spans that began in the host window."""
    inside = [s for s in spans if "cpu_ms" in s
              and t_open <= s["t0"] < host_t1]
    child = {}
    for s in inside:
        child[s["parent"]] = child.get(s["parent"], 0.0) + s["t1"] - s["t0"]
    table = {}
    for s in inside:
        row = table.setdefault(f"{s['track']}/{s['name']}",
                               [0, 0.0, 0.0, 0.0, 0.0])
        wall = s["t1"] - s["t0"]
        row[0] += 1
        row[1] += wall * 1e3
        row[2] += (wall - child.get(s["seq"], 0.0)) * 1e3
        row[3] += s["cpu_ms"]
    for row in table.values():
        row[4] = 100.0 * (1.0 - row[3] / row[1]) if row[1] > 0 else 0.0
    return {k: [round(x, 3) for x in v] for k, v in sorted(table.items())}


def calibrate(seconds: float = 0.5) -> dict:
    """What `WallTracer` spans read on this host in known conditions:
    the thread CPU clock's step (ns on most hosts, a scheduler tick on
    some), and the off-CPU % of spans that sleep (100 expected), spin in
    Python alone (0), and spin in Python on two threads at once, which
    share the interpreter lock (about 50 each)."""
    import threading
    from repro_torch.obs.wall import WallTracer
    steps = []
    for _ in range(5):
        t = time.thread_time_ns()
        while (u := time.thread_time_ns()) == t:
            pass
        steps.append(u - t)
    tr = WallTracer(clock=lambda: time.perf_counter() * 1e3)

    def spin(name):
        with tr.wall(name, name):
            t_end = time.perf_counter() + seconds
            while time.perf_counter() < t_end:
                pass

    with tr.wall("sleep", "sleep"):
        time.sleep(seconds)
    spin("alone")
    threads = [threading.Thread(target=spin, args=("shared",))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    out = {"cpu_clock_step_ms": min(steps) / 1e6}
    for name in ("sleep", "alone", "shared"):
        spans = [dict(t0=s.t0_ms / 1e3, t1=s.t1_ms / 1e3,
                      cpu_ms=s.get("cpu_ms"))
                 for s in tr.wall_spans() if s.name == name]
        out[f"offcpu_{name}"] = offcpu_pct(spans)
    return out


class Hooks:
    """Wraps the harness's calls to keep what the readings need, and
    releases every reference to the engine before the check runs."""

    def __init__(self, serve, yardstick):
        self.serve, self.yardstick = serve, yardstick
        self.snaps, self.spans, self.run, self.device = [], [], None, {}
        self._events = None
        self._install()

    def _install(self):
        serve, yardstick, hooks = self.serve, self.yardstick, self
        build, cell_run = serve.build_engine, serve.Cell.run
        events, reduce = yardstick.profiler_events, serve.Tracing.reduce

        def build_engine(*a, **kw):
            eng = build(*a, **kw)
            hooks._watch(eng)
            return eng

        def run(cell):
            hooks.run = cell_run(cell)
            return hooks.run

        def profiler_events(torch, prof):
            out = events(torch, prof)
            hooks._events = out[0]
            return out

        def reduced(tracing, t0, t1, sent):
            out = reduce(tracing, t0, t1, sent)
            hooks._ranges(tracing, t0, t1)
            return out

        serve.build_engine, serve.Cell.run = build_engine, run
        yardstick.profiler_events, serve.Tracing.reduce = (profiler_events,
                                                           reduced)

    def _watch(self, eng):
        step, shutdown = eng.step, eng.backend.shutdown
        snaps = self.snaps

        def counters():
            return {k: v for k, v in eng.metrics.to_dict()["counters"].items()
                    if k.startswith("host.")}

        def counted_step():
            out = step()
            snaps.append((time.perf_counter(), counters()))
            return out

        def kept_shutdown():
            shutdown()
            off = time.perf_counter() - eng.backend.now_ms() / 1e3
            for s in list(eng.tracer.spans):
                if s.get("cpu_ms") is None and s.name not in ("admit",
                                                              "arrival"):
                    continue
                d = dict(s.args)
                d.update(name=s.name, track=s.track, seq=s.seq, rid=s.rid,
                         cohort=s.cohort, t0=s.t0_ms / 1e3 + off,
                         t1=s.t1_ms / 1e3 + off)
                self.spans.append(d)
            del eng.step, eng.backend.shutdown

        eng.step, eng.backend.shutdown = counted_step, kept_shutdown

    def _ranges(self, tracing, t0, t1):
        ev, self._events = self._events, None
        anchor = [e for e in ev or () if e.name == self.serve.ANCHOR]
        if not anchor:
            return
        off = anchor[0].time_range.start - tracing.t_anchor * 1e6
        for name in RANGE_NAMES:
            n, us = self.yardstick.range_device_us(
                tracing.torch, ev, "repro_torch: " + name, t0 * 1e6 + off,
                t1 * 1e6 + off)
            if n:
                self.device[name] = (n, us)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--readings", type=int, choices=(0, 1), default=1)
    ap.add_argument("--enable-tracing", type=int, choices=(0, 1), default=1,
                    help="the program's CoSineConfig.enable_tracing")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from cosine_bench import run as bench_run
    from cosine_bench import serve, spec, yardstick
    for var, sub in bench_run.CACHE_DIRS.items():
        os.environ[var] = str(ROOT / sub)
    bench = spec.load(ROOT)
    config = spec.config

    def configured(b, cell, root=ROOT):
        conf = config(b, cell, root)
        conf["program"]["cosine"]["enable_tracing"] = bool(
            args.enable_tracing)
        return conf

    spec.config = configured
    hooks = Hooks(serve, yardstick) if args.readings else None
    result, err = bench_run.run_cell(bench, args.workload, args.seed,
                                     args.seconds, bool(args.trace),
                                     t_start=T_START)
    for line in err:
        print(line, file=sys.stderr)
    line = dict(workload=args.workload, seed=args.seed, trace=args.trace,
                enable_tracing=args.enable_tracing, result=result)
    if hooks is not None and hooks.run is not None:
        run = hooks.run
        t_open, host_t1 = run["t_open"], run.get("host_t1", run["t_close"])
        line["readings"] = readings(hooks.spans, hooks.snaps, t_open,
                                    host_t1, hooks.device)
        line["spans"] = span_table(hooks.spans, t_open, host_t1)
        first = [c for t, c in hooks.snaps if t <= t_open][-1:]
        last = [c for t, c in hooks.snaps if t <= host_t1][-1:]
        if first and last:
            line["host_reads"] = {k: v - first[0].get(k, 0.0)
                                  for k, v in last[0].items()}
        line["range_device_ms"] = {k: [n, us / 1e3] for k, (n, us)
                                   in hooks.device.items()}
        line["calibration"] = calibrate()
    print(json.dumps(line), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "wall_trace.jsonl", "a") as f:
        f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
