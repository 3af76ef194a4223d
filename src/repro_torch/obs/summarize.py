"""CLI trace summarizer: ``python -m repro_torch.obs.summarize trace.json``.

Reads a trace exported by `repro_torch.obs.export` and prints

  * per-stage busy/idle/utilization totals (recomputed from the spans
    alone — the same accounting `check_regression.py` gates against the
    benchmark's vutil column),
  * the top pipeline-bubble causes by total stalled time,
  * a per-request waterfall (first N requests): every lifecycle instant
    and stage span on the request's track, in time order.

Works on the flat event list via the embedded ``args.track`` /
``args.stage`` fields — no thread-metadata cross-referencing.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Dict, List, Tuple


def _is_projected(ev: dict) -> bool:
    """Projected per-request copies carry their source stage track."""
    return "stage" in ev.get("args", {})


def stage_totals(events: List[dict]) -> Dict[str, Tuple[float, float]]:
    """track -> (busy_us, idle_us) over the serial stage tracks, from
    the trace alone: work spans are busy, ``bubble`` spans are idle.
    Projected request-track copies are excluded (they would double
    count), as is the cluster track (transit overlaps node work)."""
    out: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0.0])
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") != "stage" \
                or _is_projected(ev):
            continue
        track = ev["args"]["track"]
        out[track][ev["name"] == "bubble"] += ev.get("dur", 0.0)
    return {t: (b, i) for t, (b, i) in out.items()}


def bubble_causes(events: List[dict]) -> List[Tuple[str, float, int]]:
    """(cause, total_us, count) for every bubble span, worst first."""
    acc: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for ev in events:
        if ev.get("ph") != "X" or ev.get("name") != "bubble" \
                or _is_projected(ev):
            continue
        cause = ev["args"].get("cause", "unknown")
        acc[cause][0] += ev.get("dur", 0.0)
        acc[cause][1] += 1
    return sorted(((c, v[0], int(v[1])) for c, v in acc.items()),
                  key=lambda x: (-x[1], x[0]))


def request_tracks(events: List[dict]) -> Dict[int, List[dict]]:
    """rid -> that request's events (lifecycle + projected stage spans),
    time-ordered."""
    out: Dict[int, List[dict]] = defaultdict(list)
    for ev in events:
        track = ev.get("args", {}).get("track", "")
        if ev.get("ph") in ("X", "i") and track.startswith("req"):
            try:
                rid = int(track[3:])
            except ValueError:
                continue
            out[rid].append(ev)
    for evs in out.values():
        evs.sort(key=lambda e: (e["ts"], e.get("dur", 0.0), e["name"]))
    return dict(sorted(out.items()))


def summarize(trace: dict, n_requests: int = 4, n_causes: int = 5,
              out=sys.stdout) -> None:
    events = trace["traceEvents"]
    w = out.write

    w("== stage occupancy ==\n")
    totals = stage_totals(events)
    for track in sorted(totals):
        busy, idle = totals[track]
        util = busy / max(busy + idle, 1e-9)
        w(f"  {track:<10s} busy {busy / 1000.0:10.2f} ms   "
          f"idle {idle / 1000.0:10.2f} ms   util {util:6.1%}\n")

    causes = bubble_causes(events)
    w("\n== top bubble causes ==\n")
    if not causes:
        w("  (no pipeline bubbles)\n")
    for cause, us, n in causes[:n_causes]:
        w(f"  {cause:<14s} {us / 1000.0:10.2f} ms over {n} bubbles\n")

    w("\n== per-request waterfall ==\n")
    tracks = request_tracks(events)
    for rid, evs in list(tracks.items())[:n_requests]:
        w(f"  req {rid}:\n")
        for ev in evs:
            t0 = ev["ts"] / 1000.0
            if ev["ph"] == "i":
                w(f"    {t0:10.2f} ms             * {ev['name']}\n")
            else:
                t1 = (ev["ts"] + ev.get("dur", 0.0)) / 1000.0
                stage = ev["args"].get("stage", "")
                w(f"    {t0:10.2f} ms -> {t1:10.2f} ms  {ev['name']}"
                  f"{f' [{stage}]' if stage else ''}\n")
    if len(tracks) > n_requests:
        w(f"  ... {len(tracks) - n_requests} more requests\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Summarize a repro_torch.obs trace JSON")
    ap.add_argument("trace", help="path to a trace exported with --trace")
    ap.add_argument("--requests", type=int, default=4,
                    help="waterfalls to print (default 4)")
    ap.add_argument("--causes", type=int, default=5,
                    help="bubble causes to print (default 5)")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        trace = json.load(f)
    summarize(trace, n_requests=args.requests, n_causes=args.causes)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
