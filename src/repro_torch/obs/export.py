"""Chrome/Perfetto ``trace_event`` + metrics JSON export (DESIGN.md §2.6).

`build_trace` turns a `Tracer`'s spans into the Chrome trace-event JSON
format (one thread per track: the verify stage, each drafter node, the
cluster fusion/transit track, and one per request) loadable in Perfetto
or chrome://tracing. Stage spans covering multiple requests are also
*projected* onto each covered request's track, so a request's row shows
its full waterfall (prefill → draft → verify → commit) without clicking
through the stage rows.

Every event embeds its logical ``track`` in ``args`` (plus the source
stage for projected copies), so downstream consumers — the summarizer
and `check_regression.py`'s busy/idle gate — parse the flat event list
without cross-referencing thread metadata.

Determinism contract: all timestamps come from the simulated stage
clocks, ids from monotone sequence counters, serialization is
`sort_keys=True` with fixed rounding — two same-seed runs export
byte-identical files (tested in tests/test_obs.py). No wall-clock
anywhere.
"""
from __future__ import annotations

import json
from typing import Dict, List

from repro_torch.obs.trace import LIFECYCLE, Span, Tracer

PID = 1
PROCESS_NAME = "repro-serving"


def _track_key(track: str):
    """Deterministic display order: verify, draft nodes, cluster, then
    request tracks by rid."""
    if track == "verify":
        return (0, 0, track)
    if track == "draft":
        return (1, -1, track)
    if track.startswith("draft"):
        try:
            return (1, int(track[5:]), track)
        except ValueError:
            return (1, 1 << 30, track)
    if track == "cluster":
        return (2, 0, track)
    if track.startswith("req"):
        try:
            return (3, int(track[3:]), track)
        except ValueError:
            return (3, 1 << 30, track)
    return (4, 0, track)


def _ts(t_ms: float) -> float:
    """trace_event timestamps are microseconds; fixed rounding keeps the
    serialization byte-stable."""
    return round(t_ms * 1000.0, 3)


def _span_args(s: Span, track: str, stage: str = "") -> dict:
    args: dict = {"track": track, "cohort": s.cohort}
    if stage:
        args["stage"] = stage            # projected copy: source track
    if s.rid >= 0:
        args["rid"] = s.rid
    if s.rids:
        args["rids"] = list(s.rids)
    for k, v in s.args:
        args[k] = v
    return args


def _event(s: Span, tid: int, track: str, stage: str = "") -> dict:
    ev = {
        "name": s.name, "cat": s.cat, "pid": PID, "tid": tid,
        "ts": _ts(s.t0_ms), "args": _span_args(s, track, stage),
    }
    if s.is_instant:
        ev["ph"] = "i"
        ev["s"] = "t"
    else:
        ev["ph"] = "X"
        ev["dur"] = _ts(s.t1_ms) - _ts(s.t0_ms)
    return ev


def build_trace(tracer: Tracer) -> dict:
    """Chrome trace-event dict: metadata + one event per span + a
    projected copy of every multi-request stage span on each covered
    request's track (the per-request waterfall)."""
    tracks = {s.track for s in tracer.spans}
    for s in tracer.spans:
        for rid in s.rids:
            tracks.add(f"req{rid}")
    ordered = sorted(tracks, key=_track_key)
    tid_of: Dict[str, int] = {t: i + 1 for i, t in enumerate(ordered)}

    events: List[dict] = [{
        "name": "process_name", "ph": "M", "pid": PID, "tid": 0,
        "args": {"name": PROCESS_NAME}}]
    for t in ordered:
        events.append({"name": "thread_name", "ph": "M", "pid": PID,
                       "tid": tid_of[t], "args": {"name": t}})
        events.append({"name": "thread_sort_index", "ph": "M", "pid": PID,
                       "tid": tid_of[t],
                       "args": {"sort_index": tid_of[t]}})
    for s in tracer.spans:
        events.append(_event(s, tid_of[s.track], s.track))
        if s.cat != LIFECYCLE:
            for rid in s.rids:
                rt = f"req{rid}"
                events.append(_event(s, tid_of[rt], rt, stage=s.track))
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"spans_dropped": tracer.n_dropped}}


def export_trace(tracer: Tracer, path: str) -> str:
    with open(path, "w") as f:
        json.dump(build_trace(tracer), f, sort_keys=True)
        f.write("\n")
    return path


def build_metrics(engine) -> dict:
    """Flat metrics JSON for one engine run: the registry contents plus
    the telemetry drop counters (satellite: ring-bounded logs surface
    what they dropped)."""
    m = engine.metrics
    m.set_gauge("obs.spans_dropped", engine.tracer.n_dropped)
    # the wall-clock executor keeps no event log (the reference reads
    # `executor.log` unconditionally and fails on an async engine)
    log = getattr(engine.executor, "log", None)
    if log is not None:
        m.set_gauge("obs.events_dropped", log.n_dropped)
    return m.to_dict()


def export_metrics(engine, path: str) -> str:
    with open(path, "w") as f:
        json.dump(build_metrics(engine), f, sort_keys=True)
        f.write("\n")
    return path


def export_engine_trace(engine, path: str) -> str:
    """Convenience: trace JSON next to a sibling ``*.metrics.json``."""
    export_trace(engine.tracer, path)
    mpath = (path[:-5] if path.endswith(".json") else path) \
        + ".metrics.json"
    export_metrics(engine, mpath)
    return path
