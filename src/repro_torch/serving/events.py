"""Discrete-event primitives for the decoupled serving pipeline
(DESIGN.md §2).

The executor models the paper's deployment as two serial resources — the
speculation cluster ("draft") and the verification server ("verify") —
each advancing its own simulated clock. `StageClock` is the scheduling
primitive: work is placed on a stage no earlier than its release time,
and the gap between the stage becoming free and the work starting is
*measured idle time* (a pipeline bubble), not an analytic formula.

Every state transition is appended to an `EventLog` with a global
sequence number, so the interleaving of the two stages is a
deterministic, inspectable trace: two runs of the same engine with the
same seed must produce byte-identical event streams (tested in
tests/test_pipeline.py). For long runs the log can be ring-bounded
(`max_events`): the oldest events drop and `n_dropped` counts them (the
cap unhit, determinism tests see the identical full stream).

When a `Tracer` (obs/trace.py) is attached, every scheduled job also
emits an occupancy span on the stage's track — and every measured idle
gap an explicit ``bubble`` span carrying its cause — so the exported
trace's per-stage busy/idle totals equal this clock's accounting exactly
(DESIGN.md §2.6).
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass
from typing import Deque, Optional, Tuple

from repro_torch.obs.trace import STAGE, Tracer

DRAFT = "draft"
VERIFY = "verify"


@dataclass(frozen=True)
class Event:
    """One pipeline state transition at simulated time `t_ms`.

    `seq` is a global monotone counter: events with equal timestamps have
    a deterministic total order (host execution order), which makes the
    trace reproducible and diffable across runs.
    """
    t_ms: float
    seq: int
    stage: str                      # DRAFT | VERIFY
    kind: str                       # "start" | "end" | "invalidate" | ...
    rids: Tuple[int, ...] = ()
    info: str = ""

    def key(self):
        """Identity used by the determinism tests (everything observable)."""
        return (round(self.t_ms, 6), self.seq, self.stage, self.kind,
                self.rids, self.info)


class EventLog:
    """Bounded, totally-ordered serving event log (the `seq` counter
    breaks ties at equal simulated times — DESIGN.md §2.2)."""

    def __init__(self, max_events: int = 0):
        self.max_events = int(max_events)
        self.events: Deque[Event] = deque(
            maxlen=self.max_events if self.max_events > 0 else None)
        self._seq = itertools.count()
        self.n_dropped = 0

    def emit(self, t_ms: float, stage: str, kind: str,
             rids: Tuple[int, ...] = (), info: str = "") -> Event:
        """Append one event (drops the oldest past `max_events`)."""
        if self.max_events > 0 and len(self.events) == self.max_events:
            self.n_dropped += 1
        ev = Event(float(t_ms), next(self._seq), stage, kind,
                   tuple(int(r) for r in rids), info)
        self.events.append(ev)
        return ev

    def trace(self):
        """Deterministic comparison key list for the retained events."""
        return [ev.key() for ev in self.events]


@dataclass
class StageClock:
    """A serial pipeline stage with busy/idle accounting.

    `free_ms` is the time at which the stage can next begin work.
    `schedule()` places one unit of work: it starts at
    max(free_ms, not_before_ms); any gap is recorded as idle (bubble)
    time. Busy/idle fractions here are *measured from the event
    timeline*, which is what the adaptive speculation feedback loop
    consumes (Alg. 2) instead of the old analytic busy ratio.
    """
    name: str
    log: Optional[EventLog] = None
    tracer: Optional[Tracer] = None
    free_ms: float = 0.0
    busy_ms: float = 0.0
    idle_ms: float = 0.0
    n_jobs: int = 0
    # queue accounting: time jobs spent waiting because this stage was
    # still busy (their release time was earlier than free_ms) and how
    # many jobs waited at all — per-node queue occupancy for the cluster
    wait_ms: float = 0.0
    n_queued: int = 0

    def park(self, t_ms: float):
        """Advance the stage to `t_ms` without accruing idle time: the
        stage had no work *available* (e.g. an arrival lull), which is
        not a pipeline bubble. Never moves the clock backwards."""
        if t_ms > self.free_ms:
            self.free_ms = t_ms

    def schedule(self, duration_ms: float, not_before_ms: float = 0.0,
                 kind: str = "work", rids: Tuple[int, ...] = (),
                 release_ms: Optional[float] = None,
                 cohort: int = -1, cause: Optional[str] = None):
        """Run `duration_ms` of work; returns (start, end, idle_gap).

        release_ms: when the job actually became runnable, for the queue
        accounting only (defaults to not_before_ms). A job released
        while the stage was still busy counts the gap as queue wait.
        cohort/cause: trace attribution — the cohort the job belongs to,
        and what an idle gap ahead of it was waiting for (defaults to
        the job's own kind)."""
        start = max(self.free_ms, not_before_ms)
        gap = start - self.free_ms
        end = start + duration_ms
        self.idle_ms += gap
        self.busy_ms += duration_ms
        self.n_jobs += 1
        release = not_before_ms if release_ms is None else release_ms
        waited = max(self.free_ms - release, 0.0)
        if waited > 0.0:
            self.wait_ms += waited
            self.n_queued += 1
        free_before = self.free_ms
        self.free_ms = end
        if self.log is not None:
            self.log.emit(start, self.name, f"{kind}_start", rids)
            self.log.emit(end, self.name, f"{kind}_end", rids)
        if self.tracer is not None:
            if gap > 0.0:
                self.tracer.span("bubble", STAGE, self.name, free_before,
                                 start, cohort=cohort, rids=rids,
                                 cause=cause or kind)
            self.tracer.span(kind, STAGE, self.name, start, end,
                             cohort=cohort, rids=rids)
        return start, end, gap

    def busy_frac(self) -> float:
        """Measured occupancy over the stage's active span. A stage that
        was never scheduled reads 0.0 — it is idle capacity, not
        saturation (a no-evidence default of 1.0 made never-used drafter
        nodes look saturated to `plan()`'s drafter-feedback trim)."""
        span = self.busy_ms + self.idle_ms
        return self.busy_ms / span if span > 0 else 0.0
