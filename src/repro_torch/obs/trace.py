"""Per-request / per-stage span tracer (DESIGN.md §2.6).

A `Span` is one closed interval on one *track* of the serving timeline:

  * stage tracks  — ``verify``, ``draft{i}`` (one per drafter node),
    ``draft`` (the coupled baselines' aggregate cluster), ``cluster``
    (fusion/transit activity that is not node occupancy). Work spans on a
    serial stage track tile without overlap; measured idle gaps are
    emitted as explicit ``bubble`` spans carrying their cause, so the
    stage's busy/idle totals are recoverable from the trace alone (and
    must match `ServeStats` — CI gates the drift).
  * request tracks — ``req{rid}``: lifecycle instants (``arrival``,
    ``shed``, ``preempt``, ``readmit``, ``commit``, ``first_token``,
    ``complete``) plus, at export time, every stage span whose `rids`
    include the request — the per-request waterfall.

Span identity is deterministic: `seq` is a global monotone counter in
host execution order (the simulated serving loop is single-threaded; the
wall-clock loop's two threads write through `obs.wall.WallTracer`, which
orders them under a lock), and the exported id is derived from (track,
cohort, rid, name, seq); all times come from the simulated stage
clocks. Two same-seed runs therefore produce byte-identical exports
(tested). The wall-clock loop emits the same schema from measured time.

Memory is bounded by `max_spans` (a ring: oldest spans drop, the drop
count is surfaced in the metrics export); with the cap unhit the trace
is complete and determinism tests are unaffected.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional, Tuple

# span categories
STAGE = "stage"          # serial-resource occupancy (verify / draft nodes)
CLUSTER = "cluster"      # cluster-level activity (fuse, transit)
LIFECYCLE = "lifecycle"  # per-request state transitions (instants)


@dataclass(frozen=True)
class Span:
    seq: int
    name: str
    cat: str                     # STAGE | CLUSTER | LIFECYCLE
    track: str                   # "verify" | "draft{i}" | "cluster" | "req{rid}"
    t0_ms: float
    t1_ms: float                 # == t0_ms for instants
    rid: int = -1                # owning request (lifecycle spans)
    cohort: int = -1             # cohort sequence number (-1 = none)
    rids: Tuple[int, ...] = ()   # requests a stage span covers
    args: Tuple[Tuple[str, object], ...] = ()

    @property
    def dur_ms(self) -> float:
        return self.t1_ms - self.t0_ms

    @property
    def is_instant(self) -> bool:
        return self.t1_ms == self.t0_ms

    def span_id(self) -> str:
        """Deterministic id: rid + cohort seq + name + global order."""
        return f"{self.track}/c{self.cohort}/r{self.rid}/{self.name}/{self.seq}"

    def get(self, key: str, default=None):
        for k, v in self.args:
            if k == key:
                return v
        return default


class Tracer:
    def __init__(self, enabled: bool = True, max_spans: int = 0):
        self.enabled = enabled
        self.max_spans = int(max_spans)
        self.spans: Deque[Span] = deque(
            maxlen=self.max_spans if self.max_spans > 0 else None)
        self._seq = 0
        self.n_dropped = 0

    def span(self, name: str, cat: str, track: str, t0_ms: float,
             t1_ms: float, rid: int = -1, cohort: int = -1,
             rids: Tuple[int, ...] = (), **args) -> Optional[Span]:
        if not self.enabled:
            return None
        if self.max_spans > 0 and len(self.spans) == self.max_spans:
            self.n_dropped += 1
        s = Span(self._seq, name, cat, track, float(t0_ms), float(t1_ms),
                 int(rid), int(cohort), tuple(int(r) for r in rids),
                 tuple(sorted(args.items())))
        self._seq += 1
        self.spans.append(s)
        return s

    def instant(self, name: str, cat: str, track: str, t_ms: float,
                rid: int = -1, cohort: int = -1,
                rids: Tuple[int, ...] = (), **args) -> Optional[Span]:
        return self.span(name, cat, track, t_ms, t_ms, rid=rid,
                         cohort=cohort, rids=rids, **args)

    def mark(self, name: str, rid: int, t_ms: float, cohort: int = -1,
             **args) -> Optional[Span]:
        """Lifecycle instant on the request's own track."""
        return self.instant(name, LIFECYCLE, f"req{rid}", t_ms, rid=rid,
                            cohort=cohort, **args)

    # --------------------------------------------------------------- views
    def by_track(self, track: str) -> List[Span]:
        return [s for s in self.spans if s.track == track]

    def stage_tracks(self) -> List[str]:
        return sorted({s.track for s in self.spans if s.cat == STAGE})

    def stage_totals(self, track: str) -> Tuple[float, float]:
        """(busy_ms, idle_ms) of one serial stage track, from the trace
        alone: work spans are busy, `bubble` spans are measured idle."""
        busy = idle = 0.0
        for s in self.by_track(track):
            if s.cat != STAGE or s.is_instant:
                continue
            if s.name == "bubble":
                idle += s.dur_ms
            else:
                busy += s.dur_ms
        return busy, idle
