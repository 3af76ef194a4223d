"""Wall-clock telemetry of the wall-clock backend (port only).

`AsyncTorchBackend` serves on two threads: the engine thread drafts,
walks and commits, and the verification server runs the target's tasks.
This module adds, on top of the shared `Tracer` and `MetricsRegistry`:

  * `WallTracer` — the port's `Tracer`. On the simulated backend it is
    the `Tracer` (no clock, no lock: the simulated export stays
    byte-identical to the JAX engine's). Given a clock, `wall` records
    spans of real time on the calling thread: start and end on the
    backend's clock (ms), the thread's CPU time over the span
    (``cpu_ms``: what is missing from the wall time is time off the CPU,
    waiting for the interpreter lock or blocked), the span open beneath
    it on the same thread (``parent``, that span's `seq`) and its own
    ``seq`` in ``args``, so a span's self time can be computed from an
    export. Two threads write spans: a lock covers sequence numbers and
    the span store, so none is lost and every `seq` is unique (a wall
    span takes its `seq` when it opens and is stored when it closes).
    While a `torch.profiler` records, each wall span also opens a
    `record_function` range ``repro_torch: <name>`` on its thread, so
    the program's spans sit in the device trace on the profiler's clock,
    beside the kernels they launched.

    ``cpu_ms`` is read inside the wall interval and is as fine as the
    host's thread CPU clock: where that clock advances by scheduler
    ticks, one span's ``cpu_ms`` is a sample that may exceed its wall
    time by a tick, and only sums over many spans mean much.
  * `note_host_read` / `counting_host_reads` — counters of the reads
    that stall the calling thread until the device has caught up (a copy
    to host memory, a `.tolist()`): ``host.syncs{site,thread}`` and
    ``host.d2h_bytes{site,thread}``, bytes from shape and dtype (no
    device read). Each thread counts into cells of its own, labelled by
    thread, so no counter has two writers and the hot path takes no
    lock.

Both are on only while `CoSineConfig.enable_tracing` is set: with it off
a wall span costs one check and a host read one thread-local lookup.
"""
from __future__ import annotations

import contextlib
import sys
import threading
import time
from typing import Callable, List, Optional, Tuple

from repro_torch.obs.trace import Span, Tracer

WALL = "wall"            # span category: wall-clock host interval
ENGINE = "engine"        # thread track: the engine thread
SERVER = "server"        # thread track: the verification server

#: prefix of the profiler ranges wall spans open while a profiler records
RANGE_PREFIX = "repro_torch: "


def _profiling() -> bool:
    """Whether a `torch.profiler` is recording in this process: a module
    flag the profiler sets when it starts and clears when it stops (an
    attribute read; no torch import here)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


class _Off:
    """What `WallTracer.wall` returns when it records nothing: enters,
    exits and takes attributes to no effect."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __setattr__(self, key, value):
        pass


OFF = _Off()


class WallSpan:
    """An open wall span (`WallTracer.wall`). `cohort` may be set while
    it is open; `seq` is its id, the `parent` of spans opened inside."""
    __slots__ = ("tracer", "name", "cat", "track", "cohort", "rids", "args",
                 "seq", "parent", "_t0", "_c0", "_range")

    def __init__(self, tracer, name, cat, track, cohort, rids, args):
        self.tracer, self.name, self.cat = tracer, name, cat
        self.track, self.cohort, self.rids = track, cohort, rids
        self.args = args

    def __enter__(self):
        tr = self.tracer
        stack = tr._stack()
        self.parent = stack[-1].seq if stack else -1
        self.seq = tr._take_seq()
        stack.append(self)
        self._range = None
        if _profiling():
            from torch.profiler import record_function
            self._range = record_function(RANGE_PREFIX + self.name)
            self._range.__enter__()
        self._t0 = tr.clock()
        self._c0 = time.thread_time_ns()
        return self

    def __exit__(self, *exc):
        c1 = time.thread_time_ns()
        tr = self.tracer
        t1 = tr.clock()
        if self._range is not None:
            self._range.__exit__(*exc)
        tr._stack().pop()
        args = dict(self.args, cpu_ms=(c1 - self._c0) / 1e6,
                    parent=self.parent, seq=self.seq)
        tr._store(Span(self.seq, self.name, self.cat, self.track,
                       float(self._t0), float(t1), -1, int(self.cohort),
                       tuple(int(r) for r in self.rids),
                       tuple(sorted(args.items()))))
        return False


class WallTracer(Tracer):
    """The port's tracer. `clock` (ms), the wall-clock backend's
    `now_ms`, turns the wall path on while tracing is enabled."""

    def __init__(self, enabled: bool = True, max_spans: int = 0,
                 clock: Optional[Callable[[], float]] = None):
        super().__init__(enabled=enabled, max_spans=max_spans)
        self.clock = clock if enabled else None
        self._lock = (threading.Lock() if self.clock is not None
                      else contextlib.nullcontext())
        self._tls = threading.local()

    def span(self, name: str, cat: str, track: str, t0_ms: float,
             t1_ms: float, rid: int = -1, cohort: int = -1,
             rids: Tuple[int, ...] = (), **args) -> Optional[Span]:
        with self._lock:
            return super().span(name, cat, track, t0_ms, t1_ms, rid=rid,
                                cohort=cohort, rids=rids, **args)

    def wall(self, name: str, track: str, cat: str = WALL, cohort: int = -1,
             rids: Tuple[int, ...] = (), **args):
        """Context manager: a span of real time on the calling thread, on
        `track` (`ENGINE` / `SERVER`, or a stage track with
        `cat=STAGE`). Records nothing (one check) without a clock."""
        if self.clock is None:
            return OFF
        return WallSpan(self, name, cat, track, cohort, rids, args)

    def current(self) -> Optional[WallSpan]:
        """The innermost wall span open on the calling thread."""
        stack = getattr(self._tls, "stack", None)
        return stack[-1] if stack else None

    def wall_spans(self) -> List[Span]:
        """The wall spans (those with a ``cpu_ms``), in `seq` order."""
        with self._lock:
            spans = list(self.spans)
        return sorted((s for s in spans if s.get("cpu_ms") is not None),
                      key=lambda s: s.seq)

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _take_seq(self) -> int:
        with self._lock:
            seq = self._seq
            self._seq += 1
        return seq

    def _store(self, s: Span) -> None:
        with self._lock:
            if self.max_spans > 0 and len(self.spans) == self.max_spans:
                self.n_dropped += 1
            self.spans.append(s)


# ---------------------------------------------------------- host reads
_host = threading.local()


def note_host_read(site: str, nbytes: int) -> None:
    """One read of `nbytes` to the host at `site` that stalls the calling
    thread, counted where this thread counts (`counting_host_reads`);
    nothing where it counts nowhere."""
    cells = getattr(_host, "cells", None)
    if cells is not None:
        cells.add(site, nbytes)


class _HostCells:
    """One thread's host-read counters in one registry, by site."""
    __slots__ = ("reg", "thread", "by_site")

    def __init__(self, reg, thread: str):
        self.reg, self.thread, self.by_site = reg, thread, {}

    def add(self, site: str, nbytes: int) -> None:
        c = self.by_site.get(site)
        if c is None:
            c = self.by_site[site] = (
                self.reg.counter("host.syncs", site=site, thread=self.thread),
                self.reg.counter("host.d2h_bytes", site=site,
                                 thread=self.thread))
        c[0].value += 1
        c[1].value += nbytes


@contextlib.contextmanager
def counting_host_reads(registry, thread: str):
    """Within the block, the calling thread's `note_host_read`s count in
    `registry` under the label ``thread=<thread>`` (one writer a label)."""
    prev = getattr(_host, "cells", None)
    _host.cells = _HostCells(registry, thread)
    try:
        yield
    finally:
        _host.cells = prev
