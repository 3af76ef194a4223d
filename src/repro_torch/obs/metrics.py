"""Lightweight metrics registry + controller decision log (DESIGN.md §2.6).

The registry is the *single source* for the serving aggregates: engine,
executor and cluster increment counters / set gauges / observe histograms
here, and `ServeStats`' properties (plus the benchmark columns) read them
back — no ad-hoc `total_x += ...` fields scattered across modules.

Naming convention: dotted ``subsystem.metric[_unit]`` names with optional
labels, e.g. ``verify.busy_ms``, ``serve.committed_tokens``,
``draft.node_tokens{node=3}``. Everything is plain Python floats/ints —
no deps, no locks (no counter has two writing threads: under the
wall-clock backend the server thread writes only the host-read counters
labelled ``thread=server``, `obs.wall`), and `to_dict()` is
deterministically ordered so a metrics JSON export is byte-identical
across same-seed runs.

`DecisionLog` records why the controllers changed anything: every
λ-multiplier update, per-request `slo_gamma` trim, `balance_gamma` cap
and admission shed/queue/preempt verdict is appended with its inputs, so
feedback behaviour is auditable and testable (tests/test_obs.py checks
the logged values against what the scheduler actually applied).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Tuple

# fixed default buckets (ms-scale quantities dominate; the top bucket is
# +inf by construction — `Histogram.counts` has len(buckets) + 1 cells)
DEFAULT_BUCKETS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0,
                   500.0, 1000.0, 2000.0, 5000.0, 10000.0)


def _label_key(labels: Dict[str, object]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt_name(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


@dataclass
class Counter:
    value: float = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


@dataclass
class Gauge:
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


@dataclass
class Histogram:
    """Fixed-bucket histogram: counts[i] = observations <= buckets[i],
    counts[-1] = overflow; plus sum/count for means."""
    buckets: Tuple[float, ...] = DEFAULT_BUCKETS
    counts: List[int] = field(default_factory=list)
    sum: float = 0.0
    count: int = 0

    def __post_init__(self):
        if not self.counts:
            self.counts = [0] * (len(self.buckets) + 1)

    def observe(self, v: float) -> None:
        self.sum += v
        self.count += 1
        for i, ub in enumerate(self.buckets):
            if v <= ub:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


@dataclass(frozen=True)
class Decision:
    """One controller decision: what changed, when, and the inputs it was
    computed from. `fields` is a sorted (key, value) tuple so the entry
    hashes/compares deterministically and serializes canonically."""
    t_ms: float
    seq: int
    kind: str                    # lam | slo_gamma | balance_gamma |
    #                              gamma_feedback | plan | admission
    fields: Tuple[Tuple[str, object], ...]

    def get(self, key: str, default=None):
        for k, v in self.fields:
            if k == key:
                return v
        return default

    def to_dict(self) -> dict:
        d = {"t_ms": self.t_ms, "seq": self.seq, "kind": self.kind}
        d.update({k: v for k, v in self.fields})
        return d


class DecisionLog:
    def __init__(self, max_entries: int = 0):
        self.max_entries = int(max_entries)
        self.entries: Deque[Decision] = deque(
            maxlen=self.max_entries if self.max_entries > 0 else None)
        self._seq = 0
        self.n_dropped = 0

    def record(self, t_ms: float, kind: str, **fields) -> Decision:
        if self.max_entries > 0 and len(self.entries) == self.max_entries:
            self.n_dropped += 1
        d = Decision(float(t_ms), self._seq, kind,
                     tuple(sorted(fields.items())))
        self._seq += 1
        self.entries.append(d)
        return d

    def by_kind(self, kind: str) -> List[Decision]:
        return [d for d in self.entries if d.kind == kind]

    def __len__(self):
        return len(self.entries)


class MetricsRegistry:
    """Get-or-create registry of counters/gauges/histograms keyed by
    (name, sorted labels), plus the controller decision log."""

    def __init__(self, max_decisions: int = 0):
        self._counters: Dict[tuple, Counter] = {}
        self._gauges: Dict[tuple, Gauge] = {}
        self._histograms: Dict[tuple, Histogram] = {}
        self.decisions = DecisionLog(max_entries=max_decisions)

    # ------------------------------------------------------------- access
    def counter(self, name: str, **labels) -> Counter:
        key = (name, _label_key(labels))
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = Counter()
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        key = (name, _label_key(labels))
        g = self._gauges.get(key)
        if g is None:
            g = self._gauges[key] = Gauge()
        return g

    def histogram(self, name: str, buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        key = (name, _label_key(labels))
        h = self._histograms.get(key)
        if h is None:
            h = self._histograms[key] = Histogram(buckets=buckets)
        return h

    # ---------------------------------------------------------- shorthand
    def inc(self, name: str, v: float = 1.0, **labels) -> None:
        self.counter(name, **labels).inc(v)

    def set_gauge(self, name: str, v: float, **labels) -> None:
        self.gauge(name, **labels).set(v)

    def observe(self, name: str, v: float, **labels) -> None:
        self.histogram(name, **labels).observe(v)

    def value(self, name: str, default: float = 0.0, **labels) -> float:
        """Current counter (or gauge) value; `default` when absent."""
        key = (name, _label_key(labels))
        if key in self._counters:
            return self._counters[key].value
        if key in self._gauges:
            return self._gauges[key].value
        return default

    def label_values(self, name: str, label: str) -> List[str]:
        """Distinct values a label takes for `name` (sorted)."""
        out = set()
        for (n, labels) in list(self._counters) + list(self._gauges):
            if n != name:
                continue
            for k, v in labels:
                if k == label:
                    out.add(v)
        return sorted(out)

    # ------------------------------------------------------------- export
    def to_dict(self) -> dict:
        """Deterministically-ordered flat dict for the metrics JSON."""
        counters = {_fmt_name(n, k): c.value
                    for (n, k), c in sorted(self._counters.items())}
        gauges = {_fmt_name(n, k): g.value
                  for (n, k), g in sorted(self._gauges.items())}
        hists = {}
        for (n, k), h in sorted(self._histograms.items()):
            hists[_fmt_name(n, k)] = {
                "buckets": list(h.buckets), "counts": list(h.counts),
                "sum": h.sum, "count": h.count}
        return {
            "counters": counters, "gauges": gauges, "histograms": hists,
            "decisions": [d.to_dict() for d in self.decisions.entries],
            "decisions_dropped": self.decisions.n_dropped,
        }
