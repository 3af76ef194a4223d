"""One reader a metric: `metrics/<name>.py` defines `read(run)`, which
returns the metric's value from the run's record, or None where the run
holds nothing to read.

A run's record (`serve.Cell.run`) holds the window [`t_open`,
`t_close`] (perf_counter seconds), the requests (`sent`: send time,
delivery stamps, tokens), the engine's iteration records and the
verification server's timeline spans, the memory peak and, with
tracing, the profiled stretch (`profile`), which covers the window's
last iterations from `host_t1` on. The readers of host-side per-layer
metrics take [`t_open`, `host_t1`], which leaves the profiled stretch,
slowed by the profiler, out; without tracing `host_t1` is `t_close`."""
import math


def host_window(run):
    """(t0, t1) of the window that host-side per-layer readers take."""
    return run["t_open"], run.get("host_t1", run["t_close"])


def records(run):
    """The engine's iteration records that ended in `host_window`."""
    t0, t1 = host_window(run)
    return [r for r in run["records"] if t0 < r.get("t1", t0 + 1e-9) <= t1]


def spans(run, kind):
    """The server's spans of `kind` that began in `host_window`."""
    t0, t1 = host_window(run)
    return [s for s in run["timeline"] if s["kind"] == kind
            and t0 <= s["t0"] < t1]


def nearest_rank(values, q: float):
    """The q-th quantile (0 < q <= 1) by nearest rank: the smallest value
    with at least q of the values at or below it; None for no values.
    Infinite values (failed requests) sort last."""
    if not values:
        return None
    v = sorted(values)
    return v[max(math.ceil(q * len(v)) - 1, 0)]
