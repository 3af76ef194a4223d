"""Share of the window the verification server spent waiting for drafts:
the sum of the window's `IterationRecord.verify_idle_ms` (the wall gap
before each verification, less the server's other tasks and arrival
lulls) over the window's length."""
from cosine_bench.metrics import host_window, records


def read(run):
    recs = records(run)
    if not recs:
        return None
    t0, t1 = host_window(run)
    return 100.0 * sum(r["verify_idle_ms"] for r in recs) / ((t1 - t0) * 1e3)
