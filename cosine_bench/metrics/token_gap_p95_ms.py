"""95th percentile, by nearest rank, over every output token delivered in
the window after its request's first, of the time since that request's
previous token (tokens of one commit share a stamp: a gap of 0)."""
from cosine_bench.metrics import host_window, nearest_rank


def read(run):
    t0, t1 = host_window(run)
    gaps = [b - a for s in run["sent"]
            for a, b in zip(s.stamps, s.stamps[1:]) if t0 < b <= t1]
    v = nearest_rank(gaps, 0.95)
    return None if v is None else v * 1e3
