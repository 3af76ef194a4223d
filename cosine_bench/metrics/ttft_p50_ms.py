"""Median, by nearest rank, over the requests sent in the window, of the
first token's delivery time minus the send time; a request still waiting
at the close counts its wait so far, a failed one counts as infinite."""
from cosine_bench.metrics import nearest_rank


def read(run):
    t0, t1 = run["t_open"], run["t_close"]
    waits = []
    for s in run["sent"]:
        if not t0 <= s.sent < t1:
            continue
        if s.failed:
            waits.append(float("inf"))
        elif s.stamps and s.stamps[0] <= t1:
            waits.append(s.stamps[0] - s.sent)
        else:
            waits.append(t1 - s.sent)
    v = nearest_rank(waits, 0.5)
    return None if v is None else v * 1e3
