"""Output tokens delivered in the window, by the harness's stamp at
delivery, over the window's seconds."""


def read(run):
    t0, t1 = run["t_open"], run["t_close"]
    n = sum(1 for s in run["sent"] for t in s.stamps if t0 < t <= t1)
    return n / (t1 - t0)
