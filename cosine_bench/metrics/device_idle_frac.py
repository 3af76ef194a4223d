"""Share of the profiled stretch in which no operation ran on the device
(the union of its kernels, copies and sets, from the profiler's trace)."""


def read(run):
    p = run.get("profile") or {}
    if "busy_s" not in p:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
