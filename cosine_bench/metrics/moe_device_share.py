"""Share of the profiled stretch's device busy time taken by the kernels
launched inside the MoE layers (`models.moe.apply_moe`, wrapped in a
profiler range by the harness)."""


def read(run):
    p = run.get("profile") or {}
    if not p.get("moe_calls") or not p.get("busy_s"):
        return None
    return 100.0 * p["moe_device_s"] / p["busy_s"]
