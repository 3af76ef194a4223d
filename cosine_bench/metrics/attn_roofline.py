"""The attention calls' share of their roofline in the profiled stretch:
the sum over the model-side calls that hand work to the attention
kernels (`models.attention.attend_partial`, `cache_partial`,
`blocked_attention`) of each call's bound (the larger of its bytes over
3.35 TB/s and its operations over the rate of its K/V type, reckoned
from its arguments: `yardstick.attention_work`) over the device time of
the kernels launched inside those calls."""


def read(run):
    p = run.get("profile") or {}
    if not p.get("attn_calls") or not p.get("attn_device_s"):
        return None
    return 100.0 * p["attn_bound_s"] / p["attn_device_s"]
