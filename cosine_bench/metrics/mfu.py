"""The target model's operations on the tokens served in the profiled
stretch (prompt tokens prefilled, output tokens delivered: 2 per weight
parameter a token multiplies through, a MoE layer's routed and shared
experts only, plus attention over its context; `yardstick.token_flops`)
over the stretch's length times the H100's float32 peak, 67 TFLOP/s: the
configurations multiply float32 weights with TF32 off."""
from cosine_bench import yardstick


def read(run):
    p = run.get("profile") or {}
    if "busy_s" not in p:
        return None
    return 100.0 * p["served_flops"] / (p["window_s"]
                                        * yardstick.PEAK_FLOPS["float32"])
