"""The benchmark's yardstick: the H100's peaks, roofline bounds, the work
of an attention call and of a served token, and the reading of a
`torch.profiler` window (device events, the device time of the kernels
launched inside named host ranges, merged busy intervals).

These are the benchmark's own copies. The work and peak arithmetic and
the profiler reading follow `chip_smoke.py` (`_bound`, `_work`,
`_merge`, `profiler_events`, `range_device_us`), so that a change to the
program cannot move the ruler it is measured with. Nothing here imports
the program.
"""
from __future__ import annotations

import bisect
import gc
import time
from typing import NamedTuple

#: NVIDIA H100 SXM5 80GB data sheet, dense rates at the 700 W limit:
#: HBM3 bytes/s, and FLOP/s by operand type. "float32" is the CUDA
#: cores' rate; "float32_exact_tc" the fastest unit that multiplies
#: float32 operands exactly, 3xTF32 on the tensor cores (495 / 3).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float32_exact_tc": 495e12 / 3,
              "bfloat16": 989e12}


def bound_s(nbytes: float, flops: float, rate: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over `rate`."""
    return max(nbytes / HBM_BYTES_PER_S, flops / rate)


def attention_peak(kv_dtype_name: str) -> float:
    """The operations rate an attention call is bounded by, from its K/V
    type alone (so whatever implements it is held to the same): float32
    at the exact tensor-core rate (3xTF32), 16-bit types at theirs, int8
    K/V at the bf16 rate its products run at."""
    if kv_dtype_name == "float32":
        return PEAK_FLOPS["float32_exact_tc"]
    return PEAK_FLOPS["bfloat16"]


def attention_work(torch, q, k, v, q_pos, k_pos, slot_idx=None, mask=None,
                   causal=True, v_in_k=False):
    """(bytes, flops) that one attention read must move and do, as device
    scalars (no host sync): the (query, key) pairs that are valid (key
    held, causal, under the mask) count 2 (Dk + Dv) operations each per
    query head; the K/V rows that hold a key are read once (Dk + Dv
    values, Dk where V is K's first columns), q and the positions once,
    and the partials (m, l, acc) written once. q: (B, T, Hkv, G, Dk);
    k: (P, S, Hkv, Dk), read through `slot_idx` (B,) when given, else
    P = B; k_pos: (P, S), -1 empty."""
    B, T, H, G, Dk = q.shape
    Dv = v.shape[-1]
    kp = k_pos if slot_idx is None else k_pos.index_select(
        0, slot_idx.long())
    held = kp >= 0
    valid = held[:, None, :]
    if causal:
        valid = valid & (kp[:, None, :] <= q_pos[:, :, None])
    if mask is not None:
        valid = valid & mask
    pairs = valid.sum(dtype=torch.float64) * (H * G)
    rows = held.sum(dtype=torch.float64)
    kv_bytes = rows * H * (Dk + (0 if v_in_k else Dv)) * k.element_size()
    other = (q.numel() * q.element_size() + kp.numel() * 4 + q_pos.numel() * 4
             + (0 if mask is None else mask.numel())
             + B * T * H * G * (Dv + 2) * 4)
    return kv_bytes + other, 2.0 * pairs * (Dk + Dv)


def matmul_params_per_token(target: dict) -> int:
    """Weight-matrix parameters one token of the target multiplies
    through: every layer's projections and FFN (a MoE layer: the router,
    its `num_experts_per_tok` routed experts and the shared expert) and
    the output head. `target` is a configuration file's top level (its
    published keys)."""
    d = target["hidden_size"]
    heads = target["num_attention_heads"]
    kv = target["num_key_value_heads"]
    hd = target.get("head_dim") or d // heads
    attn = d * heads * hd * 2 + d * kv * hd * 2
    if target.get("num_experts"):
        ffn = (d * target["num_experts"]
               + target["num_experts_per_tok"] * 3 * d
               * target["moe_intermediate_size"]
               + 3 * d * target.get("shared_expert_intermediate_size", 0))
    else:
        ffn = 3 * d * target["intermediate_size"]
    return target["num_hidden_layers"] * (attn + ffn) + d * target["vocab_size"]


def token_flops(target: dict, context: int) -> float:
    """Operations of one target token whose attention reads `context`
    keys (itself included): 2 per weight parameter it multiplies through,
    plus QK and PV, 2 (Dk + Dv) a key per query head per layer."""
    d = target["hidden_size"]
    heads = target["num_attention_heads"]
    hd = target.get("head_dim") or d // heads
    attn = 2.0 * context * (2 * hd) * heads * target["num_hidden_layers"]
    return 2.0 * matmul_params_per_token(target) + attn


# ---------------------------------------------------------------- profiler

def merge(intervals):
    """Union of (start, end) intervals, as sorted [start, end] lists."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class ProfEvent:
    """One profiler event: name, device type, thread, time range (us from
    the trace's start), its CUPTI correlation id, and for a device event
    the (thread, start) of the host call that launched it."""
    __slots__ = ("name", "device_type", "thread", "time_range", "corr",
                 "launch", "is_async", "annotation")

    def __init__(self, name, device_type, thread, time_range, corr,
                 is_async, annotation):
        self.name, self.device_type = name, device_type
        self.thread, self.time_range = thread, time_range
        self.corr, self.is_async, self.annotation = corr, is_async, annotation
        self.launch = None


class Range(NamedTuple):
    start: float
    end: float


#: host calls of the CUDA runtime and driver that launch device work
LAUNCH_PREFIXES = ("cuda", "cuLaunch", "cuMemcpy", "cuMemset")


def profiler_events(torch, prof):
    """The profiler's events straight from its raw results, without
    `torch.autograd.profiler`'s parse, which builds every event's Python
    object, stack and tree (minutes over ~10^6 events): each event's
    demangled name, device type, thread and time range, and for a device
    event the host call that launched it, found by its CUPTI correlation
    id (the runtime or driver call with the same id), whatever host
    operation or range that call ran in. The host operations' thread ids
    are the profiler's own; a runtime call's system thread id is mapped
    to them through the calls the profiler linked to an operation. The
    garbage collector is off meanwhile. Returns (events sorted by start,
    seconds taken)."""
    was = gc.isenabled()
    gc.disable()
    t0 = time.perf_counter()
    try:
        return _events(torch, prof), time.perf_counter() - t0
    finally:
        if was:
            gc.enable()


def _events(torch, prof):
    from torch.autograd import DeviceType
    from torch.autograd.profiler import _filter_name

    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    raw_events = res.events()
    kinds = type(raw_events[0]) if raw_events else None
    hidden = getattr(kinds, "is_hidden_event", None)
    user = getattr(kinds, "is_user_annotation", None)
    cpu = DeviceType.CPU
    names = {}
    out, ops, linked = [], {}, []
    for k in raw_events:
        raw = k.name()
        if _filter_name(raw) or (hidden is not None and hidden(k)):
            continue
        name = names.get(raw)
        if name is None:
            name = torch._C._demangle(raw) if len(raw) > 1 else raw
            names[raw] = name
        th = k.start_thread_id()
        e = ProfEvent(name, k.device_type(), th,
                      Range((k.start_ns() - t0) / 1e3,
                            (k.end_ns() - t0) / 1e3),
                      k.correlation_id(),
                      k.is_async() or th != k.end_thread_id(),
                      bool(user(k)) if user is not None else False)
        out.append(e)
        link = k.linked_correlation_id()
        if e.device_type == cpu:
            if link > 0:
                linked.append((link, e))
            elif not e.is_async:
                ops[e.corr] = e
    # a runtime call linked to a host operation ran on its thread
    tid = {}
    for link, e in linked:
        op = ops.get(link)
        if op is not None:
            tid[e.thread] = op.thread
    launches = {}
    for e in out:
        if e.device_type == cpu and e.name.startswith(LAUNCH_PREFIXES):
            e.thread = tid.get(e.thread, e.thread)
            launches[e.corr] = e
    for e in out:
        if e.device_type != cpu:
            r = launches.get(e.corr)
            if r is not None:
                e.launch = (r.thread, r.time_range.start)
    out.sort(key=lambda e: (e.time_range.start, -e.time_range.end))
    return out


def device_events(torch, events):
    """The operations that ran on the device (kernels, copies, sets; not
    the profiler's device-side spans of host ranges)."""
    from torch.autograd import DeviceType
    return [e for e in events if e.device_type == DeviceType.CUDA
            and not e.annotation and not e.name.startswith("cosine_bench:")]


def range_device_us(torch, events, range_name, w0=float("-inf"),
                    w1=float("inf")):
    """Device us of the operations launched inside the host ranges named
    `range_name` that start in [w0, w1): an operation counts when the
    host call that launched it began inside such a range on the range's
    own thread. The ranges of one name on one thread do not overlap (the
    harness opens one only around the outermost call). Returns (ranges,
    device us)."""
    from torch.autograd import DeviceType
    spans = {}
    for e in events:
        if (e.device_type == DeviceType.CPU and e.name == range_name
                and w0 <= e.time_range.start < w1):
            spans.setdefault(e.thread, []).append(
                (e.time_range.start, e.time_range.end))
    for s in spans.values():
        s.sort()
    starts = {th: [a for a, _ in s] for th, s in spans.items()}
    inside = 0.0
    for e in device_events(torch, events):
        if e.launch is None or e.launch[0] not in spans:
            continue
        th, t = e.launch
        i = bisect.bisect_right(starts[th], t) - 1
        if i >= 0 and t < spans[th][i][1]:
            inside += e.time_range.end - e.time_range.start
    return sum(len(s) for s in spans.values()), inside
