"""The program's own profiler ranges (`repro_torch: <span>`, opened by its
wall spans while a profiler records) under the harness's profiler, on
the CPU: they are user annotations, so `yardstick.device_events` leaves
them out and the device readers (`device_idle_frac`, `mfu`,
`attn_roofline`, `moe_device_share`) read the same device operations as
without them; and `yardstick.range_device_us` finds them by name, one
range a `draft.step` span."""
import numpy as np
import torch

from cosine_bench import serve, spec, yardstick
from tiny import ROOT, bench


def _served_under_the_harness_profiler(family):
    b = bench(family)
    conf = spec.config(b, spec.cell(b, "tiny.t4"), ROOT)
    eng = serve.build_engine(torch, conf, 5, "cpu")
    rng = np.random.default_rng(5)
    for _ in range(2):
        eng.submit(rng.integers(1, conf["vocab_size"], 12).tolist(),
                   max_new_tokens=4, arrival_ms=eng.backend.now_ms())
    tracing = serve.Tracing(torch, eng, conf, "cpu")
    try:
        with eng.backend.engine_stream():
            eng.step()
            tracing.start()
            eng.step()
            tracing.stop()
    finally:
        eng.backend.shutdown()
    events, _ = yardstick.profiler_events(torch, tracing.prof)
    return eng, events


def test_program_ranges_are_annotations_left_out_of_device_events():
    eng, events = _served_under_the_harness_profiler("moe")
    ours = [e for e in events if e.name.startswith("repro_torch: ")]
    names = {e.name for e in ours}
    assert {"repro_torch: iteration", "repro_torch: draft.step",
            "repro_torch: verify.launch"} <= names
    # the server thread's ranges are recorded too (all threads profiled)
    assert len({e.thread for e in ours}) == 2
    assert all(e.annotation for e in ours)
    dev = yardstick.device_events(torch, events)
    assert not any(e.name.startswith("repro_torch: ") for e in dev)
    n, us = yardstick.range_device_us(torch, events,
                                      "repro_torch: draft.step")
    steps = [s for s in eng.tracer.wall_spans() if s.name == "draft.step"]
    assert n == sum(1 for e in ours if e.name == "repro_torch: draft.step")
    assert 0 < n <= len(steps) and us == 0.0
