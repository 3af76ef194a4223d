"""Serving telemetry layer (DESIGN.md §2.6).

Three pieces, all dependency-free and deterministic, and a fourth of
the port's own:

  * `obs.trace`   — `Tracer`: per-request lifecycle + per-stage occupancy
                    spans built from instrumentation hooks in the serving
                    stack (engine / pipeline / cluster / admission).
  * `obs.metrics` — `MetricsRegistry`: counters, gauges and fixed-bucket
                    histograms — the single source behind `ServeStats`'
                    aggregates — plus the controller `DecisionLog`
                    (every λ/γ/admission decision with its inputs).
  * `obs.export`  — Chrome/Perfetto ``trace_event`` JSON export and a
                    flat metrics JSON (byte-identical across same-seed
                    runs), consumed by ``python -m repro_torch.obs.summarize``.
  * `obs.wall`    — `WallTracer` (the engine's tracer): wall spans of the
                    wall-clock backend's two threads (CPU time, parent
                    span, a profiler range each while a profiler
                    records), and the host-read counters.

The wall-clock serve loop (`serving.async_loop.WallClockExecutor` on
`serving.backend.AsyncTorchBackend`) emits the same stage schema from
measured time, so its overlap can be diffed against the discrete-event
executor's prediction.
"""
from repro_torch.obs.metrics import DecisionLog, MetricsRegistry
from repro_torch.obs.trace import Span, Tracer

__all__ = ["DecisionLog", "MetricsRegistry", "Span", "Tracer"]
