"""Serving telemetry layer (DESIGN.md §2.6).

Three pieces, all dependency-free and deterministic:

  * `obs.trace`   — `Tracer`: per-request lifecycle + per-stage occupancy
                    spans built from instrumentation hooks in the serving
                    stack (engine / pipeline / cluster / admission).
  * `obs.metrics` — `MetricsRegistry`: counters, gauges and fixed-bucket
                    histograms — the single source behind `ServeStats`'
                    aggregates — plus the controller `DecisionLog`
                    (every λ/γ/admission decision with its inputs).
  * `obs.export`  — Chrome/Perfetto ``trace_event`` JSON export and a
                    flat metrics JSON (byte-identical across same-seed
                    runs), consumed by ``python -m repro.obs.summarize``.

The span schema is the contract the future async wall-clock serve loop
must emit, so its measured overlap can be diffed against the
discrete-event executor's prediction (ROADMAP headline item).
"""
from repro_torch.obs.metrics import DecisionLog, MetricsRegistry
from repro_torch.obs.trace import Span, Tracer

__all__ = ["DecisionLog", "MetricsRegistry", "Span", "Tracer"]
