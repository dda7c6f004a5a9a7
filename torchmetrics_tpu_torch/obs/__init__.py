"""Runtime telemetry of the port: spans, counters, gauges, histograms and batch lineage.

Counterpart of ``torchmetrics_tpu/obs``, as far as the engine slice needs it:

- :mod:`~torchmetrics_tpu_torch.obs.trace` — span/event ring buffer, counters,
  gauges, duration histograms. **Off by default**: every instrumented call site
  guards on a single module flag, so the unconfigured runtime pays one branch.
- :mod:`~torchmetrics_tpu_torch.obs.lineage` — a stable ``trace_id`` per batch fed
  to a ``MetricPipeline``, a bounded index of per-batch records, and histogram
  exemplars.

The exporters, profiler hooks, cross-host aggregation, memory and cost accounting,
value timelines, alerts, audit, tenant scope and the obs server come with the obs
plane (ROADMAP Queue 1 item 6) and the mux slice.
"""

from torchmetrics_tpu_torch.obs import lineage, trace
from torchmetrics_tpu_torch.obs.trace import (
    TraceRecorder,
    annotate_current_span,
    disable,
    enable,
    event,
    get_recorder,
    inc,
    is_enabled,
    observe,
    observe_duration,
    record_warning,
    set_gauge,
    span,
)

__all__ = [
    "TraceRecorder",
    "annotate_current_span",
    "disable",
    "enable",
    "event",
    "get_recorder",
    "inc",
    "is_enabled",
    "lineage",
    "observe",
    "observe_duration",
    "record_warning",
    "set_gauge",
    "span",
    "trace",
]
