"""Runtime telemetry of the port: spans, counters, gauges, histograms and batch lineage.

Counterpart of ``torchmetrics_tpu/obs``, as far as the engine slice needs it:

- :mod:`~torchmetrics_tpu_torch.obs.trace` — span/event ring buffer, counters,
  gauges, duration histograms. **Off by default**: every instrumented call site
  guards on a single module flag, so the unconfigured runtime pays one branch.
- :mod:`~torchmetrics_tpu_torch.obs.lineage` — a stable ``trace_id`` per batch fed
  to a ``MetricPipeline``, a bounded index of per-batch records, and histogram
  exemplars.
- :mod:`~torchmetrics_tpu_torch.obs.scope` — tenant/session attribution: a
  contextvar ``scope(tenant)``, the bounded tenant registry, and the migration,
  checkpoint, lease and fence notes of the session engine.
- :mod:`~torchmetrics_tpu_torch.obs.values` and
  :mod:`~torchmetrics_tpu_torch.obs.alerts` — per-metric value timelines and the
  declarative watchdogs over them.

The exporters, profiler hooks, cross-host aggregation, memory and cost accounting,
the audit plane and the obs server come with the obs plane (ROADMAP Queue 1 item 4)
and the multiplexer slice.
"""

from torchmetrics_tpu_torch.obs import alerts, lineage, scope, trace, values
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
    "alerts",
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
    "scope",
    "set_gauge",
    "span",
    "trace",
    "values",
]
