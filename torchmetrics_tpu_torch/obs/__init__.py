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
- :mod:`~torchmetrics_tpu_torch.obs.cost` — the cost ledger: every captured variant's
  counted flops, bytes accessed and memory, its capture seconds and dispatch count,
  rolled up into per-metric per-step estimated cost; the admission plane of
  :mod:`~torchmetrics_tpu_torch.obs.scope` prices tenants by it.
  ``python -m torchmetrics_tpu_torch.obs.cost`` prints the ledger table.

- :mod:`~torchmetrics_tpu_torch.obs.export` — JSONL sink, Prometheus/OpenMetrics
  text, summary table; all also surface the per-metric robustness counters
  (``updates_ok`` / ``updates_skipped`` / ``updates_quarantined`` /
  ``quarantine_dropped`` / ``sync_degraded``).
- :mod:`~torchmetrics_tpu_torch.obs.memory` — state-memory accounting: per-metric
  footprints with alias dedup, ``torch.cuda.memory_stats`` polling, ``memory.*``
  gauges.
- :mod:`~torchmetrics_tpu_torch.obs.hostprof` — the host-path sampling profiler and
  its seam attribution (the Python-floor report).
- :mod:`~torchmetrics_tpu_torch.obs.profile` — guarded ``torch.profiler`` sessions;
  while one is live the runtime's ``<Class>.update``/``.compute``/``.sync`` ranges
  attribute device kernels to metric class names.
- :mod:`~torchmetrics_tpu_torch.obs.perfetto` — Chrome trace-event JSON of the span
  ring buffer (one pid per rank, lineage flow events, counter tracks).
- :mod:`~torchmetrics_tpu_torch.obs.aggregate` — cross-rank merge of rank-aware
  snapshots over the guarded collectives; a hung rank degrades to a loud partial
  aggregate instead of a hang.
- :mod:`~torchmetrics_tpu_torch.obs.audit` — the conservation audit plane: per
  tenant and session the flow ledger ``fed = processed + shed + deferred_pending +
  quarantined + skipped + in_flight`` and its exactly-once invariants, with an
  offline checkpoint-stream CLI (``python -m torchmetrics_tpu_torch.obs.audit``).

The fleet sampler, the regression sentinel and the obs server (``obs/{fleet,regress,
serve,server}.py``) come with a later slice (ROADMAP Queue 1 item 4).
"""

# note: `obs.aggregate` stays the *submodule* (its entry point is
# `obs.aggregate.aggregate()`); only the clash-free helper names are re-exported
from torchmetrics_tpu_torch.obs import (
    aggregate,
    alerts,
    audit,
    cost,
    export,
    hostprof,
    lineage,
    memory,
    perfetto,
    profile,
    scope,
    trace,
    values,
)
from torchmetrics_tpu_torch.obs.aggregate import host_snapshot, merge_snapshots
from torchmetrics_tpu_torch.obs.alerts import AlertEngine, AlertRule
from torchmetrics_tpu_torch.obs.audit import ConservationAuditor
from torchmetrics_tpu_torch.obs.cost import get_ledger as cost_ledger
from torchmetrics_tpu_torch.obs.export import collect, prometheus_text, summary, write_jsonl
from torchmetrics_tpu_torch.obs.hostprof import HostProfiler
from torchmetrics_tpu_torch.obs.memory import device_memory_stats, footprint, record_gauges
from torchmetrics_tpu_torch.obs.perfetto import chrome_trace, write_trace
from torchmetrics_tpu_torch.obs.profile import (
    annotate,
    profile_session,
    profile_trace,
    start_trace,
    stop_trace,
)
from torchmetrics_tpu_torch.obs.scope import TenantRegistry
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
    "AlertEngine",
    "AlertRule",
    "ConservationAuditor",
    "HostProfiler",
    "TenantRegistry",
    "TraceRecorder",
    "aggregate",
    "alerts",
    "annotate",
    "annotate_current_span",
    "audit",
    "chrome_trace",
    "collect",
    "cost",
    "cost_ledger",
    "device_memory_stats",
    "disable",
    "enable",
    "event",
    "export",
    "footprint",
    "get_recorder",
    "host_snapshot",
    "hostprof",
    "inc",
    "is_enabled",
    "lineage",
    "memory",
    "merge_snapshots",
    "observe",
    "observe_duration",
    "perfetto",
    "profile",
    "profile_session",
    "profile_trace",
    "prometheus_text",
    "record_gauges",
    "record_warning",
    "scope",
    "set_gauge",
    "span",
    "start_trace",
    "stop_trace",
    "summary",
    "trace",
    "values",
    "write_jsonl",
    "write_trace",
]
