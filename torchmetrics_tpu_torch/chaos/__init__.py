"""Traffic-replay chaos bench: production as a measured, SLO-judged scenario.

Three parts, composed by ``chip_smoke.py``'s ``chaos_eval`` (as the JAX package's
``bench.py --chaos`` composes its own) and usable standalone:

- :mod:`~torchmetrics_tpu_torch.chaos.schedule` — a seeded, deterministic traffic
  schedule (many tenants, mixed shapes, bursts, poisoned batches, a hung
  host) with a schema-versioned JSONL record/load format.
- :mod:`~torchmetrics_tpu_torch.chaos.replay` — the driver: the schedule through
  per-tenant :class:`~torchmetrics_tpu_torch.engine.pipeline.MetricPipeline`
  sessions — or, with ``ReplayConfig.multiplex``, through ONE cross-tenant
  :class:`~torchmetrics_tpu_torch.engine.mux.TenantMultiplexer` — while a
  background thread scrapes the live obs server.
- :mod:`~torchmetrics_tpu_torch.chaos.slo` — the declarative SLO spec + judge:
  throughput, p95/p99 scrape latency, time-to-fire/time-to-resolve for the
  injected faults, compiled-variant churn, flight-dump correctness — emitted
  as bench configs so the regression sentinel gates them like perf numbers.

    from torchmetrics_tpu_torch import chaos

    sched = chaos.generate(chaos.ScheduleConfig(seed=0, tenants=8))
    report = chaos.judge(chaos.replay(sched))  # ReplayConfig(device="cpu") without a card
    print(chaos.format_report(report))
"""

from torchmetrics_tpu_torch.chaos.schedule import (
    SCHEDULE_SCHEMA,
    ScheduleConfig,
    ScheduleError,
    TrafficSchedule,
    flash_crowd_config,
    generate,
    high_tenant_config,
    load,
    loads,
    skewed_load_config,
)
from torchmetrics_tpu_torch.chaos.replay import ReplayConfig, ReplayError, replay
from torchmetrics_tpu_torch.chaos.slo import (
    SLOSpec,
    flash_crowd_slo_spec,
    format_report,
    high_tenant_slo_spec,
    host_crash_slo_spec,
    hung_host_slo_spec,
    judge,
    rolling_deploy_slo_spec,
    skewed_load_slo_spec,
)

__all__ = [
    "SCHEDULE_SCHEMA",
    "ReplayConfig",
    "ReplayError",
    "SLOSpec",
    "ScheduleConfig",
    "ScheduleError",
    "TrafficSchedule",
    "flash_crowd_config",
    "flash_crowd_slo_spec",
    "format_report",
    "generate",
    "high_tenant_config",
    "high_tenant_slo_spec",
    "host_crash_slo_spec",
    "hung_host_slo_spec",
    "judge",
    "load",
    "loads",
    "replay",
    "rolling_deploy_slo_spec",
    "skewed_load_config",
    "skewed_load_slo_spec",
]
