"""Telemetry egress: JSONL sink, Prometheus text exposition, summary table.

Counterpart of ``torchmetrics_tpu/obs/export.py``: the same series names (under the
same ``tm_tpu_`` prefix), the same text; the HELP lines name this package, and
``build_info`` carries torch's version where JAX's carries jax's.

All three exporters read the same :class:`~torchmetrics_tpu_torch.obs.trace.TraceRecorder`
snapshot and, when given live metric objects, also surface the PR-1 robustness
counters (``updates_ok`` / ``updates_skipped`` / ``updates_quarantined`` /
``quarantine_dropped`` / ``sync_degraded``) that previously had no export path.

Pure stdlib — importable (and usable for the robust counters) even where torch is
not imported.
"""

from __future__ import annotations

import json
import math
import sys
from typing import Any, Dict, IO, Iterable, List, Optional, Tuple, Union

import torchmetrics_tpu_torch.obs.trace as trace
from torchmetrics_tpu_torch.utils.fileio import atomic_write_text

__all__ = [
    "OPENMETRICS_CONTENT_TYPE",
    "PROMETHEUS_CONTENT_TYPE",
    "build_info",
    "collect",
    "filter_tenant",
    "histogram_quantile",
    "openmetrics_text",
    "prometheus_text",
    "quantile_bucket",
    "summary",
    "write_jsonl",
]

# every exported series is namespaced; dots in internal names become underscores
_PROM_PREFIX = "tm_tpu_"

# the two negotiated exposition flavors the obs server serves on /metrics:
# classic text (the default — strict 0.0.4, byte-stable, exemplar-free) and
# OpenMetrics (opt-in via the Accept header — same series, plus histogram
# EXEMPLARS in `# {trace_id="..."}` syntax and a terminating `# EOF`)
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
OPENMETRICS_CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"

_ROBUST_COUNTERS = ("updates_ok", "updates_skipped", "updates_quarantined", "quarantine_dropped")
_ROBUST_FLAGS = ("sync_degraded", "last_update_ok")


def _robust_snapshot(metrics: Iterable[Any]) -> List[Dict[str, Any]]:
    """Duck-typed robustness-counter rows for any objects exposing them.

    Each row carries an ``instance`` ordinal (the metric's position in the
    input iterable): two metrics of the same class (train/val accuracy) must
    not collapse into duplicate Prometheus series — a scraper rejects the
    whole page on a duplicate name+labelset.
    """
    rows = []
    for index, metric in enumerate(metrics):
        if not hasattr(metric, "updates_ok"):
            continue
        row: Dict[str, Any] = {"metric": type(metric).__name__, "instance": index}
        tenant = getattr(metric, "_obs_tenant", None)
        if tenant:
            row["tenant"] = str(tenant)
        for name in _ROBUST_COUNTERS:
            row[name] = int(getattr(metric, name, 0))
        for name in _ROBUST_FLAGS:
            row[name] = bool(getattr(metric, name, False))
        row["update_count"] = int(getattr(metric, "update_count", 0))
        rows.append(row)
    return rows


def build_info() -> Dict[str, str]:
    """Identity labels of this process's build — the ``tm_tpu_build_info`` gauge.

    Follows the node-exporter convention: a constant ``1`` gauge whose labels
    carry the versions, so dashboards can join fleet series against build
    identity. torch facts are probed lazily and safely: version only when torch
    is already imported, backend ``cuda`` only when CUDA is already initialised
    (exporting telemetry must never be the thing that initialises it — the
    ``trace._host_meta`` contract), else ``cpu``.
    """
    try:
        from torchmetrics_tpu_torch import __version__ as version
    except Exception:  # pragma: no cover - partial installs
        version = "unknown"
    torch_version = "not-imported"
    backend = "uninitialized"
    torch_mod = sys.modules.get("torch")
    if torch_mod is not None:
        torch_version = str(getattr(torch_mod, "__version__", "unknown"))
        try:
            backend = "cuda" if torch_mod.cuda.is_initialized() else "cpu"
        except Exception:  # a partial torch: stay at "uninitialized"
            pass
    return {
        "version": str(version),
        "torch": torch_version,
        "backend": backend,
        "process_index": str(trace._host_meta()["process_index"]),
    }


def filter_tenant(snap: Dict[str, Any], tenant: str) -> Dict[str, Any]:
    """Project a snapshot onto one tenant's series, in place.

    Keeps only counters/gauges/histograms labeled ``tenant=<tenant>``, events
    whose attrs carry it, robust rows of metrics registered under it, and (when
    present) that tenant's registry row — the ``?tenant=`` scoped view. Meta
    fields (host identity, build info, dropped-event counts) stay: a scoped
    page is still a page about *this* process.
    """
    for kind in ("counters", "gauges", "histograms"):
        snap[kind] = [row for row in snap.get(kind, ()) if row["labels"].get("tenant") == tenant]
    snap["events"] = [
        ev for ev in snap.get("events", ()) if (ev.get("attrs") or {}).get("tenant") == tenant
    ]
    if "robust" in snap:
        snap["robust"] = [row for row in snap["robust"] if row.get("tenant") == tenant]
    if "tenants" in snap:
        snap["tenants"] = [row for row in snap["tenants"] if row.get("tenant") == tenant]
    if "alerts" in snap:
        snap["alerts"] = [row for row in snap["alerts"] if row.get("tenant") == tenant]
    snap["tenant_filter"] = tenant
    return snap


def collect(
    metrics: Iterable[Any] = (),
    recorder: Optional[trace.TraceRecorder] = None,
    tenant: Optional[str] = None,
) -> Dict[str, Any]:
    """One plain-data snapshot: recorder state + per-metric robust counters.

    ``tenant`` scopes the snapshot to one tenant's series (see
    :func:`filter_tenant`).
    """
    rec = recorder if recorder is not None else trace.get_recorder()
    snap = rec.snapshot()
    snap["robust"] = _robust_snapshot(metrics)
    snap["build_info"] = build_info()
    if tenant is not None:
        filter_tenant(snap, tenant)
    return snap


# ------------------------------------------------------------------------- JSONL


def write_jsonl(
    sink: Union[str, IO[str]],
    metrics: Iterable[Any] = (),
    recorder: Optional[trace.TraceRecorder] = None,
) -> int:
    """Write the full snapshot as JSON Lines; returns the number of lines.

    Line types (``"type"`` field): ``meta`` (one, first), then every ``span`` /
    ``event`` / ``warning`` in ring-buffer order, then ``counter`` / ``gauge`` /
    ``histogram`` series, then one ``robust`` line per metric. Writing to a
    path is atomic (temp file + rename): a crash mid-export never leaves a
    truncated JSONL masquerading as a complete one.
    """
    snap = collect(metrics, recorder)
    lines: List[str] = []

    def emit(obj: Dict[str, Any]) -> None:
        lines.append(json.dumps(obj, sort_keys=True, default=str))

    emit(
        {
            "type": "meta",
            "schema_version": snap["schema_version"],
            "process_index": snap["host"]["process_index"],
            "host_id": snap["host"]["host_id"],
            "wall_clock_anchor": snap["wall_clock_anchor"],
            "dropped_events": snap["dropped_events"],
            "events": len(snap["events"]),
            "build_info": snap["build_info"],
        }
    )
    for ev in snap["events"]:
        # attrs stay namespaced: event attrs are free-form user data and must
        # not clobber the structural type/name/ts/dur fields
        record = {"type": ev["kind"], "name": ev["name"], "ts": round(ev["ts"], 6), "attrs": ev["attrs"]}
        if "dur" in ev:
            record["dur"] = round(ev["dur"], 6)
            record["depth"] = ev["depth"]
        emit(record)
    for counter in snap["counters"]:
        emit({"type": "counter", **counter})
    for gauge in snap["gauges"]:
        emit({"type": "gauge", **gauge})
    for hist in snap["histograms"]:
        emit(
            {
                "type": "histogram",
                "name": hist["name"],
                "labels": hist["labels"],
                "buckets": [[("inf" if math.isinf(b) else b), c] for b, c in hist["buckets"]],
                "sum": round(hist["sum"], 6),
                "count": hist["count"],
            }
        )
    for row in snap["robust"]:
        emit({"type": "robust", **row})

    text = "\n".join(lines) + "\n"
    if isinstance(sink, str):
        atomic_write_text(sink, text)
    else:
        sink.write(text)
    return len(lines)


# -------------------------------------------------------------------- Prometheus


def _prom_name(name: str) -> str:
    return _PROM_PREFIX + "".join(c if (c.isalnum() or c == "_") else "_" for c in name)


def _prom_escape(value: Any) -> str:
    # text-format spec: backslash, double-quote and newline must be escaped in
    # label values; labels are public API so any string can arrive here
    return str(value).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _prom_labels(labels: Dict[str, Any]) -> str:
    if not labels:
        return ""
    body = ",".join(f'{key}="{_prom_escape(value)}"' for key, value in sorted(labels.items()))
    return "{" + body + "}"


def _prom_value(value: float) -> str:
    value = float(value)
    if value.is_integer():
        return str(int(value))
    return repr(value)


def _prom_help_escape(text: str) -> str:
    # text-format spec: only backslash and newline are escaped in HELP text
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _prom_header(out: List[str], prom: str, kind: str, help_text: str) -> None:
    """Well-formed family header: one ``# HELP`` then one ``# TYPE`` line."""
    out.append(f"# HELP {prom} {_prom_help_escape(help_text)}")
    out.append(f"# TYPE {prom} {kind}")


# specific HELP text for the memory-accounting gauge families (obs/memory.py);
# everything else gets the generic last-recorded-value wording below
_GAUGE_HELP = {
    "memory.state_bytes": "Unique accumulated metric-state bytes (children included, aliased buffers deduped)",
    "memory.state_device_bytes": "Device-resident share of the unique metric-state bytes (incl. MaskedBuffer capacity)",
    "memory.state_host_bytes": "Host-resident share of the unique metric-state bytes (compute_on_cpu list items, defaults, quarantine)",
    "state.list_items": "Ragged list-state items currently held (grows unbounded without compute+reset)",
    "memory.device_bytes_in_use": "torch.cuda.memory_stats() allocated_bytes.all.current (absent without a CUDA device)",
    "memory.device_peak_bytes_in_use": "torch.cuda.memory_stats() allocated_bytes.all.peak (absent without a CUDA device)",
    "memory.snapshot_payload_bytes": "Bytes of the last cross-host telemetry snapshot shipped by this host",
    "engine.queue_depth": "Batches accumulated in the streaming engine's open fusion chunk",
    "engine.in_flight": "Dispatched-but-unawaited chunks in the streaming engine's async window",
    "engine.fused_chunk_size": "Batch count of the streaming engine's last fused scan dispatch",
    # cost-ledger families (obs/cost.py): per-metric-class rollups of what
    # the compiled programs are estimated to cost vs what they measurably achieve
    "cost.compiled_variants": "Captured variants in the cost ledger for this metric class",
    "cost.compile_seconds": "Summed capture wall-seconds the metric class's variants cost",
    "cost.flops_per_dispatch": "Estimated flops per dispatch (dispatch-weighted mean over the class's compiled variants)",
    "cost.bytes_per_dispatch": "Estimated bytes accessed per dispatch (dispatch-weighted mean over the class's compiled variants)",
    "cost.estimated_flops": "Cumulative estimated flops dispatched (per-variant counted cost x dispatch count)",
    "cost.estimated_bytes": "Cumulative estimated bytes accessed (per-variant counted cost x dispatch count)",
    "cost.peak_memory_bytes": "Max argument+output+temp bytes any of the class's compiled variants holds live at once",
    "cost.achieved_flops_per_second": "Estimated flops divided by measured update/dispatch span seconds",
    "flight.records": "Per-batch lineage records currently held in the pipeline flight-recorder ring",
    # value-health + alerting families (obs/values.py, obs/alerts.py)
    "value.current": "Latest computed metric value per scalar leaf (the value-health timeline's head)",
    "alerts": "ALERTS-style series: 1 while the named alert is pending/firing, 0 on resolve",
    "alerts.firing": "Alerts currently in the firing state",
    "alerts.pending": "Alerts currently dwelling in the pending state (for_seconds not yet met)",
    "alerts.time_to_fire_seconds": "Latest episode's pending-to-firing wall delta for this (rule, series)",
    "alerts.time_to_resolve_seconds": "Latest episode's firing-to-resolved wall delta for this (rule, series)",
    # tenant/session attribution families (obs/scope.py): bounded-cardinality
    # per-tenant liveness, with the overflow bucket loud by design
    "tenant.updates": "Metric updates billed to this tenant (ambient scope or captured attribution)",
    "tenant.computes": "Fresh metric computes billed to this tenant",
    "tenant.active_pipelines": "Live MetricPipeline sessions currently registered under this tenant",
    "tenant.series": "Recorder series (counters+gauges+histograms) carrying this tenant's label",
    "tenant.last_activity_age_seconds": "Wall-clock seconds since this tenant's last recorded activity",
    "tenant.registered": "Tenants currently in the bounded tenant registry (cap: max_tenants)",
    "tenant.overflow_collapsed": "Distinct past-cap tenant names collapsed into the __overflow__ bucket",
    # cost-aware admission families (obs/scope.py AdmissionController): quota
    # pressure per tenant, with tenant.quota_exceeded the AlertRule-compatible
    # 0/1 signal (threshold series rules turn it into a firing alert)
    "tenant.quota_exceeded": "1 while the tenant's current window burn is at/over a quota limit, 0 otherwise",
    "tenant.quota_burn_ratio": "Max used/limit ratio across the tenant's metered quota dimensions this window",
    "tenant.quota_shed": "Lifetime update batches dropped for this tenant by over-quota shed decisions",
    "tenant.quota_deferred": "Lifetime update batches deprioritized for this tenant by over-quota defer decisions",
    "tenant.quota_window_updates": "Update batches admitted for this tenant in the current quota window",
    "tenant.quota_window_flops": "Estimated flops billed to this tenant in the current quota window (cost-ledger priced)",
    "tenant.quota_window_bytes": "Estimated bytes-accessed billed to this tenant in the current quota window",
    "tenant.quota_window_compile_seconds": "Capture wall-seconds billed to this tenant in the current quota window",
    "tenant.quota_priority": "Admission priority class of this tenant's quota (higher drains first from deferred backlogs)",
    # cross-tenant multiplexer families (engine/mux.py): one fused vmap
    # dispatch folds many tenants' same-signature updates
    "engine.mux_width": "Tenant count of the multiplexer's last fused dispatch (pre-padding)",
    "engine.mux_open_groups": "Same-signature tenant groups currently accumulating in the multiplexer",
    # continuous-checkpointing families (engine/migrate.py CheckpointPolicy):
    # crash-recovery liveness per tenant session, refreshed per scrape
    "checkpoint.last_success_age_seconds": "Wall-clock seconds since the tenant session's last successful periodic bundle",
    "checkpoint.write_seconds": "Wall seconds the last continuous-checkpoint bundle write took",
    "checkpoint.bundle_bytes": "Mean bundle bytes per checkpoint kind (full vs delta) for this tenant session",
    "checkpoint.bundles": "Continuous-checkpoint bundles written per kind (full vs delta)",
    "checkpoint.failures": "Continuous-checkpoint writes that failed (stream kept flowing; staleness grows)",
    # batch-lineage index families (obs/lineage.py): the bounded trace-id
    # index's cardinality, measured — eviction is visible, never silent
    "lineage.traces": "Live per-batch lineage records in the bounded trace-id index",
    "lineage.evicted": "Lineage records evicted from the bounded trace-id index (oldest-first)",
    "lineage.minted": "Trace ids minted by this process since the index was last reset",
    # hung-host fencing families (robust/fence.py + engine/migrate.py): session
    # leases, the fence ledger, and what recovery scans reject along the way
    "lease.seconds_to_expiry": "Seconds until this tenant session's lease expires (negative: expired, holder suspect)",
    "lease.active": "Unreleased session leases this process currently tracks",
    "lease.expired": "Leases past expiry that are neither released nor fenced (the watchdog's pending work)",
    "fence.fenced_epochs": "Session epochs fenced off as zombies (each one is a completed or pending failover)",
    "fence.bundles_rejected": "Post-fence zombie bundle writes rejected by recovery scans (counted, never restored)",
    "fence.bundles_swept": "Post-fence zombie bundles garbage-collected from disk by retention sweeps",
    "fence.failover_yielded": "Failovers this process stood down from after losing the durable claim-file election",
    "checkpoint.torn_bundles": "Torn/corrupt checkpoint bundles recovery scans skipped while selecting a restore point",
    # fleet telemetry plane families (obs/fleet.py): continuous cross-host
    # sampling, rate derivation from consecutive samples, and skew signals
    "fleet.hosts": "Hosts contributing to the newest merged fleet sample",
    "fleet.missing_hosts": "Hosts absent from the newest fleet sample (hung or unreachable; degraded, not stalled)",
    "fleet.degraded": "1 while the newest fleet sample is a degraded partial view, 0 when every host reported",
    "fleet.samples": "Fleet samples currently retained in the bounded drop-oldest ring",
    "fleet.degraded_samples": "Fleet samples taken degraded (partial gather) since the sampler was constructed",
    "fleet.sample_age_seconds": "Seconds since the fleet sampler last completed a sample (staleness of the view)",
    "fleet.imbalance": "Normalized fleet load-imbalance coefficient: 0 perfectly even, 1 all load on one host",
    "fleet.host_ratio": "Hottest-host load divided by coldest-host load (absent while the coldest host is idle)",
    "fleet.host_load_share": "This host's fraction of the fleet's update rate over the newest sample window",
    "fleet.host_updates_per_second": "Metric updates per second attributed to this host over the newest sample window",
    "fleet.updates_per_second": "Metric updates per second over the newest sample window (fleet total, or per tenant)",
    "fleet.computes_per_second": "Fresh metric computes per second over the newest sample window (fleet total, or per tenant)",
    "fleet.flop_burn_per_second": "Estimated cost-ledger flops per second burned fleet-wide over the newest sample window",
    "fleet.byte_burn_per_second": "Estimated cost-ledger bytes-accessed per second fleet-wide over the newest sample window",
    "fleet.checkpoint_bytes_per_second": "Checkpoint bundle bytes written per second over the newest sample window",
    # continuous host-profiler families (obs/hostprof.py): the Python-floor
    # attribution plane — all gauges (point-in-time sampler state), never _total
    "hostprof.samples": "Host stack samples taken and attributed (serving/scrape-thread samples excluded)",
    "hostprof.samples_serving": "Host stack samples landing in obs-server scrape threads (never billed to a tenant seam)",
    "hostprof.dropped_stacks": "Distinct collapsed stacks refused past the bounded stack-table cap",
    "hostprof.sample_errors": "Sampler iterations that raised and were swallowed (the sampler never kills the run)",
    "hostprof.rate_hz": "Configured host-profiler sampling rate in Hz",
    "hostprof.self_overhead_percent": "Measured sampler busy time as a percent of profiled wall time",
    "hostprof.attributed_percent": "Percent of attributable host samples landing in a named runtime seam (not 'other')",
    "hostprof.seam_seconds": "Sampled host seconds attributed to the labeled runtime seam",
    # conservation-audit families (obs/audit.py): the exactly-once accounting
    # plane — all gauges (point-in-time ledger state), never _total
    "audit.sessions": "Pipeline/mux sessions the conservation auditor is tracking (live + frozen)",
    "audit.approximate": "1 when the ledger is honest-approximate (lineage or fold-id eviction occurred), else 0",
    "audit.fed": "Batches fed to the labeled tenant across non-fenced epochs (arrival-counter ledger total)",
    "audit.processed": "Batches processed (folded minus quarantined/skipped) for the labeled tenant across non-fenced epochs",
    "audit.shed": "Batches shed by admission for the labeled tenant across non-fenced epochs",
    "audit.deferred_pending": "Deferred batches still awaiting replay for the labeled tenant",
    "audit.violations": "Conservation-audit violations (per labeled invariant, plus the unlabeled total the audit_violation preset watches)",
    # placement control-plane families (fleet/placement.py): the tenant→host
    # assignment table, rebalance moves and hysteresis-episode convergence —
    # all gauges (point-in-time controller state), never _total
    "placement.assignments": "Tenants currently assigned a host in the placement controller's table",
    "placement.host_tenants": "Tenants the placement table currently assigns to the labeled host",
    "placement.moves_in_flight": "Rebalance moves (drain->checkpoint->restore->replay) currently executing",
    "placement.moves_started": "Rebalance moves the controller has started since construction",
    "placement.moves_completed": "Rebalance moves completed successfully since construction",
    "placement.moves_failed": "Rebalance moves that failed (tenant left on its origin host) since construction",
    "placement.rebalancing": "1 while a hysteresis episode is open (imbalance above the high-water band), else 0",
    "placement.convergence_seconds": "Wall seconds the last closed hysteresis episode took to converge below the low-water band",
    "placement.decision_age_seconds": "Seconds since the placement controller last logged a decision",
}


def _gauge_help(name: str) -> str:
    specific = _GAUGE_HELP.get(name)
    if specific is not None:
        return f"{specific} (torchmetrics_tpu_torch.obs)"
    return f"Last recorded value of `{name}` (torchmetrics_tpu_torch.obs)"


# specific HELP text for histogram families; the default wording below covers
# span-derived duration histograms
_HIST_HELP = {
    "server.request": "Obs-server HTTP request duration by route — the self-instrumented scrape latency",
}


def _hist_help(name: str) -> str:
    specific = _HIST_HELP.get(name)
    if specific is not None:
        return f"{specific} (torchmetrics_tpu_torch.obs)"
    return f"Duration distribution of `{name}` in seconds (torchmetrics_tpu_torch.obs)"


def _render_exposition(snap: Dict[str, Any], openmetrics: bool) -> str:
    """One exposition walk, two flavors.

    ``openmetrics=False`` renders exactly the classic 0.0.4 page (byte-stable:
    the strict-parser goldens lock it) — histogram exemplars that may exist in
    the snapshot are **dropped**, because the classic text format has no
    exemplar syntax and a classic scraper must keep parsing unchanged.
    ``openmetrics=True`` renders the OpenMetrics flavor: counter family
    headers drop the ``_total`` suffix (samples keep it), histogram bucket
    lines carry their bucket's freshest exemplar as
    ``# {trace_id="..."} <value> <timestamp>``, and the page ends ``# EOF``.
    Exemplars reference already-existing series only — they can never mint a
    new label set.
    """
    out: List[str] = []

    def header(sample_name: str, family_name: str, kind: str, help_text: str) -> None:
        name = family_name if openmetrics else sample_name
        _prom_header(out, name, kind, help_text)

    by_name: Dict[str, List[Dict[str, Any]]] = {}
    for counter in snap["counters"]:
        by_name.setdefault(counter["name"], []).append(counter)
    for name in sorted(by_name):
        prom = _prom_name(name) + "_total"
        header(prom, _prom_name(name), "counter", f"Cumulative count of `{name}` events (torchmetrics_tpu_torch.obs)")
        for counter in by_name[name]:
            out.append(f"{prom}{_prom_labels(counter['labels'])} {_prom_value(counter['value'])}")

    by_name = {}
    for gauge in snap["gauges"]:
        by_name.setdefault(gauge["name"], []).append(gauge)
    for name in sorted(by_name):
        prom = _prom_name(name)
        header(prom, prom, "gauge", _gauge_help(name))
        for gauge in by_name[name]:
            out.append(f"{prom}{_prom_labels(gauge['labels'])} {_prom_value(gauge['value'])}")

    by_name = {}
    for hist in snap["histograms"]:
        by_name.setdefault(hist["name"], []).append(hist)
    for name in sorted(by_name):
        prom = _prom_name(name) + "_seconds"
        header(prom, prom, "histogram", _hist_help(name))
        for hist in by_name[name]:
            exemplars = hist.get("exemplars") or {}
            cumulative = 0
            for index, (bound, count) in enumerate(hist["buckets"]):
                cumulative += count
                le = "+Inf" if math.isinf(bound) else f"{bound:g}"
                labels = _prom_labels({**hist["labels"], "le": le})
                line = f"{prom}_bucket{labels} {cumulative}"
                if openmetrics:
                    rows = exemplars.get(str(index)) or exemplars.get(index)
                    if rows:
                        trace_id, value, wall = rows[-1]  # freshest exemplar wins
                        line += (
                            f' # {{trace_id="{_prom_escape(trace_id)}"}}'
                            f" {float(value):.9g} {float(wall):.3f}"
                        )
                out.append(line)
            out.append(f"{prom}_sum{_prom_labels(hist['labels'])} {_prom_value(hist['sum'])}")
            out.append(f"{prom}_count{_prom_labels(hist['labels'])} {hist['count']}")

    if snap["robust"]:

        def _robust_labels(row: Dict[str, Any]) -> Dict[str, Any]:
            labels = {"instance": str(row["instance"]), "metric": row["metric"]}
            if row.get("tenant"):
                labels["tenant"] = row["tenant"]
            return labels

        for name in _ROBUST_COUNTERS:
            prom = _prom_name("robust." + name) + "_total"
            header(
                prom,
                _prom_name("robust." + name),
                "counter",
                f"Per-metric robustness counter `{name}` (torchmetrics_tpu_torch.robust)",
            )
            for row in snap["robust"]:
                out.append(f"{prom}{_prom_labels(_robust_labels(row))} {row[name]}")
        for name in _ROBUST_FLAGS:
            prom = _prom_name("robust." + name)
            header(prom, prom, "gauge", f"Per-metric robustness flag `{name}` (torchmetrics_tpu_torch.robust)")
            for row in snap["robust"]:
                out.append(f"{prom}{_prom_labels(_robust_labels(row))} {int(row[name])}")

    prom = _prom_name("dropped_events") + "_total"
    header(
        prom,
        _prom_name("dropped_events"),
        "counter",
        "Events evicted from the telemetry ring buffer (torchmetrics_tpu_torch.obs)",
    )
    out.append(f"{prom} {snap['dropped_events']}")

    # node-exporter-style identity gauge: constant 1, labels carry the build
    prom = _prom_name("build_info")
    header(
        prom, prom, "gauge",
        "Build identity of this process: package/torch versions, backend, process index (torchmetrics_tpu_torch.obs)",
    )
    out.append(f"{prom}{_prom_labels(snap['build_info'])} 1")
    if openmetrics:
        out.append("# EOF")
    return "\n".join(out) + "\n"


def prometheus_text(
    metrics: Iterable[Any] = (),
    recorder: Optional[trace.TraceRecorder] = None,
    tenant: Optional[str] = None,
) -> str:
    """Prometheus text exposition (0.0.4) of counters, gauges, histograms and
    the per-metric robust counters. Every family gets a ``# HELP`` + ``# TYPE``
    header; histograms emit cumulative ``_bucket`` lines whose ``le`` labels
    end in ``+Inf`` plus ``_sum``/``_count``. ``tenant`` scopes the page to one
    tenant's series (``/metrics?tenant=``); meta families (build info, dropped
    events) stay on the scoped page. Deliberately **exemplar-free**: batch
    lineage never changes a byte of the classic page
    (:func:`openmetrics_text` is the exemplar-carrying flavor).
    """
    snap = collect(metrics, recorder, tenant=tenant)
    return _render_exposition(snap, openmetrics=False)


def openmetrics_text(
    metrics: Iterable[Any] = (),
    recorder: Optional[trace.TraceRecorder] = None,
    tenant: Optional[str] = None,
) -> str:
    """OpenMetrics exposition: the classic series plus histogram exemplars.

    Served by the obs server when a scraper's ``Accept`` header asks for
    ``application/openmetrics-text`` (:data:`OPENMETRICS_CONTENT_TYPE`).
    Histogram ``_bucket`` lines carry their bucket's freshest
    ``(trace_id, value, wall)`` exemplar (:mod:`~torchmetrics_tpu_torch.obs.lineage`)
    in OpenMetrics exemplar syntax, so a dashboard can jump from a p99 latency
    bucket straight to ``GET /trace/<id>``; the page terminates with
    ``# EOF``.
    """
    snap = collect(metrics, recorder, tenant=tenant)
    return _render_exposition(snap, openmetrics=True)


# ------------------------------------------------------------------- quantiles


def quantile_bucket(buckets: List[List[float]], q: float) -> Optional[Tuple[float, float]]:
    """``(lower, upper)`` bounds of the bucket holding the ``q``-quantile.

    The single implementation of the cumulative bucket-selection walk —
    :func:`histogram_quantile` derives its midpoint estimate from this, and
    consumers that need the estimate's error bar (the chaos bench's
    scrape-latency spreads) read the same bucket, so the two can never
    disagree about which bucket the quantile landed in. The open-ended
    ``+Inf`` bucket reports ``(lower, lower)``. Returns ``None`` for an
    empty histogram.
    """
    if not 0.0 < q <= 1.0:
        raise ValueError(f"Expected quantile in (0, 1], got {q}")
    total = sum(count for _, count in buckets)
    if not total:
        return None
    target = q * total
    cumulative = 0.0
    lower = 0.0
    for bound, count in buckets:
        cumulative += count
        if cumulative >= target and count:
            if math.isinf(bound):
                return (lower, lower)
            return (lower, bound)
        if not math.isinf(bound):
            lower = bound
    return (lower, lower)  # pragma: no cover - cumulative always reaches target above


def histogram_quantile(buckets: List[List[float]], q: float) -> Optional[float]:
    """Estimate the ``q``-quantile of a bucketed duration histogram (seconds).

    ``buckets`` is the snapshot shape — ``[[upper_bound, count], ...]`` with
    *non-cumulative* per-bucket counts, bounds ascending and ending ``+Inf``.
    Estimation is **bucket-midpoint interpolation**: the quantile lands in the
    first bucket whose cumulative count reaches ``q * total``
    (:func:`quantile_bucket`) and is reported as that bucket's midpoint
    (``(lower + upper) / 2``); the open-ended ``+Inf`` bucket reports its
    lower bound (the only defensible point). With log-scale buckets this is a
    coarse-but-honest estimate — the error is bounded by the bucket width,
    which the summary tables document. Returns ``None`` for an empty
    histogram.
    """
    bucket = quantile_bucket(buckets, q)
    if bucket is None:
        return None
    lower, upper = bucket
    return (lower + upper) / 2.0


def _quantile_cols(hist: Dict[str, Any]) -> str:
    """`` p50=...us p95=...us`` columns for a summary-table histogram row."""
    p50 = histogram_quantile(hist["buckets"], 0.50)
    p95 = histogram_quantile(hist["buckets"], 0.95)
    if p50 is None or p95 is None:
        return ""
    return f" p50~{p50 * 1e6:9.1f}us p95~{p95 * 1e6:9.1f}us"


# ----------------------------------------------------------------- summary table


def summary(metrics: Iterable[Any] = (), recorder: Optional[trace.TraceRecorder] = None) -> str:
    """Human-readable summary of the recorded telemetry."""
    snap = collect(metrics, recorder)
    lines: List[str] = ["== torchmetrics_tpu_torch obs summary =="]

    if snap["counters"]:
        lines.append("-- counters --")
        width = max(len(c["name"]) for c in snap["counters"])
        for counter in snap["counters"]:
            label = " ".join(f"{k}={v}" for k, v in sorted(counter["labels"].items()))
            lines.append(f"  {counter['name']:<{width}}  {_prom_value(counter['value']):>10}  {label}")

    if snap["gauges"]:
        lines.append("-- gauges --")
        width = max(len(g["name"]) for g in snap["gauges"])
        for gauge in snap["gauges"]:
            label = " ".join(f"{k}={v}" for k, v in sorted(gauge["labels"].items()))
            lines.append(f"  {gauge['name']:<{width}}  {_prom_value(gauge['value']):>10}  {label}")

    if snap["histograms"]:
        lines.append("-- durations --")
        width = max(len(h["name"]) for h in snap["histograms"])
        for hist in snap["histograms"]:
            label = " ".join(f"{k}={v}" for k, v in sorted(hist["labels"].items()))
            mean = hist["sum"] / hist["count"] if hist["count"] else 0.0
            lines.append(
                f"  {hist['name']:<{width}}  n={hist['count']:<6} total={hist['sum'] * 1e3:9.3f}ms"
                f" mean={mean * 1e6:9.1f}us{_quantile_cols(hist)}  {label}"
            )

    if snap["robust"]:
        lines.append("-- robust --")
        for row in snap["robust"]:
            flags = " ".join(f"{name}={int(row[name])}" for name in _ROBUST_FLAGS)
            counts = " ".join(f"{name.split('_', 1)[1]}={row[name]}" for name in _ROBUST_COUNTERS)
            lines.append(f"  {row['metric']}[{row['instance']}]: {counts} {flags}")

    counters = {
        (c["name"], tuple(sorted(c["labels"].items()))): c["value"] for c in snap["counters"]
    }
    emitted = counters.get(("warnings.emitted", ()), 0)
    deduped = counters.get(("warnings.deduplicated", ()), 0)
    dropped_tracking = counters.get(("warnings.dropped", ()), 0)
    if emitted or deduped or dropped_tracking:
        lines.append(
            f"-- warnings: {_prom_value(emitted)} emitted,"
            f" {_prom_value(deduped)} deduplicated,"
            f" {_prom_value(dropped_tracking)} past dedup cap (warnings_dropped) --"
        )
    lines.append(f"-- events: {len(snap['events'])} recorded, {snap['dropped_events']} dropped --")
    return "\n".join(lines) + "\n"
