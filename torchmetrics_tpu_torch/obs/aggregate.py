"""Cross-rank aggregation of telemetry snapshots: per-process → fleet-level.

Counterpart of ``torchmetrics_tpu/obs/aggregate.py``. Every rank of a
``torch.distributed`` world records telemetry in isolation
(:mod:`~torchmetrics_tpu_torch.obs.trace` is process-local by design), so rank 0's
exporters can only answer for rank 0 — while the numbers that matter at fleet
scale (capture-cache miss storms, per-rank collective wall time, degraded syncs)
are exactly the ones that diverge per rank. This module closes that gap:

- :func:`host_snapshot` — one rank-aware snapshot of the local recorder
  (schema version, process index = the ``torch.distributed`` rank, 0 outside a
  world; host id, wall-clock anchor; see
  ``TraceRecorder.snapshot``).
- :func:`merge_snapshots` — pure merge math over any list of host snapshots:
  counters **sum**, gauges keep **per-host values plus the max**, log-scale
  duration histograms merge **bucket-wise**, deduplicated warnings carry the
  **list of hosts** that hit them, and value-health alerts
  (:mod:`~torchmetrics_tpu_torch.obs.alerts`) go fleet-wide: **firing on any host →
  firing in the aggregate**, with the affected hosts listed per alert.
- :func:`aggregate` — the distributed entry point: ships the local snapshot
  as JSON bytes over the guarded eager collective path
  (``parallel.sync.allgather_host_payloads`` →
  ``robust.degraded.guarded_collective``) and merges the world's snapshots.
  Under a configured ``robust.sync_guard`` a hung host degrades to a **loud
  partial aggregate** (``aggregate_degraded=True``, the missing ranks listed)
  instead of hanging the job; single-process worlds take a clean local-only
  path with no collective at all.

The aggregate is plain JSON-able data; feed it to
:func:`obs.perfetto.chrome_trace` (one Perfetto pid per host — pass
``include_events=True``) or summarize with :func:`summarize`.
"""

from __future__ import annotations

import json
import warnings
from typing import Any, Dict, List, Optional

import torchmetrics_tpu_torch.obs.scope as _scope
import torchmetrics_tpu_torch.obs.trace as trace
from torchmetrics_tpu_torch.obs import alerts as _alerts

__all__ = [
    "FLEET_SAMPLE_SCHEMA",
    "aggregate",
    "fleet_sample",
    "gather_snapshots",
    "host_snapshot",
    "merge_snapshots",
    "summarize",
]

# version stamp of the compact per-tick sample shape :func:`fleet_sample`
# extracts from a merged aggregate (obs/fleet.py retains a ring of these)
FLEET_SAMPLE_SCHEMA = 1

# firing beats pending: a fleet row's state is the worst any host reports
_ALERT_STATE_RANK = {"pending": 1, "firing": 2}


def host_snapshot(
    recorder: Optional[trace.TraceRecorder] = None, include_events: bool = True
) -> Dict[str, Any]:
    """This process's rank-aware snapshot, ready for cross-host transport.

    Adds a ``warnings`` list (distinct messages from the event log, in order)
    so warning attribution survives ``include_events=False`` — the cheap wire
    shape that ships only series, not the span ring buffer.
    """
    rec = recorder if recorder is not None else trace.get_recorder()
    snap = rec.snapshot()
    from torchmetrics_tpu_torch.obs.export import build_info

    snap["build_info"] = build_info()
    seen: set = set()
    messages: List[str] = []
    for ev in snap["events"]:
        if ev["kind"] == "warning":
            message = ev["attrs"].get("message", "")
            if message not in seen:
                seen.add(message)
                messages.append(message)
    snap["warnings"] = messages
    # active value-health alerts ride the snapshot so the fleet merge can say
    # "firing on host 3" — read-only: snapshotting never evaluates rules
    engine = _alerts.get_engine()
    snap["alerts"] = engine.active() if engine is not None else []
    # tenant liveness rows ride too (read-only registry copy), so the fleet
    # merge can say "tenant acme is active on hosts 0 and 3" — and a degraded
    # partial aggregate keeps the surviving hosts' tenant attribution
    snap["tenants"] = _scope.get_registry().rows() if _scope.ENABLED else []
    # control-plane liveness rides too (read-only copies): checkpoint
    # freshness, leases and fences per host, so a fleet merge can join "who
    # holds what, how stale" without a second collective (the /fleet per-host
    # row join). Empty dicts when tenancy never engaged — one branch.
    snap["scope_status"] = (
        {
            "checkpoints": _scope.checkpoint_status(),
            "leases": _scope.lease_status(),
            "fences": _scope.fence_status(),
        }
        if _scope.ENABLED
        else {"checkpoints": {}, "leases": {}, "fences": {}}
    )
    snap["n_events"] = len(snap["events"])
    # distinguishes "events were shipped (possibly zero)" from "events were
    # stripped for the cheap wire shape" — the merge keys host_snapshots (and
    # therefore Perfetto exportability) off this, not off event counts
    snap["events_included"] = include_events
    if not include_events:
        snap["events"] = []
    return snap


def _series_key(name: str, labels: Dict[str, Any]) -> tuple:
    return (name, json.dumps(labels, sort_keys=True, default=str))


def merge_snapshots(snaps: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge host snapshots into one fleet-level aggregate (pure function).

    Hosts whose ``schema_version`` differs from this build's are excluded from
    the merge and reported under ``schema_mismatch_hosts`` — a mixed-version
    fleet yields a partial-but-correct aggregate, never a mis-parsed one.
    """
    usable: List[Dict[str, Any]] = []
    mismatched: List[Dict[str, Any]] = []
    for snap in snaps:
        if snap.get("schema_version") == trace.SCHEMA_VERSION:
            usable.append(snap)
        else:
            mismatched.append(
                {
                    "process_index": snap.get("host", {}).get("process_index"),
                    "schema_version": snap.get("schema_version"),
                }
            )
    usable.sort(key=lambda s: s.get("host", {}).get("process_index", 0))

    hosts: List[Dict[str, Any]] = []
    counters: Dict[tuple, Dict[str, Any]] = {}
    gauges: Dict[tuple, Dict[str, Any]] = {}
    hists: Dict[tuple, Dict[str, Any]] = {}
    warn_rows: Dict[str, Dict[str, Any]] = {}
    alert_rows: Dict[tuple, Dict[str, Any]] = {}
    tenant_rows: Dict[str, Dict[str, Any]] = {}
    host_snaps: List[Dict[str, Any]] = []
    dropped_events = 0
    events_recorded = 0
    any_events = False

    for snap in usable:
        meta = snap.get("host", {})
        pidx = int(meta.get("process_index", 0))
        host_row = {
            "process_index": pidx,
            "host_id": meta.get("host_id", "?"),
            "wall_clock_anchor": snap.get("wall_clock_anchor"),
            "elapsed": snap.get("elapsed"),
        }
        if snap.get("build_info"):
            # build identity per host: a mixed-version fleet is visible in the
            # aggregate even before the schema gate would exclude anyone
            host_row["build_info"] = snap["build_info"]
        if snap.get("scope_status"):
            # the control-plane join: per-host checkpoint/lease/fence liveness
            # stays attributed to the host that reported it
            host_row["scope_status"] = snap["scope_status"]
        hosts.append(host_row)
        dropped_events += int(snap.get("dropped_events", 0))
        events_recorded += int(snap.get("n_events", len(snap.get("events", ()))))
        # foreign/legacy snapshots without the marker: fall back to presence
        if snap.get("events_included", bool(snap.get("events"))):
            any_events = True
        for counter in snap["counters"]:
            key = _series_key(counter["name"], counter["labels"])
            row = counters.setdefault(
                key, {"name": counter["name"], "labels": counter["labels"], "value": 0.0}
            )
            row["value"] += counter["value"]
        for gauge in snap["gauges"]:
            key = _series_key(gauge["name"], gauge["labels"])
            row = gauges.setdefault(
                key, {"name": gauge["name"], "labels": gauge["labels"], "per_host": {}}
            )
            row["per_host"][str(pidx)] = gauge["value"]
        for hist in snap["histograms"]:
            key = _series_key(hist["name"], hist["labels"])
            row = hists.setdefault(
                key,
                {
                    "name": hist["name"],
                    "labels": hist["labels"],
                    "buckets": [[bound, 0] for bound, _ in hist["buckets"]],
                    "sum": 0.0,
                    "count": 0,
                },
            )
            # bucket-wise merge: the bounds are a protocol constant
            # (_Histogram.BOUNDS) and schema-gated above, so same-name series
            # always align slot for slot
            for slot, (_, count) in zip(row["buckets"], hist["buckets"]):
                slot[1] += count
            row["sum"] += hist["sum"]
            row["count"] += hist["count"]
        for message in snap.get("warnings", ()):
            row = warn_rows.setdefault(message, {"message": message, "hosts": []})
            if pidx not in row["hosts"]:
                row["hosts"].append(pidx)
        for alert in snap.get("alerts", ()):
            # firing on ANY host makes the fleet row firing, with every
            # affected host listed — a per-tenant rollout gate must not
            # average a sick host away
            key = (str(alert.get("rule")), str(alert.get("series")), str(alert.get("tenant")))
            row = alert_rows.setdefault(
                key,
                {
                    "rule": alert.get("rule"),
                    "kind": alert.get("kind"),
                    "series": alert.get("series"),
                    "tenant": alert.get("tenant"),
                    "severity": alert.get("severity"),
                    "state": alert.get("state"),
                    "hosts": [],
                    "per_host": {},
                    "detail": alert.get("detail"),
                },
            )
            state = str(alert.get("state"))
            if _ALERT_STATE_RANK.get(state, 0) > _ALERT_STATE_RANK.get(str(row["state"]), 0):
                row["state"] = state
                row["detail"] = alert.get("detail")
            if pidx not in row["hosts"]:
                row["hosts"].append(pidx)
            row["per_host"][str(pidx)] = {
                "state": state,
                "value": alert.get("value"),
                "detail": alert.get("detail"),
            }
        for trow in snap.get("tenants", ()):
            # per-tenant liveness merges like gauges: hosts listed, activity
            # summed, first/last seen widened. A tenant active only on a host
            # that fell out of the merge is simply not here — which is why the
            # degraded flag + missing_hosts travel with the same aggregate
            tenant = str(trow.get("tenant"))
            merged = tenant_rows.setdefault(
                tenant,
                {
                    "tenant": tenant,
                    "hosts": [],
                    "per_host": {},
                    "updates": 0,
                    "computes": 0,
                    "active_pipelines": 0,
                    "registrations": 0,
                    "collapsed_names": 0,
                    "first_seen_unix": None,
                    "last_seen_unix": None,
                },
            )
            for field in ("updates", "computes", "active_pipelines", "registrations"):
                merged[field] += int(trow.get(field, 0) or 0)
            # distinct-name counts cannot be summed across hosts (the same
            # overflowed name on two hosts is ONE lost tenant): max is the
            # honest fleet lower bound, like first/last_seen widening
            merged["collapsed_names"] = max(
                merged["collapsed_names"], int(trow.get("collapsed_names", 0) or 0)
            )
            first = trow.get("first_seen_unix")
            if first is not None:
                merged["first_seen_unix"] = (
                    first if merged["first_seen_unix"] is None else min(merged["first_seen_unix"], first)
                )
            last = trow.get("last_seen_unix")
            if last is not None:
                merged["last_seen_unix"] = (
                    last if merged["last_seen_unix"] is None else max(merged["last_seen_unix"], last)
                )
            if pidx not in merged["hosts"]:
                merged["hosts"].append(pidx)
            merged["per_host"][str(pidx)] = {
                "updates": int(trow.get("updates", 0) or 0),
                "computes": int(trow.get("computes", 0) or 0),
                "active_pipelines": int(trow.get("active_pipelines", 0) or 0),
            }
        host_snaps.append(snap)

    for row in gauges.values():
        row["max"] = max(row["per_host"].values()) if row["per_host"] else None

    out: Dict[str, Any] = {
        "schema_version": trace.SCHEMA_VERSION,
        "aggregate": True,
        "n_hosts": len(hosts),
        "hosts": hosts,
        "missing_hosts": [],
        "aggregate_degraded": False,
        "schema_mismatch_hosts": mismatched,
        "counters": [counters[key] for key in sorted(counters)],
        "gauges": [gauges[key] for key in sorted(gauges)],
        "histograms": [hists[key] for key in sorted(hists)],
        "warnings": [warn_rows[message] for message in sorted(warn_rows)],
        "alerts": [alert_rows[key] for key in sorted(alert_rows)],
        "alerts_firing": sum(1 for row in alert_rows.values() if row["state"] == "firing"),
        "tenants": [tenant_rows[key] for key in sorted(tenant_rows)],
        "tenants_firing": sorted(
            {
                str(row["tenant"])
                for row in alert_rows.values()
                if row["state"] == "firing" and row.get("tenant")
            }
        ),
        "dropped_events": dropped_events,
        "events_recorded": events_recorded,
    }
    if any_events:
        # keep the raw per-host snapshots only when the caller shipped events:
        # that is what obs.perfetto needs to draw one pid per host
        out["host_snapshots"] = host_snaps
    return out


def gather_snapshots(
    recorder: Optional[trace.TraceRecorder] = None,
    include_events: bool = False,
    description: str = "obs aggregate",
    process_group: Optional[Any] = None,
) -> Dict[str, Any]:
    """Gather every host's snapshot over the guarded collective (the seam).

    ``process_group`` is the ``torch.distributed`` group to gather over (the
    default group when ``None``).

    The single gather-with-degrade step :func:`aggregate` and the fleet
    sampler (:mod:`~torchmetrics_tpu_torch.obs.fleet`) share. Returns::

        {"snapshots": [...], "missing_hosts": [...],
         "degraded_error": None | str, "corrupt_hosts": [...]}

    Single-process worlds return the local snapshot with no collective. In a
    multi-host world a hung or failing peer degrades to the local snapshot
    plus ``missing_hosts`` and a loud ``RuntimeWarning`` — never a stall —
    and a peer whose payload cannot be decoded lands in ``corrupt_hosts``.
    """
    local = host_snapshot(recorder, include_events=include_events)
    from torchmetrics_tpu_torch.parallel import sync as sync_mod

    if not sync_mod.distributed_available():
        return {
            "snapshots": [local],
            "missing_hosts": [],
            "degraded_error": None,
            "corrupt_hosts": [],
        }

    from torchmetrics_tpu_torch.robust.degraded import CollectiveError

    payload = json.dumps(local, default=str).encode("utf-8")
    try:
        payloads = sync_mod.allgather_host_payloads(payload, process_group, description=description)
    except CollectiveError as err:
        if trace.ENABLED:
            trace.get_recorder().inc("aggregate.degraded")
            trace.get_recorder().add_event("aggregate.degraded", error=str(err))
        warnings.warn(
            f"Cross-host telemetry aggregation DEGRADED to this host's local view:"
            f" {err}. The aggregate is partial (aggregate_degraded=True).",
            RuntimeWarning,
            stacklevel=2,
        )
        mine = local["host"]["process_index"]
        return {
            "snapshots": [local],
            "missing_hosts": [
                index for index in range(local["host"]["process_count"]) if index != mine
            ],
            "degraded_error": str(err),
            "corrupt_hosts": [],
        }

    snaps: List[Dict[str, Any]] = []
    corrupt: List[int] = []
    for index, raw in enumerate(payloads):
        try:
            snaps.append(json.loads(raw.decode("utf-8")))
        except (UnicodeDecodeError, ValueError):
            corrupt.append(index)
    return {
        "snapshots": snaps,
        "missing_hosts": [],
        "degraded_error": None,
        "corrupt_hosts": corrupt,
    }


def aggregate(
    recorder: Optional[trace.TraceRecorder] = None,
    include_events: bool = False,
    description: str = "obs aggregate",
    process_group: Optional[Any] = None,
) -> Dict[str, Any]:
    """Fleet-level aggregate of every host's telemetry (the distributed entry).

    Single-process worlds merge the local snapshot with no collective. In a
    multi-host world, each host JSON-encodes its snapshot and all snapshots
    cross over the guarded eager collective path; with a ``robust.sync_guard``
    configured, a hung or failing host turns into a **partial** aggregate —
    ``aggregate_degraded=True``, a loud ``RuntimeWarning``, the unreachable
    ranks listed in ``missing_hosts`` — rather than a hung job. Pass
    ``include_events=True`` to also ship the span ring buffers (needed for the
    cross-host Perfetto export; costs world-size × ring-buffer bytes).
    """
    gathered = gather_snapshots(
        recorder, include_events=include_events, description=description, process_group=process_group
    )
    out = merge_snapshots(gathered["snapshots"])
    if gathered["degraded_error"] is not None:
        out["aggregate_degraded"] = True
        out["degraded_error"] = gathered["degraded_error"]
        out["missing_hosts"] = gathered["missing_hosts"]
        return out
    corrupt = gathered["corrupt_hosts"]
    if corrupt or out["schema_mismatch_hosts"]:
        # a peer that gathered but could not be merged still makes the
        # aggregate PARTIAL — aggregate_degraded is the one documented signal
        # for "this is not the whole fleet", so it must fire here too
        out["aggregate_degraded"] = True
        if corrupt:
            out["corrupt_hosts"] = corrupt
        expected = set(range(len(gathered["snapshots"]) + len(corrupt)))
        present = {h["process_index"] for h in out["hosts"]}
        out["missing_hosts"] = sorted(expected - present)
        warnings.warn(
            f"Cross-host telemetry aggregation is PARTIAL/DEGRADED: hosts {out['missing_hosts']}"
            f" gathered but could not be merged"
            f" ({len(corrupt)} corrupt payload(s),"
            f" {len(out['schema_mismatch_hosts'])} schema mismatch(es)).",
            RuntimeWarning,
            stacklevel=2,
        )
    return out


def fleet_sample(
    merged: Dict[str, Any],
    unix: Optional[float] = None,
    mono: Optional[float] = None,
) -> Dict[str, Any]:
    """One compact, timestamped fleet sample extracted from a merged aggregate.

    The sample schema the fleet sampler's ring retains: just the monotone
    numerators rate derivation needs (per-tenant update/compute counts with
    per-host attribution, cost-ledger flop/byte totals, checkpoint bytes) plus
    the degradation facts (``missing_hosts``, ``degraded``) — NOT the full
    aggregate, so a long history ring stays cheap. ``unix`` is the wall-clock
    display stamp; ``mono`` the monotonic stamp rate deltas divide by (both
    injectable for deterministic tests).

    Pure function: no collective, no clock reads unless the stamps are left
    ``None`` (then ``time.time()`` / ``time.monotonic()``).
    """
    import time as _time

    tenants: Dict[str, Dict[str, Any]] = {}
    for row in merged.get("tenants", ()):
        tenants[str(row["tenant"])] = {
            "updates": int(row.get("updates", 0) or 0),
            "computes": int(row.get("computes", 0) or 0),
            "active_pipelines": int(row.get("active_pipelines", 0) or 0),
            "per_host": {
                host: {
                    "updates": int(sub.get("updates", 0) or 0),
                    "computes": int(sub.get("computes", 0) or 0),
                }
                for host, sub in (row.get("per_host") or {}).items()
            },
        }
    # cost-ledger burn numerators: the cumulative dispatch-weighted estimates
    # (cost.estimated_flops / cost.estimated_bytes gauges, per metric class)
    # summed across classes, keeping per-host attribution
    cost: Dict[str, Any] = {
        "flops": 0.0,
        "bytes": 0.0,
        "per_host": {},
    }
    _COST_FIELDS = {"cost.estimated_flops": "flops", "cost.estimated_bytes": "bytes"}
    for gauge in merged.get("gauges", ()):
        field = _COST_FIELDS.get(gauge.get("name"))
        if field is None:
            continue
        for host, value in (gauge.get("per_host") or {}).items():
            try:
                value = float(value)
            except (TypeError, ValueError):
                continue
            cost[field] += value
            host_row = cost["per_host"].setdefault(host, {"flops": 0.0, "bytes": 0.0})
            host_row[field] += value
    # checkpoint-bytes numerators from the per-host scope_status join
    # (cumulative full+delta bundle bytes per tenant)
    checkpoint: Dict[str, Any] = {"bytes": 0.0, "per_host": {}, "per_tenant": {}}
    hosts: List[int] = []
    for host_row in merged.get("hosts", ()):
        pidx = int(host_row.get("process_index", 0))
        hosts.append(pidx)
        rows = ((host_row.get("scope_status") or {}).get("checkpoints")) or {}
        host_bytes = 0.0
        for tenant, row in rows.items():
            tenant_bytes = float(sum((row.get("bytes") or {}).values()))
            host_bytes += tenant_bytes
            checkpoint["per_tenant"][str(tenant)] = (
                checkpoint["per_tenant"].get(str(tenant), 0.0) + tenant_bytes
            )
        if host_bytes:
            checkpoint["per_host"][str(pidx)] = host_bytes
        checkpoint["bytes"] += host_bytes
    return {
        "schema": FLEET_SAMPLE_SCHEMA,
        "unix": float(unix if unix is not None else _time.time()),
        "mono": float(mono if mono is not None else _time.monotonic()),
        "n_hosts": int(merged.get("n_hosts", 0)),
        "hosts": sorted(hosts),
        "missing_hosts": list(merged.get("missing_hosts", ())),
        "degraded": bool(merged.get("aggregate_degraded", False)),
        "degraded_error": merged.get("degraded_error"),
        "tenants": tenants,
        "cost": cost,
        "checkpoint": checkpoint,
    }


def summarize(agg: Dict[str, Any]) -> str:
    """Human-readable table of a fleet aggregate."""
    lines = [
        f"== torchmetrics_tpu_torch obs aggregate: {agg['n_hosts']} host(s)"
        + (" [DEGRADED/PARTIAL]" if agg.get("aggregate_degraded") else "")
        + " =="
    ]
    for host in agg["hosts"]:
        lines.append(f"  host {host['process_index']}: {host['host_id']}")
    if agg.get("missing_hosts"):
        lines.append(f"  MISSING hosts: {agg['missing_hosts']}")
    if agg["counters"]:
        lines.append("-- counters (summed across hosts) --")
        width = max(len(c["name"]) for c in agg["counters"])
        for counter in agg["counters"]:
            label = " ".join(f"{k}={v}" for k, v in sorted(counter["labels"].items()))
            lines.append(f"  {counter['name']:<{width}}  {counter['value']:>10g}  {label}")
    # memory-accounting gauges (obs/memory.py) and cost-ledger gauges
    # (obs/cost.py) get their own fleet tables with human-readable columns;
    # everything else stays in the generic table
    memory_gauges = [g for g in agg["gauges"] if g["name"].startswith("memory.")]
    cost_gauges = [g for g in agg["gauges"] if g["name"].startswith("cost.")]
    hostprof_gauges = [g for g in agg["gauges"] if g["name"].startswith("hostprof.")]
    other_gauges = [
        g
        for g in agg["gauges"]
        if not g["name"].startswith(("memory.", "cost.", "hostprof."))
    ]
    if other_gauges:
        lines.append("-- gauges (per-host | max) --")
        width = max(len(g["name"]) for g in other_gauges)
        for gauge in other_gauges:
            label = " ".join(f"{k}={v}" for k, v in sorted(gauge["labels"].items()))
            per_host = " ".join(
                f"{h}:{v:g}" for h, v in sorted(gauge["per_host"].items(), key=lambda kv: int(kv[0]))
            )
            lines.append(f"  {gauge['name']:<{width}}  {per_host} | max={gauge['max']:g}  {label}")
    if memory_gauges:
        from torchmetrics_tpu_torch.obs.memory import format_bytes

        lines.append("-- memory (per-host bytes | max) --")
        width = max(len(g["name"]) for g in memory_gauges)
        for gauge in memory_gauges:
            label = " ".join(f"{k}={v}" for k, v in sorted(gauge["labels"].items()))
            per_host = " ".join(
                f"{h}:{format_bytes(v)}"
                for h, v in sorted(gauge["per_host"].items(), key=lambda kv: int(kv[0]))
            )
            lines.append(
                f"  {gauge['name']:<{width}}  {per_host} | max={format_bytes(gauge['max'])}  {label}"
            )
    if cost_gauges:
        from torchmetrics_tpu_torch.obs.cost import format_count

        lines.append("-- estimated cost (per-host | max) --")
        width = max(len(g["name"]) for g in cost_gauges)
        for gauge in cost_gauges:
            label = " ".join(f"{k}={v}" for k, v in sorted(gauge["labels"].items()))
            per_host = " ".join(
                f"{h}:{format_count(v)}"
                for h, v in sorted(gauge["per_host"].items(), key=lambda kv: int(kv[0]))
            )
            lines.append(
                f"  {gauge['name']:<{width}}  {per_host} | max={format_count(gauge['max'])}  {label}"
            )
    if hostprof_gauges:
        # the host-profiler floor table: per-host per-seam sampled seconds
        # plus the sampler health gauges, so a fleet view shows WHERE each
        # host's Python floor sits (and how much the measurement itself cost)
        lines.append("-- host profiler: Python-floor attribution (per-host | max) --")
        width = max(len(g["name"]) for g in hostprof_gauges)
        for gauge in sorted(
            hostprof_gauges,
            key=lambda g: (g["name"], str(sorted(g["labels"].items()))),
        ):
            label = " ".join(f"{k}={v}" for k, v in sorted(gauge["labels"].items()))
            per_host = " ".join(
                f"{h}:{v:g}"
                for h, v in sorted(gauge["per_host"].items(), key=lambda kv: int(kv[0]))
            )
            lines.append(
                f"  {gauge['name']:<{width}}  {per_host} | max={gauge['max']:g}  {label}"
            )
    if agg["histograms"]:
        from torchmetrics_tpu_torch.obs.export import _quantile_cols

        lines.append("-- durations (bucket-merged; p50/p95 ~ bucket midpoints) --")
        width = max(len(h["name"]) for h in agg["histograms"])
        for hist in agg["histograms"]:
            label = " ".join(f"{k}={v}" for k, v in sorted(hist["labels"].items()))
            mean = hist["sum"] / hist["count"] if hist["count"] else 0.0
            lines.append(
                f"  {hist['name']:<{width}}  n={hist['count']:<6} total={hist['sum'] * 1e3:9.3f}ms"
                f" mean={mean * 1e6:9.1f}us{_quantile_cols(hist)}  {label}"
            )
    if agg.get("tenants"):
        lines.append("-- tenants (activity summed; hosts where seen) --")
        width = max(len(str(row["tenant"])) for row in agg["tenants"])
        for row in agg["tenants"]:
            lines.append(
                f"  {row['tenant']:<{width}}  hosts {row['hosts']}"
                f" updates={row['updates']} computes={row['computes']}"
                f" pipelines={row['active_pipelines']}"
            )
    if agg.get("alerts"):
        lines.append("-- alerts (worst state across hosts) --")
        for row in agg["alerts"]:
            tenant = f" [tenant {row['tenant']}]" if row.get("tenant") else ""
            lines.append(
                f"  {str(row['state']).upper():<8} {row['rule']} ({row['kind']})"
                f" on {row['series']}{tenant} — hosts {row['hosts']}: {row['detail']}"
            )
    if agg["warnings"]:
        lines.append("-- warnings (hosts that hit them) --")
        for row in agg["warnings"]:
            lines.append(f"  hosts {row['hosts']}: {row['message']}")
    lines.append(
        f"-- events: {agg['events_recorded']} recorded, {agg['dropped_events']} dropped,"
        f" across {agg['n_hosts']} host(s) --"
    )
    return "\n".join(lines) + "\n"
