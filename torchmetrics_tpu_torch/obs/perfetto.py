"""Chrome trace-event export: host-side spans viewable in Perfetto.

Counterpart of ``torchmetrics_tpu/obs/perfetto.py``. ``torch.profiler`` writes device
traces (``obs/profile.py``); the runtime's host-side telemetry (update dispatch spans,
capture spans, collective wall time) lives in the obs ring buffer. This module renders
that ring buffer as Chrome trace-event JSON (the JSON object flavor consumed by
Perfetto and ``chrome://tracing``), so host spans load *next to* device traces:

- spans → complete ``"X"`` events (``ts``/``dur`` in microseconds) on their
  recording thread's track, so nesting is preserved exactly; pipeline stage
  spans (``engine.*`` with a ``pipeline`` label) instead get their own named
  track per pipeline, so multiple streams' dispatch cadences read side by side;
- instant events and warnings → ``"i"`` events;
- batch lineage (:mod:`~torchmetrics_tpu_torch.obs.lineage`) → **flow events**
  (``"s"``/``"t"``/``"f"``, id = the batch's trace id): every span carrying a
  ``trace_id``/``trace_ids`` attr anchors the batch's flow, so one batch's
  ingest → dispatch → replay spans render as a visible arrow chain — across
  ranks when an aggregate is exported, because flow ids are global while each
  rank keeps its own pid;
- counters and gauges → ``"C"`` counter tracks;
- the live host profiler (:mod:`~torchmetrics_tpu_torch.obs.hostprof`), when one is
  installed → per-seam ``hostprof.samples{seam=...}`` counter tracks from its
  wall-stamped timeline ring;
- **one pid per rank**: a single-process export uses the local rank; a
  cross-rank aggregate (``obs.aggregate.aggregate(include_events=True)``)
  renders every rank as its own named process, aligned on the shared
  wall-clock anchor each recorder snapshots.

Writes are atomic (temp file + rename) like every telemetry writer.
"""

from __future__ import annotations

import json
from typing import Any, Dict, IO, List, Optional, Union

import torchmetrics_tpu_torch.obs.trace as trace
from torchmetrics_tpu_torch.utils.fileio import atomic_write_text

__all__ = ["chrome_trace", "write_trace"]

Source = Union[None, trace.TraceRecorder, Dict[str, Any], List[Dict[str, Any]]]


def _resolve_snapshots(source: Source) -> List[Dict[str, Any]]:
    """Normalize any accepted input to a list of host snapshots."""
    from torchmetrics_tpu_torch.obs.aggregate import host_snapshot

    if source is None:
        return [host_snapshot(trace.get_recorder())]
    if isinstance(source, trace.TraceRecorder):
        return [host_snapshot(source)]
    if isinstance(source, list):
        return source
    if isinstance(source, dict):
        if "host_snapshots" in source:  # aggregate with events shipped
            return source["host_snapshots"]
        if source.get("aggregate"):
            raise ValueError(
                "This aggregate carries no per-host events — build it with"
                " aggregate(include_events=True) to export a cross-host trace."
            )
        return [source]  # a single host snapshot
    raise TypeError(f"Cannot build a chrome trace from {type(source).__name__}")


def _us(seconds: float) -> float:
    return round(seconds * 1e6, 3)


def chrome_trace(source: Source = None) -> Dict[str, Any]:
    """Render telemetry as a Chrome trace-event JSON object.

    ``source``: ``None`` (the live recorder), a :class:`TraceRecorder`, a host
    snapshot, a list of host snapshots, or an ``include_events=True``
    aggregate. Returns ``{"traceEvents": [...], "displayTimeUnit": "ms", ...}``
    — ``json.dump`` it (or use :func:`write_trace`) and load in Perfetto.
    """
    snaps = _resolve_snapshots(source)
    anchors = [s.get("wall_clock_anchor") for s in snaps if s.get("wall_clock_anchor") is not None]
    anchor0 = min(anchors) if anchors else 0.0

    events: List[Dict[str, Any]] = []
    # batch-lineage flow points: every span referencing a trace id (the
    # `trace_id`/`trace_ids` attrs obs/lineage.py threads through the engine)
    # contributes one point; after all hosts are rendered, each trace id's
    # points become a Chrome flow chain (s → t → f) binding that ONE batch's
    # spans into a visible arrow — across hosts, because flow ids are global
    # while pids are per host
    flow_points: Dict[str, List[Dict[str, Any]]] = {}
    for snap in sorted(snaps, key=lambda s: s.get("host", {}).get("process_index", 0)):
        meta = snap.get("host", {})
        pid = int(meta.get("process_index", 0))
        # hosts align on the shared wall-clock: each host's monotonic-relative
        # `ts` is offset by how far its session anchor sits past the earliest
        offset = (snap.get("wall_clock_anchor") or anchor0) - anchor0
        events.append(
            {
                "ph": "M",
                "name": "process_name",
                "pid": pid,
                "tid": 0,
                "ts": 0,
                "args": {"name": f"host {pid} ({meta.get('host_id', '?')})"},
            }
        )
        tids: Dict[Any, int] = {}

        def _tid(record: Dict[str, Any]) -> int:
            # pipeline stage spans (engine.dispatch etc., labeled by pipeline)
            # get their own NAMED track per pipeline label, so a trace with
            # several pipelines shows each stream's dispatch cadence separately
            # instead of interleaving them all on the recording thread's track
            attrs = record.get("attrs") or {}
            tenant = attrs.get("tenant")
            if (
                record.get("kind") == "span"
                and str(record.get("name", "")).startswith("engine.")
                and "pipeline" in attrs
            ):
                # keyed by (label, recording thread): two same-class pipelines
                # driven concurrently from different threads emit overlapping
                # spans, which on ONE track would render as garbled false
                # nesting — they get separate (identically named) tracks
                raw: Any = ("pipeline", str(attrs["pipeline"]), tenant, record.get("tid", 0))
                display = f"pipeline {attrs['pipeline']}"
                if tenant:
                    # tenant-scoped pipelines read as distinct sessions: two
                    # tenants driving the same metric class get separate tracks
                    display += f" (tenant {tenant})"
            elif record.get("kind") == "span" and tenant:
                # tenant-attributed metric spans group per (tenant, thread): a
                # serving trace reads per-session instead of one interleaved
                # wall of same-named update spans
                raw = ("tenant", str(tenant), record.get("tid", 0))
                display = f"tenant {tenant}"
            else:
                raw = record.get("tid", 0)
                display = None
            if raw not in tids:
                tids[raw] = len(tids)
                events.append(
                    {
                        "ph": "M",
                        "name": "thread_name",
                        "pid": pid,
                        "tid": tids[raw],
                        "ts": 0,
                        "args": {"name": display or f"thread {tids[raw]}"},
                    }
                )
            return tids[raw]

        for record in snap.get("events", ()):
            base = {
                "name": record["name"],
                "pid": pid,
                "tid": _tid(record),
                "ts": _us(offset + record["ts"]),
                "args": dict(record.get("attrs", {})),
            }
            if record["kind"] == "span":
                events.append({**base, "ph": "X", "cat": "span", "dur": _us(record["dur"])})
                attrs = record.get("attrs") or {}
                ids = [attrs["trace_id"]] if attrs.get("trace_id") else []
                for extra in str(attrs.get("trace_ids") or "").split(","):
                    if extra and extra not in ids:
                        ids.append(extra)
                for trace_id in ids:
                    flow_points.setdefault(trace_id, []).append(
                        {"pid": base["pid"], "tid": base["tid"], "ts": base["ts"]}
                    )
            elif record["kind"] == "warning":
                events.append({**base, "ph": "i", "cat": "warning", "s": "p"})
            else:
                events.append({**base, "ph": "i", "cat": record["kind"], "s": "t"})

        # counters/gauges have no per-sample timeline (they are cumulative /
        # last-write-wins) — render each as a counter track with one sample at
        # the capture end, so the track shows the final fleet-relevant value
        end_ts = _us(offset + float(snap.get("elapsed", 0.0)))
        for counter in snap.get("counters", ()):
            label = ",".join(f"{k}={v}" for k, v in sorted(counter["labels"].items()))
            name = counter["name"] + (f"{{{label}}}" if label else "")
            events.append(
                {
                    "ph": "C",
                    "name": name,
                    "pid": pid,
                    "tid": 0,
                    "ts": end_ts,
                    "args": {"value": counter["value"]},
                }
            )
        for gauge in snap.get("gauges", ()):
            label = ",".join(f"{k}={v}" for k, v in sorted(gauge["labels"].items()))
            name = gauge["name"] + (f"{{{label}}}" if label else "")
            events.append(
                {
                    "ph": "C",
                    "name": name,
                    "pid": pid,
                    "tid": 0,
                    "ts": end_ts,
                    "args": {"value": gauge["value"]},
                }
            )

    # the live host profiler's per-seam sample timeline renders as counter
    # tracks beside the spans: each bounded timeline bucket is wall-stamped,
    # so aligning against the earliest recorder anchor puts "which seam was
    # burning host time" directly under the span that was open while it
    # burned. Live sources only — a deserialized snapshot carries no profiler
    if source is None or isinstance(source, trace.TraceRecorder):
        try:
            from torchmetrics_tpu_torch.obs import hostprof as _hostprof

            profiler = _hostprof.get_profiler()
        except Exception:
            profiler = None
        if profiler is not None and snaps:
            pid = int(snaps[0].get("host", {}).get("process_index", 0))
            for bucket in profiler.timeline():
                ts = _us(max(0.0, bucket["wall"] - anchor0)) if anchors else 0
                for seam, count in sorted(bucket["seams"].items()):
                    events.append(
                        {
                            "ph": "C",
                            "name": f"hostprof.samples{{seam={seam}}}",
                            "pid": pid,
                            "tid": 0,
                            "ts": ts,
                            "args": {"value": count},
                        }
                    )

    # one flow chain per trace id with at least two anchoring spans: the
    # first point starts the flow ("s"), intermediates step it ("t"), the
    # last ends it ("f") — Perfetto draws the arrow chain through every
    # anchored slice, stitching one batch's ingest → dispatch → replay story
    # across threads AND hosts (flow ids are the trace ids themselves)
    n_flows = 0
    for trace_id, points in sorted(flow_points.items()):
        if len(points) < 2:
            continue
        n_flows += 1
        points.sort(key=lambda p: p["ts"])
        for index, point in enumerate(points):
            ph = "s" if index == 0 else ("f" if index == len(points) - 1 else "t")
            flow = {
                "ph": ph,
                "cat": "lineage",
                "name": "batch",
                "id": trace_id,
                "pid": point["pid"],
                "tid": point["tid"],
                "ts": point["ts"],
            }
            if ph == "f":
                flow["bp"] = "e"  # bind the terminator to the enclosing slice
            events.append(flow)

    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "generator": "torchmetrics_tpu_torch.obs.perfetto",
            "schema_version": trace.SCHEMA_VERSION,
            "n_hosts": len(snaps),
            "n_flows": n_flows,
        },
    }


def write_trace(sink: Union[str, IO[str]], source: Source = None) -> int:
    """Write the Chrome trace JSON to ``sink``; returns the number of events.

    A string ``sink`` is written atomically (temp file + rename). Load the
    file in https://ui.perfetto.dev or ``chrome://tracing``.
    """
    doc = chrome_trace(source)
    text = json.dumps(doc)
    if isinstance(sink, str):
        atomic_write_text(sink, text)
    else:
        sink.write(text)
    return len(doc["traceEvents"])
