"""The port's cross-rank aggregation (``obs/aggregate.py``) held against the JAX package's.

- ``merge_snapshots`` is pure: the same host snapshots (made by JAX's ``host_snapshot``,
  by the port's, and a mix of both) merge to the same aggregate in both packages,
  exactly: counters summed, gauges per host with their max, histograms bucket-wise,
  warnings, alerts and tenants with their host lists, schema mismatches excluded.
- ``host_snapshot`` of the same recorder events has the same shape and series in both
  (build info, host identity and clock aside).
- ``aggregate`` in a faked two-rank world (JAX's fake ``process_allgather`` transport of
  ``tests/core/test_obs_aggregate.py``; in the port ``torch.distributed``'s
  ``all_gather`` hands back the peer's bytes), through the guard: a clean gather, a
  hung and a raising transport that degrade with the missing ranks listed, a corrupt
  and a schema-mismatched peer. ``summarize`` and ``fleet_sample`` are compared too.

Injected hangs park on timeouts of 0.05 s or less; no case asserts a wall time.
"""

from __future__ import annotations

import json
import warnings
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import torch.distributed as dist  # noqa: E402
from jax.experimental import multihost_utils  # noqa: E402

import torchmetrics_tpu.obs.aggregate as jaggregate  # noqa: E402
import torchmetrics_tpu.obs.trace as jtrace  # noqa: E402
import torchmetrics_tpu.parallel.sync as jsync  # noqa: E402
import torchmetrics_tpu.robust as jrobust  # noqa: E402
import torchmetrics_tpu.robust.faults as jfaults  # noqa: E402
import torchmetrics_tpu_torch.obs.aggregate as taggregate  # noqa: E402
import torchmetrics_tpu_torch.obs.trace as ttrace  # noqa: E402
import torchmetrics_tpu_torch.parallel.sync as tsync  # noqa: E402
import torchmetrics_tpu_torch.robust as trobust  # noqa: E402
import torchmetrics_tpu_torch.robust.faults as tfaults  # noqa: E402

SIDES = {
    "jax": SimpleNamespace(aggregate=jaggregate, trace=jtrace, robust=jrobust, faults=jfaults),
    "port": SimpleNamespace(aggregate=taggregate, trace=ttrace, robust=trobust, faults=tfaults),
}


@pytest.fixture(autouse=True)
def _clean():
    for side in SIDES.values():
        side.trace.disable()
        side.trace.get_recorder().clear()
    yield
    for side in SIDES.values():
        side.trace.disable()
        side.trace.get_recorder().clear()


def _meta(index, count=2):
    return {"process_index": index, "process_count": count, "host_id": f"fake-host-{index}:1"}


def _recorder(side, index):
    """Deterministic, host-distinct telemetry (JAX's ``_recorder_for_host``, plus tenants)."""
    rec = side.trace.TraceRecorder()
    rec.inc("work.items", 10.0 * (index + 1))
    rec.inc("jit.cache_hit", 2.0, fn="M.pure_update")
    rec.inc("engine.fused_batches", 4.0 * (index + 1), pipeline="p", tenant="acme")
    rec.set_gauge("cache.size", float(index + 3))
    rec.set_gauge("memory.state_bytes", 1024.0 * (index + 1), metric="M", inst="0")
    rec.set_gauge("cost.estimated_flops", 1e6 * (index + 1), metric="M")
    rec.set_gauge("hostprof.seam_seconds", 0.25 * (index + 1), seam="ingest")
    rec.observe_duration("sync.collective", 5e-4 * (index + 1), op="gather")
    rec.observe_duration("sync.collective", 0.3, op="gather")
    rec.record_warning("everywhere")
    rec.record_warning(f"only-host-{index}")
    rec.add_span("metric.update", start=rec._t0 + 0.001, duration=0.002, depth=0, attrs={"metric": "M"})
    return rec


def _snapshot(name, index, monkeypatch, include_events=True, count=2):
    side = SIDES[name]
    monkeypatch.setattr(side.trace, "_host_meta", lambda: _meta(index, count))
    snap = side.aggregate.host_snapshot(_recorder(side, index), include_events=include_events)
    return json.loads(json.dumps(snap, default=str))


def _alerted(snap, index):
    snap["alerts"] = [
        {"rule": "nan", "kind": "non_finite", "series": "acc", "tenant": "acme", "severity": "critical",
         "state": "firing" if index else "pending", "value": float(index), "detail": f"host {index}"},
    ]
    snap["tenants"] = [{"tenant": "acme", "updates": 5 + index, "computes": index, "active_pipelines": 1,
                        "registrations": 1, "collapsed_names": index, "first_seen_unix": 100.0 + index,
                        "last_seen_unix": 200.0 - index}]
    snap["scope_status"] = {"checkpoints": {"acme": {"bytes": {"full": 100 * (index + 1), "delta": 7}}},
                            "leases": {}, "fences": {}}
    return snap


def _strip_clock(agg):
    agg = json.loads(json.dumps(agg, default=str))
    for host in agg.get("hosts", ()):
        for key in ("wall_clock_anchor", "elapsed", "build_info"):
            host.pop(key, None)
    agg.pop("host_snapshots", None)
    return agg


MERGE_CASES = {
    "jax_snapshots": ("jax", "jax", True),
    "port_snapshots": ("port", "port", True),
    "mixed_snapshots": ("jax", "port", True),
    "series_only": ("port", "jax", False),
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_snapshots_matches_jax(case, monkeypatch):
    first, second, events = MERGE_CASES[case]
    snaps = [_alerted(_snapshot(first, 0, monkeypatch, events), 0), _alerted(_snapshot(second, 1, monkeypatch, events), 1)]
    mismatched = dict(snaps[1], schema_version=99, host={"process_index": 2})
    for snap_list in (snaps, snaps[::-1], snaps + [mismatched]):
        port = taggregate.merge_snapshots(json.loads(json.dumps(snap_list)))
        jax = jaggregate.merge_snapshots(json.loads(json.dumps(snap_list)))
        assert _strip_clock(port) == _strip_clock(jax)
        assert ("host_snapshots" in port) == events
    merged = taggregate.merge_snapshots(snaps)
    counters = {c["name"]: c["value"] for c in merged["counters"] if not c["labels"]}
    assert counters["work.items"] == 30.0
    summary_port = taggregate.summarize(merged).replace("torchmetrics_tpu_torch", "torchmetrics_tpu")
    assert summary_port == jaggregate.summarize(jaggregate.merge_snapshots(snaps))
    sample_port = taggregate.fleet_sample(merged, unix=5.0, mono=6.0)
    assert sample_port == jaggregate.fleet_sample(jaggregate.merge_snapshots(snaps), unix=5.0, mono=6.0)


def _series_view(snap):
    return {
        "schema_version": snap["schema_version"],
        "host": snap["host"],
        "counters": snap["counters"],
        "gauges": snap["gauges"],
        "histograms": [{k: v for k, v in h.items() if k != "exemplars"} for h in snap["histograms"]],
        "warnings": snap["warnings"],
        "events": [(e["kind"], e["name"], e["attrs"]) for e in snap["events"]],
        "n_events": snap["n_events"],
        "events_included": snap["events_included"],
        "alerts": snap["alerts"],
        "tenants": snap["tenants"],
        "scope_status": snap["scope_status"],
        "dropped_events": snap["dropped_events"],
        "keys": sorted(k for k in snap if k not in ("build_info",)),
    }


@pytest.mark.parametrize("include_events", [True, False])
def test_host_snapshot_matches_jax(include_events, monkeypatch):
    port = _snapshot("port", 1, monkeypatch, include_events)
    jax = _snapshot("jax", 1, monkeypatch, include_events)
    assert _series_view(port) == _series_view(jax)
    assert set(port["build_info"]) == {"version", "torch", "backend", "process_index"}


def test_host_snapshot_process_index_is_the_rank_outside_a_world():
    snap = taggregate.host_snapshot(ttrace.TraceRecorder())
    assert snap["host"]["process_index"] == 0 and snap["host"]["process_count"] == 1


# --------------------------------------------------------- aggregate, fake two ranks


def _jax_world(monkeypatch, peer_payload):
    def fake(x, tiled=False):
        x = np.asarray(x)
        if x.dtype == np.int32 and x.shape == (1,):
            return jnp.asarray(np.stack([x, np.asarray([len(peer_payload)], np.int32)]))
        padded = np.zeros(x.shape[0], np.uint8)
        padded[: len(peer_payload)] = np.frombuffer(peer_payload, np.uint8)
        return jnp.asarray(np.stack([x.astype(np.uint8), padded]))

    monkeypatch.setattr(jsync, "distributed_available", lambda: True)
    monkeypatch.setattr(multihost_utils, "process_allgather", fake)


def _port_world(monkeypatch, peer_payload):
    def all_gather(parts, payload, group=None):
        parts[0].copy_(payload)
        if payload.dtype == torch.int32:
            parts[1].copy_(torch.tensor([len(peer_payload)], dtype=torch.int32))
        else:
            peer = torch.zeros_like(payload)
            peer[: len(peer_payload)] = torch.frombuffer(bytearray(peer_payload), dtype=torch.uint8)
            parts[1].copy_(peer)

    monkeypatch.setattr(tsync, "distributed_available", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    monkeypatch.setattr(dist, "all_gather", all_gather)


def _peer_payload(monkeypatch, schema_offset=0):
    peer = _snapshot("jax", 1, monkeypatch, include_events=False)
    peer["schema_version"] += schema_offset
    return json.dumps(peer, default=str).encode("utf-8")


AGGREGATE_CASES = {
    "clean_two_rank_gather": ("peer", None, None),
    "hung_rank_degrades": ("peer", (0.02, 1), ("hang", 10)),
    "raising_transport_degrades": ("peer", (0.5, 1), ("raise", 10)),
    "transient_raise_recovers": ("peer", (0.5, 1), ("raise", 1)),
    "corrupt_peer": ("corrupt", None, None),
    "schema_mismatch_peer": ("mismatch", None, None),
}


def _play_aggregate(name, case, monkeypatch):
    payload_kind, guard, plan = AGGREGATE_CASES[case]
    if payload_kind == "peer":
        payload = _peer_payload(monkeypatch)
    elif payload_kind == "mismatch":
        payload = _peer_payload(monkeypatch, schema_offset=7)
    else:
        payload = b"\xff\xfenot json"
    side = SIDES[name]
    (_jax_world if name == "jax" else _port_world)(monkeypatch, payload)
    monkeypatch.setattr(side.trace, "_host_meta", lambda: _meta(0, 3 if case == "hung_rank_degrades" else 2))
    rec = _recorder(side, 0)
    side.trace.enable()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if guard is not None:
            with side.robust.sync_guard(*guard), side.faults.inject_collective_fault(*plan):
                agg = side.aggregate.aggregate(rec, include_events=False)
        else:
            agg = side.aggregate.aggregate(rec, include_events=False)
    live = side.trace.get_recorder().snapshot()
    return {
        "aggregate": _strip_clock(agg),
        "summary": side.aggregate.summarize(agg).replace("torchmetrics_tpu_torch", "torchmetrics_tpu"),
        "warnings": sorted({(w.category.__name__, str(w.message)) for w in caught}),
        "counters": sorted((c["name"], sorted(c["labels"].items()), c["value"]) for c in live["counters"]
                           if c["name"].startswith(("aggregate.", "sync.collective_"))),
    }


@pytest.mark.parametrize("case", sorted(AGGREGATE_CASES))
def test_aggregate_over_the_guard_matches_jax(case, monkeypatch):
    jax = _play_aggregate("jax", case, monkeypatch)
    port = _play_aggregate("port", case, monkeypatch)
    assert port == jax
    agg = port["aggregate"]
    if case == "hung_rank_degrades":
        assert agg["aggregate_degraded"] is True and agg["missing_hosts"] == [1, 2]
    if case == "clean_two_rank_gather":
        assert agg["n_hosts"] == 2 and agg["aggregate_degraded"] is False


def test_single_process_aggregate_is_local_and_clean():
    rec = _recorder(SIDES["port"], 0)
    agg = taggregate.aggregate(rec)
    assert agg["n_hosts"] == 1 and agg["aggregate_degraded"] is False and agg["missing_hosts"] == []
    counters = {c["name"]: c["value"] for c in agg["counters"] if not c["labels"]}
    assert counters["work.items"] == 10.0


def test_aggregate_names_are_jax_names():
    assert sorted(taggregate.__all__) == sorted(jaggregate.__all__)
    assert taggregate.FLEET_SAMPLE_SCHEMA == jaggregate.FLEET_SAMPLE_SCHEMA
