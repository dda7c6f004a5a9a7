"""The port's Chrome trace export (``obs/perfetto.py``) held against the JAX package's.

The same snapshots — one host, two hosts, an aggregate with events, one whose events
were stripped — render to the same trace events in both packages, exactly: span
``"X"`` events with their tracks (per thread, per pipeline, per tenant), instants and
warnings, counter tracks, and the lineage flow chains keyed by trace id. Only
``otherData.generator`` (each names itself) is left aside; the pids and host names
come from the snapshots, so they agree as well. A live recorder's export (pid and host
aside) and ``write_trace``'s file are checked too, with a host profiler's seam tracks.
"""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest
import torch

torch.set_num_threads(2)

import torchmetrics_tpu.obs.aggregate as jaggregate  # noqa: E402
import torchmetrics_tpu.obs.perfetto as jperfetto  # noqa: E402
import torchmetrics_tpu.obs.trace as jtrace  # noqa: E402
import torchmetrics_tpu_torch.obs.aggregate as taggregate  # noqa: E402
import torchmetrics_tpu_torch.obs.hostprof as thostprof  # noqa: E402
import torchmetrics_tpu_torch.obs.perfetto as tperfetto  # noqa: E402
import torchmetrics_tpu_torch.obs.trace as ttrace  # noqa: E402

SIDES = {
    "jax": SimpleNamespace(aggregate=jaggregate, perfetto=jperfetto, trace=jtrace),
    "port": SimpleNamespace(aggregate=taggregate, perfetto=tperfetto, trace=ttrace),
}


@pytest.fixture(autouse=True)
def _clean():
    for side in SIDES.values():
        side.trace.disable()
        side.trace.get_recorder().clear()
    thostprof.install(None)
    yield
    thostprof.install(None)
    for side in SIDES.values():
        side.trace.disable()
        side.trace.get_recorder().clear()


def _record(side, index):
    rec = side.trace.TraceRecorder()
    t0 = rec._t0
    rec.add_span("engine.ingest", t0 + 0.001, 0.0005, 0, {"pipeline": "P", "trace_id": f"acme:e:{index}"})
    rec.add_span("engine.dispatch", t0 + 0.002, 0.004, 0, {"pipeline": "P", "tenant": "acme",
                                                          "trace_ids": f"acme:e:{index},acme:e:9"})
    rec.add_span("MulticlassAccuracy.update", t0 + 0.0025, 0.001, 1, {"metric": "MulticlassAccuracy"})
    rec.add_span("metric.compute", t0 + 0.007, 0.002, 0, {"metric": "M", "tenant": "zen"})
    rec.add_span("engine.replay", t0 + 0.01, 0.001, 0, {"pipeline": "P", "trace_id": "acme:e:9"})
    rec.add_event("sync.collective", op="gather", bytes=64)
    rec.add_event("warning", kind="warning", message="careful")
    rec.inc("engine.fused_batches", 8.0 * (index + 1), pipeline="P")
    rec.set_gauge("memory.state_bytes", 4096.0, metric="M", inst="0")
    rec.observe_duration("engine.dispatch", 0.004, pipeline="P")
    return rec


def _snap(name, index, monkeypatch, include_events=True):
    side = SIDES[name]
    monkeypatch.setattr(side.trace, "_host_meta",
                        lambda: {"process_index": index, "process_count": 2, "host_id": f"host-{index}:1"})
    snap = side.aggregate.host_snapshot(_record(side, index), include_events=include_events)
    snap["wall_clock_anchor"] = 1000.0 + 0.5 * index  # the hosts' clocks, fixed
    snap["elapsed"] = 0.02
    return json.loads(json.dumps(snap, default=str))


def _doc(module, source):
    doc = module.chrome_trace(json.loads(json.dumps(source)))
    doc["otherData"].pop("generator")
    return doc


def _sources(monkeypatch):
    one = _snap("jax", 0, monkeypatch)
    two = [_snap("jax", 0, monkeypatch), _snap("port", 1, monkeypatch)]
    stripped = [_snap("port", 0, monkeypatch, False), _snap("jax", 1, monkeypatch, False)]
    return {
        "one_host_snapshot": one,
        "port_host_snapshot": _snap("port", 0, monkeypatch),
        "two_host_list": two,
        "aggregate_with_events": jaggregate.merge_snapshots(two),
        "aggregate_of_stripped_snapshots_with_marker": dict(jaggregate.merge_snapshots(stripped),
                                                            host_snapshots=stripped),
    }


@pytest.mark.parametrize("case", ["one_host_snapshot", "port_host_snapshot", "two_host_list", "aggregate_with_events",
                                  "aggregate_of_stripped_snapshots_with_marker"])
def test_chrome_trace_matches_jax(case, monkeypatch):
    source = _sources(monkeypatch)[case]
    port, jax = _doc(tperfetto, source), _doc(jperfetto, source)
    assert port == jax
    phases = {e["ph"] for e in port["traceEvents"]}
    assert {"M", "C"} <= phases
    if case != "aggregate_of_stripped_snapshots_with_marker":
        assert {"X", "i", "s", "f"} <= phases
        assert port["otherData"]["n_flows"] >= 1


def test_an_aggregate_without_events_is_refused_as_jax_refuses_it(monkeypatch):
    agg = jaggregate.merge_snapshots([_snap("jax", 0, monkeypatch, False)])
    messages = []
    for module in (jperfetto, tperfetto):
        with pytest.raises(ValueError) as err:
            module.chrome_trace(agg)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    for module in (jperfetto, tperfetto):
        with pytest.raises(TypeError):
            module.chrome_trace(42)


def _live_doc(name):
    side = SIDES[name]
    side.trace.enable()
    rec = side.trace.get_recorder()
    rec.add_span("engine.dispatch", rec._t0 + 0.001, 0.002, 0, {"pipeline": "P", "trace_id": "t:e:0"})
    rec.add_span("engine.replay", rec._t0 + 0.004, 0.001, 0, {"pipeline": "P", "trace_id": "t:e:0"})
    side.trace.inc("c", 2.0)
    doc = side.perfetto.chrome_trace()
    doc["otherData"].pop("generator")
    events = []
    for e in doc["traceEvents"]:
        e = dict(e)
        e.pop("ts", None)
        e.pop("dur", None)
        if e.get("name") == "process_name":
            e["args"] = {}
        events.append(e)
    return events, doc["otherData"]


def test_live_recorder_export_matches_jax_clock_aside():
    assert _live_doc("port") == _live_doc("jax")


def test_write_trace_round_trips_with_host_profiler_tracks(tmp_path):
    ttrace.enable()
    ttrace.inc("c")
    profiler = thostprof.HostProfiler(rate_hz=10.0)
    profiler.sample_once(frames={1: [("torchmetrics_tpu_torch/engine/pipeline.py", "feed")]}, tenants={}, spans={},
                         now=0.0)
    thostprof.install(profiler)
    path = str(tmp_path / "trace.json")
    n = tperfetto.write_trace(path)
    with open(path) as fh:
        doc = json.load(fh)
    assert len(doc["traceEvents"]) == n
    names = {e["name"] for e in doc["traceEvents"]}
    assert "hostprof.samples{seam=ingest}" in names and "c" in names
    assert doc["otherData"]["generator"] == "torchmetrics_tpu_torch.obs.perfetto"
    assert [p.name for p in tmp_path.iterdir()] == ["trace.json"]


def test_perfetto_names_are_jax_names():
    assert sorted(tperfetto.__all__) == sorted(jperfetto.__all__)
