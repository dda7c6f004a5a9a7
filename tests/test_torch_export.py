"""The port's exporters (``obs/export.py``) held against the JAX package's.

Both recorders are fed the same events (counters, gauges, histograms with lineage
exemplars, spans, instant events, warnings, tenant-labelled series) and both packages'
``MeanSquaredError`` the same batches under ``warn_skip`` (one NaN batch skipped). Then
the Prometheus text, the OpenMetrics text and the JSONL of the two packages must be the
same, line for line, except:

- ``build_info``'s labels (the port carries torch's version where JAX carries jax's);
- the package name in the ``# HELP`` text (each names itself);
- what the clock decides: span and event timestamps and durations, the exemplars'
  wall-clock stamps, the meta line's host identity and anchor.

The quantile helpers, the tenant filter and the summary table are compared the same way.
"""

from __future__ import annotations

import io
import json
import re
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import torchmetrics_tpu.obs.export as jexport  # noqa: E402
import torchmetrics_tpu.obs.lineage as jlineage  # noqa: E402
import torchmetrics_tpu.obs.trace as jtrace  # noqa: E402
import torchmetrics_tpu_torch.obs as tobs  # noqa: E402
import torchmetrics_tpu_torch.obs.export as texport  # noqa: E402
import torchmetrics_tpu_torch.obs.lineage as tlineage  # noqa: E402
import torchmetrics_tpu_torch.obs.trace as ttrace  # noqa: E402
from test_torch_robust import MeanSquaredError as TMeanSquaredError  # noqa: E402
from torchmetrics_tpu.regression import MeanSquaredError as JMeanSquaredError  # noqa: E402

SIDES = {
    "jax": SimpleNamespace(export=jexport, trace=jtrace, lineage=jlineage),
    "port": SimpleNamespace(export=texport, trace=ttrace, lineage=tlineage),
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
        side.lineage.disable()


def _seed(name):
    """The same telemetry into one package's recorder, and one guarded metric."""
    side = SIDES[name]
    tr = side.trace
    # the metric is driven with tracing off: JAX's jitted update records jit.* series
    # the port's eager update does not (ROADMAP Queue 3)
    if name == "jax":
        m = JMeanSquaredError(error_policy="warn_skip")
        batches = [(jnp.ones(2), jnp.zeros(2)), (jnp.full(2, jnp.nan), jnp.zeros(2)), (jnp.ones(2), jnp.ones(2))]
    else:
        m = TMeanSquaredError(error_policy="warn_skip")
        batches = [(torch.ones(2), torch.zeros(2)), (torch.full((2,), float("nan")), torch.zeros(2)),
                   (torch.ones(2), torch.ones(2))]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for preds, target in batches:
            m.update(preds, target)
    tr.enable()
    tr.inc("jit.cache_hit", 3, fn="M.pure_update")
    tr.inc("jit.cache_miss", fn="M.pure_update")
    tr.inc("engine.fused_batches", 16, pipeline="p0", tenant="acme")
    tr.inc("engine.fused_batches", 8, pipeline="p1", tenant="zen")
    tr.set_gauge("jit.cache_size", 1, fn="M.pure_update")
    tr.set_gauge("memory.state_bytes", 4096.0, metric="MulticlassAccuracy", inst="0", tenant="acme")
    tr.set_gauge("engine.queue_depth", 3, pipeline="p0", inst="1")
    tr.set_gauge("label.escape", 1.5, note='say "hi"\nback\\slash')
    side.lineage.enable()
    for i, seconds in enumerate((0.0004, 0.003, 0.02, 0.02, 0.7, 3.0)):
        with side.lineage.trace(f"acme:e1:{i}"):
            tr.observe_duration("sync.collective", seconds, op="leaf gather", ok="true")
    side.lineage.disable()
    tr.observe_duration("engine.dispatch", 0.0011, pipeline="p0", tenant="acme")
    rec = tr.get_recorder()
    rec.add_span("outer", rec._t0 + 0.5, 0.004, 0, {"metric": "M", "trace_id": "acme:e1:0"})
    rec.add_span("inner", rec._t0 + 0.501, 0.002, 1, {"step": 1})
    tr.event("sync.collective", op="leaf gather", bytes=64, ok=True)
    tr.record_warning("first warning")
    tr.record_warning("first warning")
    tr.get_recorder().add_event("checkpoint", ts="user-value", type="user-type")
    return m


_EXEMPLAR_WALL = re.compile(r"(# \{trace_id=\"[^\"]*\"\} \S+) \d+\.\d+$")


def _normalize_exposition(text: str) -> list:
    out = []
    for line in text.splitlines():
        if line.startswith("tm_tpu_build_info{"):
            continue  # build identity: the port's labels name torch
        line = line.replace("torchmetrics_tpu_torch.", "torchmetrics_tpu.")
        line = line.replace("package/torch versions", "package/jax versions")
        out.append(_EXEMPLAR_WALL.sub(r"\1 <wall>", line))
    return out


def _exposition(name, flavor, **kwargs):
    m = _seed(name)
    export = SIDES[name].export
    fn = export.prometheus_text if flavor == "prometheus" else export.openmetrics_text
    return _normalize_exposition(fn(metrics=[m], **kwargs))


@pytest.mark.parametrize("tenant", [None, "acme", "zen", "nobody"])
@pytest.mark.parametrize("flavor", ["prometheus", "openmetrics"])
def test_exposition_text_matches_jax(flavor, tenant):
    port = _exposition("port", flavor, tenant=tenant)
    jax = _exposition("jax", flavor, tenant=tenant)
    assert port == jax
    robust = [line for line in port if line.startswith("tm_tpu_robust_updates_skipped_total")]
    assert robust == (['tm_tpu_robust_updates_skipped_total{instance="0",metric="MeanSquaredError"} 1']
                      if tenant is None else [])
    if flavor == "openmetrics":
        assert port[-1] == "# EOF"


def test_build_info_names_torch_and_the_port_version():
    import torchmetrics_tpu_torch

    info = texport.build_info()
    assert set(info) == {"version", "torch", "backend", "process_index"}
    assert info["version"] == torchmetrics_tpu_torch.__version__
    assert info["torch"] == torch.__version__
    assert info["backend"] in ("cpu", "cuda")
    assert info["process_index"] == "0"
    text = texport.prometheus_text()
    assert f'tm_tpu_build_info{{backend="{info["backend"]}"' in text


def _jsonl(name):
    m = _seed(name)
    sink = io.StringIO()
    n = SIDES[name].export.write_jsonl(sink, metrics=[m])
    records = [json.loads(line) for line in sink.getvalue().splitlines()]
    assert len(records) == n
    meta = records[0]
    assert meta.pop("host_id") and meta.pop("wall_clock_anchor") > 0
    meta.pop("build_info")
    for record in records[1:]:
        record.pop("ts", None)
        record.pop("dur", None)
        if record["type"] == "histogram":
            record["buckets"] = [[b, c] for b, c in record["buckets"]]
    return records


def test_jsonl_matches_jax_modulo_clock():
    port, jax = _jsonl("port"), _jsonl("jax")
    assert port == jax
    robust = [r for r in port if r["type"] == "robust"]
    assert robust == [{"type": "robust", "metric": "MeanSquaredError", "instance": 0, "updates_ok": 2,
                       "updates_skipped": 1, "updates_quarantined": 0, "quarantine_dropped": 0,
                       "sync_degraded": False, "last_update_ok": True, "update_count": 2}]


def test_jsonl_to_a_path_is_atomic_and_parses(tmp_path):
    m = _seed("port")
    path = str(tmp_path / "obs.jsonl")
    n = texport.write_jsonl(path, metrics=[m])
    with open(path) as fh:
        lines = fh.read().splitlines()
    assert len(lines) == n and json.loads(lines[0])["type"] == "meta"
    assert sorted(p.name for p in tmp_path.iterdir()) == ["obs.jsonl"]


@pytest.mark.parametrize("tenant", ["acme", "zen"])
def test_collect_tenant_filter_matches_jax(tenant):
    def view(name):
        m = _seed(name)
        snap = SIDES[name].export.collect(metrics=[m], tenant=tenant)
        return {k: snap[k] for k in ("counters", "gauges", "robust")}, [
            (e["kind"], e["name"], e["attrs"]) for e in snap["events"]
        ], [(h["name"], h["labels"], h["buckets"], h["count"]) for h in snap["histograms"]]

    assert view("port") == view("jax")


def _summary(name):
    m = _seed(name)
    text = SIDES[name].export.summary(metrics=[m])
    text = text.replace("torchmetrics_tpu_torch", "torchmetrics_tpu")
    # span durations are the clock's
    return [line for line in text.splitlines() if not re.match(r"\s+(outer|inner)\b", line)]


def test_summary_table_matches_jax():
    assert _summary("port") == _summary("jax")


BUCKETS = [[0.001, 2], [0.01, 0], [0.1, 5], [1.0, 1], [float("inf"), 2]]


@pytest.mark.parametrize("q", [0.0, 0.1, 0.2, 0.5, 0.7, 0.8, 0.9, 0.95, 0.99, 1.0])
@pytest.mark.parametrize("buckets", [BUCKETS, [[0.001, 0], [float("inf"), 0]], [[0.5, 7]]])
def test_quantiles_match_jax(buckets, q):
    def outcome(fn):
        try:
            return fn(buckets, q)
        except ValueError as err:
            return ("ValueError", str(err))

    assert outcome(texport.histogram_quantile) == outcome(jexport.histogram_quantile)
    assert outcome(texport.quantile_bucket) == outcome(jexport.quantile_bucket)


def test_export_names_are_jax_names():
    assert sorted(texport.__all__) == sorted(jexport.__all__)
    assert texport.PROMETHEUS_CONTENT_TYPE == jexport.PROMETHEUS_CONTENT_TYPE
    assert texport.OPENMETRICS_CONTENT_TYPE == jexport.OPENMETRICS_CONTENT_TYPE
    for name in ("collect", "prometheus_text", "summary", "write_jsonl"):
        assert getattr(tobs, name) is getattr(texport, name)


def test_robust_counters_export_with_tracing_off():
    m = TMeanSquaredError(error_policy="warn_skip")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.update(torch.full((2,), float("nan")), torch.zeros(2))
    text = texport.prometheus_text(metrics=[m])
    assert 'tm_tpu_robust_updates_skipped_total{instance="0",metric="MeanSquaredError"} 1' in text
    assert np.isfinite(len(text))
