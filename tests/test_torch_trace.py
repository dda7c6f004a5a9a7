"""The port's telemetry (``obs/trace.py``, ``obs/lineage.py``) held against the JAX package's.

Every case of ``tests/core/test_observability.py``'s ``TestSpansAndRingBuffer``,
``TestJitCacheMetrics``, ``TestEagerFallback``, ``TestRecompileStormGuard`` and
``TestMetricLifecycleSpans`` runs here as one parametrised scenario, played against
both packages' recorder, capture cache and metrics: the recorded events, counters,
gauges, histograms and warnings must be the same (durations are compared by order,
not by value). The port's metric updates the capture cache only with
``jit_update=True``, which the JAX metric does by default: the jit scenarios set it on
the port's side. Then the batch-lineage index and the atomic file writes, against the
JAX package's modules.
"""

from __future__ import annotations

import os
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import torchmetrics_tpu.classification as jc  # noqa: E402
import torchmetrics_tpu.core.jit as jjit  # noqa: E402
import torchmetrics_tpu.obs.lineage as jlineage  # noqa: E402
import torchmetrics_tpu.obs.trace as jtrace  # noqa: E402
import torchmetrics_tpu.utils.fileio as jfileio  # noqa: E402
import torchmetrics_tpu_torch.classification as tc  # noqa: E402
import torchmetrics_tpu_torch.core.jit as tjit  # noqa: E402
import torchmetrics_tpu_torch.obs.lineage as tlineage  # noqa: E402
import torchmetrics_tpu_torch.obs.trace as ttrace  # noqa: E402
import torchmetrics_tpu_torch.utils.fileio as tfileio  # noqa: E402

JAX = SimpleNamespace(
    name="jax", trace=jtrace, jit=jjit, lineage=jlineage, fileio=jfileio, arr=jnp.asarray,
    zeros=jnp.zeros, ones=jnp.ones,
    acc=lambda: jc.MulticlassAccuracy(num_classes=3, validate_args=False),
)
TORCH = SimpleNamespace(
    name="torch", trace=ttrace, jit=tjit, lineage=tlineage, fileio=tfileio, arr=lambda a: torch.as_tensor(a),
    zeros=lambda n: torch.zeros(n), ones=lambda n: torch.ones(n),
    acc=lambda: tc.MulticlassAccuracy(num_classes=3, validate_args=False, jit_update=True, device="cpu"),
)


class _Unhashable:
    __hash__ = None


def _disabled_records_nothing(P):
    with P.trace.span("outer"):
        P.trace.event("ev")
        P.trace.inc("count")
    snap = P.trace.get_recorder().snapshot()
    return [snap["events"], snap["counters"]]


def _span_nesting(P):
    with P.trace.observe():
        with P.trace.span("outer", metric="M"):
            with P.trace.span("inner"):
                pass
    by_name = {e["name"]: e for e in P.trace.get_recorder().events()}
    return {"depths": [by_name["inner"]["depth"], by_name["outer"]["depth"]],
            "ordered": by_name["outer"]["dur"] >= by_name["inner"]["dur"] >= 0, "attrs": by_name["outer"]["attrs"]}


def _ring_buffer_bounds(P):
    with P.trace.observe(max_events=8):
        for i in range(20):
            P.trace.event("ev", i=i)
    rec = P.trace.get_recorder()
    return {"kept": [e["attrs"]["i"] for e in rec.events()], "dropped": rec.dropped_events}


def _observe_restores_prior_state(P):
    before = P.trace.is_enabled()
    with P.trace.observe():
        inside = P.trace.is_enabled()
        P.trace.inc("kept")
    return [before, inside, P.trace.is_enabled(), P.trace.get_recorder().counter_value("kept")]


def _nested_observe_keeps_outer(P):
    P.trace.enable()
    try:
        P.trace.inc("outer_data")
        with P.trace.observe():
            P.trace.inc("inner_data")
        rec = P.trace.get_recorder()
        return [P.trace.is_enabled(), rec.counter_value("outer_data"), rec.counter_value("inner_data")]
    finally:
        P.trace.disable()


def _observe_restores_max_events(P):
    before = P.trace.get_recorder().max_events
    with P.trace.observe(max_events=8):
        inside = P.trace.get_recorder().max_events
    return [inside, P.trace.get_recorder().max_events == before]


def _raised_cap_stays_exportable(P):
    cap = P.trace.get_recorder().max_events
    with P.trace.observe(max_events=cap * 2) as rec:
        for i in range(cap + 100):
            P.trace.event("ev", i=i)
    return [P.trace.get_recorder().max_events == cap, len(rec.events()), rec.dropped_events]


def _lowering_max_events_trims(P):
    with P.trace.observe():
        for i in range(100):
            P.trace.event("ev", i=i)
        P.trace.enable(max_events=16, reset=False)
        rec = P.trace.get_recorder()
        return [len(rec.events()), rec.dropped_events, [e["attrs"]["i"] for e in rec.events()]]


def _annotate_current_span(P):
    with P.trace.observe():
        with P.trace.span("s", path="jit"):
            P.trace.annotate_current_span(path="eager_fallback", extra="x")
    return P.trace.get_recorder().events()[0]["attrs"]


def _warning_dedup_bounded(P):
    rec = P.trace.get_recorder()
    with P.trace.observe():
        rec.max_tracked_warnings = 4
        try:
            emitted = [P.trace.record_warning(f"distinct message {i}") for i in range(10)]
        finally:
            del rec.max_tracked_warnings
    return [emitted, len(rec._seen_warnings), rec.counter_value("warnings.dropped")]


def _nested_observe_ignores_max_events(P):
    P.trace.enable()
    try:
        for i in range(50):
            P.trace.event("outer", i=i)
        with P.trace.observe(max_events=8):
            P.trace.event("inner")
        return [len(P.trace.get_recorder().events()), P.trace.get_recorder().dropped_events]
    finally:
        P.trace.disable()


def _series_cardinality_bounded(P):
    rec = P.trace.get_recorder()
    with P.trace.observe():
        rec.max_series = 8
        try:
            for i in range(20):
                P.trace.inc("c", inst=str(i))
                P.trace.set_gauge("g", i, inst=str(i))
                P.trace.observe_duration("d", 0.001, inst=str(i))
        finally:
            del rec.max_series
    snap = rec.snapshot()
    out = [len(snap["gauges"]), len(snap["histograms"]), rec.counter_value("series.dropped")]
    P.trace.enable(reset=False)
    P.trace.inc("c", inst="0")
    P.trace.disable()
    return out + [rec.counter_value("c", inst="0")]


def _counters_with_labels(P):
    with P.trace.observe():
        P.trace.inc("c", fn="a")
        P.trace.inc("c", fn="a")
        P.trace.inc("c", 3, fn="b")
    rec = P.trace.get_recorder()
    return [rec.counter_value("c", fn="a"), rec.counter_value("c", fn="b"), rec.counter_value("c")]


def _histogram_buckets(P):
    with P.trace.observe():
        P.trace.observe_duration("d", 5e-4)
        P.trace.observe_duration("d", 5e-4)
        P.trace.observe_duration("d", 2.0)
    hist = P.trace.get_recorder().snapshot()["histograms"][0]
    return [hist["buckets"], hist["count"], round(hist["sum"], 9)]


def _snapshot_shape(P):
    with P.trace.observe():
        P.trace.inc("c", fn="a")
    snap = P.trace.get_recorder().snapshot()
    return [sorted(snap), snap["schema_version"], snap["host"]["process_index"], snap["host"]["process_count"]]


def _hit_miss_counts_and_compile_span(P):
    sl = P.jit.StaticLeafJit(lambda state, x, k: state + x * k)
    with P.trace.observe():
        state = P.zeros(3)
        sl(state, P.ones(3), 2)
        sl(state, P.ones(3), 2)
        sl(state, P.ones(3), 3)
    rec = P.trace.get_recorder()
    compiles = [e for e in rec.events() if e["name"] == "jit.compile"]
    gauges = {g["name"]: g["value"] for g in rec.snapshot()["gauges"]}
    return [rec.counter_value("jit.cache_miss"), rec.counter_value("jit.cache_hit"), len(compiles),
            all(e["dur"] > 0 for e in compiles), gauges["jit.cache_size"]]


def _update_dispatch_labels_metric_class(P):
    m = P.acc()
    rng = np.random.RandomState(0)
    batch = (P.arr(rng.rand(8, 3).astype(np.float32)), P.arr(rng.randint(0, 3, 8)))
    with P.trace.observe():
        m.update(*batch)
        m.update(*batch)
    rec = P.trace.get_recorder()
    spans = [e for e in rec.events() if e["name"] == "metric.update"]
    return [rec.counter_value("jit.cache_miss", fn="MulticlassAccuracy.pure_update"),
            rec.counter_value("jit.cache_hit", fn="MulticlassAccuracy.pure_update"),
            len(spans), spans[0]["attrs"]]


def _fallback_warns_once_and_counts(P):
    calls = []
    sl = P.jit.StaticLeafJit(lambda state, x: (calls.append(1), state + 1)[1])
    with P.trace.observe():
        with pytest.warns(RuntimeWarning, match="EAGER dispatch"):
            sl(P.zeros(2), _Unhashable())
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            sl(P.zeros(2), _Unhashable())
    rec = P.trace.get_recorder()
    events = [e for e in rec.events() if e["name"] == "jit.eager_fallback"]
    return [len(calls), rec.counter_value("jit.eager_fallback"), events[0]["attrs"]["leaf_type"]]


def _fallback_relabels_span(P):
    sl = P.jit.StaticLeafJit(lambda state, x: state + 1)
    with P.trace.observe():
        with P.trace.span("metric.update", metric="M", path="jit"):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                sl(P.zeros(2), _Unhashable())
    return [e for e in P.trace.get_recorder().events() if e["kind"] == "span"][0]["attrs"]["path"]


def _fallback_result_matches_eager(P):
    sl = P.jit.StaticLeafJit(lambda state, x: state + 1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return np.asarray(sl(P.zeros(2), _Unhashable())).tolist()


def _storm_warns_once(P):
    sl = P.jit.StaticLeafJit(lambda state, k: state + k)
    sl.recompile_warn_threshold = 3
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for k in range(6):
            sl(P.zeros(1), k)
    storm = [str(w.message) for w in caught if "compiled" in str(w.message) and "variants" in str(w.message)]
    return [len(storm), "4 variants" in storm[0], "distinct values" in storm[0]]


def _storm_mixed_structures(P):
    sl = P.jit.StaticLeafJit(lambda state, k=0, extra=0: state + k + extra)
    sl.recompile_warn_threshold = 3
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for k in range(3):
            sl(P.zeros(1), k)
        sl(P.zeros(1), 0, extra=1)
    storm = [str(w.message) for w in caught if "variants" in str(w.message)]
    return [len(storm), "2 distinct argument structures" in storm[0], "3 distinct values" in storm[0]]


def _no_storm_below_threshold(P):
    sl = P.jit.StaticLeafJit(lambda state, k: state + k)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        for k in range(5):
            sl(P.zeros(1), k)
    return sl.cache_info()["compiled_variants"]


def _compute_forward_reset_instrumented(P):
    m = P.acc()
    rng = np.random.RandomState(1)
    preds, target = P.arr(rng.rand(8, 3).astype(np.float32)), P.arr(rng.randint(0, 3, 8))
    with P.trace.observe():
        m.update(preds, target)
        np.asarray(m.compute())
        m.forward(preds, target)
        m.reset()
    rec = P.trace.get_recorder()
    names = [e["name"] for e in rec.events()]
    forward = [e for e in rec.events() if e["name"] == "metric.forward"]
    return ["metric.compute" in names, "metric.update" in names, len(forward), forward[0]["attrs"],
            rec.counter_value("metric.reset", metric="MulticlassAccuracy")]


def _cached_compute_counted_not_spanned(P):
    m = P.acc()
    rng = np.random.RandomState(2)
    m.update(P.arr(rng.rand(8, 3).astype(np.float32)), P.arr(rng.randint(0, 3, 8)))
    with P.trace.observe():
        np.asarray(m.compute())
        np.asarray(m.compute())
    rec = P.trace.get_recorder()
    return [len([e for e in rec.events() if e["name"] == "metric.compute"]),
            rec.counter_value("metric.compute_cached", metric="MulticlassAccuracy")]


def _lineage_index(P):
    P.lineage.reset()
    index = P.lineage.enable(max_traces=3)
    ids = [P.lineage.mint(None, "ep", i) for i in range(5)]
    for i, tid in enumerate(ids):
        index.open(tid, None, i, signature=f"s{i}")
    index.update(ids[4], outcome="ok")
    P.lineage.note_dump([ids[3], ids[0]], "/dump")
    with P.lineage.trace(ids[4]):
        inside = P.lineage.current_trace()
    record = P.lineage.lookup(ids[4])
    out = [ids, [P.lineage.ordinal_of(t) for t in ids], P.lineage.ordinal_of("foreign"),
           P.lineage.epoch_of(ids[2]), P.lineage.trace_ids(), index.stats(), inside, P.lineage.current_trace(),
           {k: record[k] for k in ("tenant", "ordinal", "epoch", "signature", "outcome", "dump")},
           P.lineage.lookup(ids[3])["dump"]]
    P.lineage.reset()
    return out


def _atomic_writes(P, tmp_path):
    base = tmp_path / P.name
    path = P.fileio.atomic_write_text(str(base / "a.txt"), "hello")
    P.fileio.atomic_write_bytes(str(base / "b.bin"), b"\x00\x01")

    def _reject(tmp):
        raise ValueError("bad payload")

    with pytest.raises(ValueError, match="bad payload"):
        P.fileio.atomic_write_bytes(str(base / "b.bin"), b"xx", validate=_reject)
    claims = [P.fileio.exclusive_create_text(str(base / "claim"), "first"),
              P.fileio.exclusive_create_text(str(base / "claim"), "second")]
    with pytest.raises(ValueError, match="plain write mode"):
        with P.fileio.atomic_open(str(base / "c.txt"), "a"):
            pass
    return [os.path.basename(path), open(path).read(), open(base / "b.bin", "rb").read(), claims,
            open(base / "claim").read(), sorted(os.listdir(base))]


SCENARIOS = {
    "disabled_records_nothing": _disabled_records_nothing,
    "span_nesting_depths_and_durations": _span_nesting,
    "ring_buffer_bounds_and_dropped_counter": _ring_buffer_bounds,
    "observe_restores_prior_state_and_keeps_data": _observe_restores_prior_state,
    "nested_observe_keeps_outer_session_data": _nested_observe_keeps_outer,
    "observe_restores_max_events_override": _observe_restores_max_events,
    "raised_cap_capture_stays_exportable_after_exit": _raised_cap_stays_exportable,
    "lowering_max_events_trims_live_buffer": _lowering_max_events_trims,
    "annotate_current_span": _annotate_current_span,
    "warning_dedup_set_is_bounded": _warning_dedup_bounded,
    "nested_observe_ignores_max_events_override": _nested_observe_ignores_max_events,
    "series_cardinality_is_bounded": _series_cardinality_bounded,
    "counters_with_labels_and_sum": _counters_with_labels,
    "histogram_buckets": _histogram_buckets,
    "snapshot_shape": _snapshot_shape,
    "hit_miss_counts_and_compile_span": _hit_miss_counts_and_compile_span,
    "metric_update_dispatch_labels_metric_class": _update_dispatch_labels_metric_class,
    "fallback_warns_once_and_counts_every_fallback": _fallback_warns_once_and_counts,
    "fallback_relabels_enclosing_update_span": _fallback_relabels_span,
    "fallback_result_matches_eager": _fallback_result_matches_eager,
    "storm_warns_once_past_threshold_naming_leaves": _storm_warns_once,
    "storm_mixed_structures_reported_without_misattribution": _storm_mixed_structures,
    "no_storm_warning_below_threshold": _no_storm_below_threshold,
    "compute_forward_reset_instrumented": _compute_forward_reset_instrumented,
    "cached_compute_counted_not_spanned": _cached_compute_counted_not_spanned,
    "lineage_index": _lineage_index,
}


@pytest.fixture(autouse=True)
def _obs_clean():
    """Every test starts and ends with tracing off and an empty recorder, in both packages."""
    for module in (jtrace, ttrace):
        module.disable()
        module.get_recorder().clear()
        module.get_recorder().max_events = 4096
    yield
    for module in (jtrace, ttrace):
        module.disable()
        module.get_recorder().clear()
        module.get_recorder().max_events = 4096


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_telemetry_scenario_matches_jax(scenario):
    assert SCENARIOS[scenario](JAX) == SCENARIOS[scenario](TORCH)


def test_atomic_file_writes_match_jax(tmp_path):
    assert _atomic_writes(JAX, tmp_path) == _atomic_writes(TORCH, tmp_path)


def test_host_meta_reads_the_torch_distributed_rank(monkeypatch):
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    host = ttrace.get_recorder().snapshot()["host"]
    assert (host["process_index"], host["process_count"]) == (1, 2)
