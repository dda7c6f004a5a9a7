"""The port's streaming engine and capture cache held against the JAX package's.

Every case of ``tests/core/test_engine.py`` that the port covers runs here as one
parametrised scenario (``TestFusionBitIdentical``, ``TestCollections``,
``TestBucketsAndPadding``, ``TestRobustReplay``, ``TestPrefetchInflight``,
``TestDispatchCounts``, ``TestWarmup`` without the persistent-cache cases,
``TestStaticLeafJitAOT``, ``TestPlumbing``). A scenario is played in both packages on
the same seeded numpy batches, and what it observes must be the same: final states
(integers exactly, floats within ``ATOL`` = 1e-5), computed values, the
``PipelineReport`` fields, quarantined update indices, and the ``engine.*`` counters
and the fused functions' ``jit.cache_*`` counters. On the CPU the port's capture cache
runs each function as it is; its CUDA graphs are held against this path by the card
tests (``tests/test_torch_cuda.py``) and ``chip_smoke.py``'s ``pipeline_eval``.

The JAX suite's ``MeanSquaredError``, ``MeanMetric``, ``SumMetric`` and ``CatMetric``
are not ported yet: small port metrics below hold the same states under the same
names and compute the same values on these finite inputs.
"""

from __future__ import annotations

import json
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torchmetrics_tpu as jtm  # noqa: E402
import torchmetrics_tpu.aggregation as jagg  # noqa: E402
import torchmetrics_tpu.classification as jc  # noqa: E402
import torchmetrics_tpu.core.jit as jjit  # noqa: E402
import torchmetrics_tpu.engine as jengine  # noqa: E402
import torchmetrics_tpu.obs.trace as jtrace  # noqa: E402
import torchmetrics_tpu.regression as jreg  # noqa: E402
import torchmetrics_tpu.robust.faults as jfaults  # noqa: E402
import torchmetrics_tpu_torch as ttm  # noqa: E402
import torchmetrics_tpu_torch.classification as tc  # noqa: E402
import torchmetrics_tpu_torch.core.jit as tjit  # noqa: E402
import torchmetrics_tpu_torch.engine as tengine  # noqa: E402
import torchmetrics_tpu_torch.obs.trace as ttrace  # noqa: E402
import torchmetrics_tpu_torch.robust.faults as tfaults  # noqa: E402
from torchmetrics_tpu_torch import Metric  # noqa: E402
from torchmetrics_tpu_torch.core.buffer import MaskedBuffer  # noqa: E402

ATOL = 1e-5
CPU = {"device": "cpu"}

# ------------------------------------------------------------- port mirror metrics


class MeanSquaredError(Metric):
    """The JAX package's ``MeanSquaredError`` (one output)."""

    full_state_update = False

    def __init__(self, **kwargs):
        super().__init__(**{**CPU, **kwargs})
        self.add_state("sum_squared_error", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds, target):
        diff = preds.to(torch.float32) - target.to(torch.float32)
        self.sum_squared_error = self.sum_squared_error + (diff * diff).sum()
        self.total = self.total + preds.numel()

    def compute(self):
        return self.sum_squared_error / self.total


class SumMetric(Metric):
    """``SumMetric(nan_strategy="ignore")`` on finite values."""

    full_state_update = False

    def __init__(self, **kwargs):
        super().__init__(**{**CPU, **kwargs})
        self.add_state("sum_value", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, value):
        self.sum_value = self.sum_value + value.to(torch.float32).sum()

    def compute(self):
        return self.sum_value


class MeanMetric(Metric):
    """``MeanMetric(nan_strategy="ignore")`` on finite values, weight 1."""

    full_state_update = False

    def __init__(self, **kwargs):
        super().__init__(**{**CPU, **kwargs})
        self.add_state("mean_value", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("weight", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, value):
        self.mean_value = self.mean_value + value.to(torch.float32).sum()
        self.weight = self.weight + torch.ones_like(value, dtype=torch.float32).sum()

    def compute(self):
        return self.mean_value / self.weight


class CatMetric(Metric):
    """``CatMetric``: a ``MaskedBuffer`` of ``capacity`` values, or a ragged list."""

    full_state_update = True

    def __init__(self, capacity=None, **kwargs):
        super().__init__(**{**CPU, **kwargs})
        self.capacity = capacity
        self.add_state("value", MaskedBuffer.create(capacity) if capacity else [], dist_reduce_fx="cat")

    def update(self, value):
        value = value.to(torch.float32).reshape(-1)
        if self.capacity:
            self.value = self.value.append(value)
        else:
            self.value.append(value)

    def compute(self):
        if self.capacity:
            return self.value.values()
        return torch.cat(self.value)


# ------------------------------------------------------------------------ packages

JAX = SimpleNamespace(
    name="jax", arr=jnp.asarray, trace=jtrace, faults=jfaults, engine=jengine, jit=jjit,
    Pipeline=jengine.MetricPipeline, Config=jengine.PipelineConfig, MetricCollection=jtm.MetricCollection,
    acc=lambda: jc.MulticlassAccuracy(num_classes=5, validate_args=False),
    f1=lambda: jc.MulticlassF1Score(num_classes=5, validate_args=False),
    auroc=lambda: jc.MulticlassAUROC(num_classes=5, thresholds=20, validate_args=False),
    mse=lambda **k: jreg.MeanSquaredError(**k), mean=lambda: jagg.MeanMetric(nan_strategy="ignore"),
    sum=lambda: jagg.SumMetric(nan_strategy="ignore"),
    cat=lambda capacity=None, **k: (jagg.CatMetric(capacity=capacity, nan_strategy=0.0, **k) if capacity
                                    else jagg.CatMetric(**k)),
    spec=lambda shape, dtype: jax.ShapeDtypeStruct(shape, dtype),
    zeros=lambda n: jnp.zeros(n), ones=lambda n: jnp.ones(n),
)
TORCH = SimpleNamespace(
    name="torch", arr=lambda a: torch.as_tensor(np.asarray(a)), trace=ttrace, faults=tfaults, engine=tengine,
    jit=tjit, Pipeline=tengine.MetricPipeline, Config=tengine.PipelineConfig, MetricCollection=ttm.MetricCollection,
    acc=lambda: tc.MulticlassAccuracy(num_classes=5, validate_args=False, **CPU),
    f1=lambda: tc.MulticlassF1Score(num_classes=5, validate_args=False, **CPU),
    auroc=lambda: tc.MulticlassAUROC(num_classes=5, thresholds=20, validate_args=False, **CPU),
    mse=lambda **k: MeanSquaredError(**k), mean=MeanMetric, sum=SumMetric, cat=lambda capacity=None, **k: CatMetric(capacity, **k),
    spec=lambda shape, dtype: torch.empty(shape, dtype={np.float32: torch.float32}[dtype], device="meta"),
    zeros=lambda n: torch.zeros(n), ones=lambda n: torch.ones(n),
)


def _class_batches(P, n, batch=16, classes=5, seed=0):
    rng = np.random.RandomState(seed)
    return [
        (P.arr(rng.rand(batch, classes).astype(np.float32)), P.arr(rng.randint(0, classes, batch)))
        for _ in range(n)
    ]


def _value_batches(P, n, size=8, seed=0):
    rng = np.random.RandomState(seed)
    return [(P.arr(rng.rand(size).astype(np.float32)),) for _ in range(n)]


def _pair_batches(P, n, size=8, seed=0):
    rng = np.random.RandomState(seed)
    return [(P.arr(rng.rand(size).astype(np.float32)), P.arr(rng.rand(size).astype(np.float32))) for _ in range(n)]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _states(metric):
    out = {}
    for key in metric._defaults:
        value = metric._state_values[key]
        if isinstance(value, list):
            out[key] = [_np(v) for v in value]
        elif hasattr(value, "data") and hasattr(value, "count"):
            out[key] = {"data": _np(value.data), "count": int(_np(value.count))}
        else:
            out[key] = _np(value)
    return out


REPORT_FIELDS = ("batches", "fused_batches", "eager_batches", "replayed_batches", "dispatches", "eager_dispatches",
                 "chunks_replayed", "padded_steps", "shape_flushes", "max_chunk", "last_chunk", "prefetch_hits",
                 "prefetch_misses", "host_dispatches")


def _report(report):
    d = report.asdict()
    return {k: d[k] for k in REPORT_FIELDS}


def _engine_counters(rec):
    """``engine.*`` counters and the fused functions' ``jit.cache_*`` counters. JAX's
    ``engine.compile_cache_hit`` counts its persistent compilation cache, which the port
    has no counterpart of (a CUDA graph cannot be written to disk)."""
    out = {}
    for row in rec.snapshot()["counters"]:
        name, labels = row["name"], row["labels"]
        if name == "engine.compile_cache_hit":
            continue
        if name.startswith("engine.") or name.startswith("flight."):
            out[name] = out.get(name, 0) + row["value"]
        elif name.startswith("jit.cache") and str(labels.get("fn", "")).endswith("fused_update"):
            out[name] = out.get(name, 0) + row["value"]
    return out


def _assert_same(a, b, where="obs"):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), f"{where}: keys {sorted(a)} != {sorted(b)}"
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), f"{where}: length {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, f"{where}: shape {a.shape} != {b.shape}"
        if np.issubdtype(a.dtype, np.floating) or np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64), atol=ATOL, rtol=0, err_msg=where)
        else:
            np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, abs=ATOL), f"{where}: {a} != {b}"
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


# ------------------------------------------------------------------------ scenarios


def _fused_equals_per_batch(P, maker, batch_fn):
    batches = batch_fn(P)
    reference, driven = getattr(P, maker)(), getattr(P, maker)()
    for args in batches:
        reference.update(*args)
    with P.trace.observe() as rec:
        report = P.Pipeline(driven, P.Config(fuse=4)).run(batches)
    assert report.dispatches < len(batches)  # fusion actually fused
    ref_states = _states(reference)
    _assert_same(ref_states, _states(driven), f"{P.name}.states")
    _assert_same(_np(reference.compute()), _np(driven.compute()), f"{P.name}.value")
    return {"states": _states(driven), "value": _np(driven.compute()), "report": _report(report),
            "counts": [driven._update_count, driven.updates_ok], "counters": _engine_counters(rec)}


FUSION_CASES = {
    "accuracy": ("acc", lambda P: _class_batches(P, 7)),
    "auroc_binned": ("auroc", lambda P: _class_batches(P, 6, seed=3)),
    "mse": ("mse", lambda P: _pair_batches(P, 9, seed=1)),
    "mean": ("mean", lambda P: _value_batches(P, 7, seed=2)),
    "sum": ("sum", lambda P: _value_batches(P, 5, seed=4)),
}


def _fused_cat_masked_buffer(P):
    batches = _value_batches(P, 6, seed=5)
    reference, driven = P.cat(128), P.cat(128)
    for args in batches:
        reference.update(*args)
    report = P.Pipeline(driven, P.Config(fuse=4)).run(batches)
    _assert_same(_states(reference), _states(driven), f"{P.name}.states")
    return {"states": _states(driven), "value": _np(driven.compute()), "report": _report(report),
            "counts": [driven._update_count, driven.updates_ok]}


def _ragged_list_state_degrades(P):
    batches = _value_batches(P, 6, seed=6)
    reference, driven = P.cat(), P.cat()
    for args in batches:
        reference.update(*args)
    report = P.Pipeline(driven, P.Config(fuse=4)).run(batches)
    _assert_same(_states(reference), _states(driven))
    return {"value": _np(driven.compute()), "report": _report(report)}


def _fuse_1_is_per_batch(P):
    batches = _pair_batches(P, 5)
    reference, driven = P.mse(), P.mse()
    for args in batches:
        reference.update(*args)
    report = P.Pipeline(driven, fuse=1).run(batches)
    _assert_same(_np(reference.compute()), _np(driven.compute()))
    return {"value": _np(driven.compute()), "report": _report(report), "count": driven._update_count}


def _single_array_and_dict_batches(P):
    vals = [v[0] for v in _value_batches(P, 4, seed=7)]
    driven, driven2 = P.mean(), P.mean()
    P.Pipeline(driven, fuse=2).run(vals)  # bare tensors, not tuples
    P.Pipeline(driven2, fuse=2).run([{"value": v} for v in vals])
    return {"positional": _np(driven.compute()), "keyword": _np(driven2.compute())}


def _collection(P, members):
    return P.MetricCollection({name: getattr(P, maker)() for name, maker in members.items()})


def _fused_groups_identical_and_aliased(P):
    batches = _class_batches(P, 6, seed=8)
    members = {"acc": "acc", "f1": "f1", "auroc": "auroc"}
    reference, driven = _collection(P, members), _collection(P, members)
    for args in batches:
        reference.update(*args)
    with P.trace.observe() as rec:
        report = P.Pipeline(driven, P.Config(fuse=4)).run(batches)
    ref_res, drv_res = reference.compute(), driven.compute()
    _assert_same({k: _np(v) for k, v in ref_res.items()}, {k: _np(v) for k, v in drv_res.items()})
    groups = [g for g in driven.compute_groups.values() if len(g) > 1]
    leader, member = groups[0][0], groups[0][1]
    aliased = all(driven[member]._state_values[s] is driven[leader]._state_values[s] for s in driven[leader]._defaults)
    return {"values": {k: _np(v) for k, v in drv_res.items()}, "groups": sorted(map(sorted, groups)),
            "aliased": aliased, "report": _report(report), "counters": _engine_counters(rec)}


def _collection_with_unfusable_member(P):
    batches = _value_batches(P, 5, seed=9)
    members = {"mean": "mean", "cat": "cat"}
    reference, driven = _collection(P, members), _collection(P, members)
    for args in batches:
        reference.update(*args)
    report = P.Pipeline(driven, P.Config(fuse=4)).run(batches)
    res = {k: _np(v) for k, v in driven.compute().items()}
    _assert_same({k: _np(v) for k, v in reference.compute().items()}, res)
    return {"values": res, "report": _report(report),
            "counts": [driven["cat"]._update_count, driven["mean"]._update_count]}


def _default_buckets(P):
    return [P.Config(fuse=8).buckets(), P.Config(fuse=6).buckets(), P.Config(fuse=1).buckets(),
            P.Config(fuse=8, fuse_buckets=(4, 8)).buckets()]


def _partial_flush_pads(P):
    batches = _class_batches(P, 7, seed=10)  # fuse=4 -> chunks of 4 and 3 (pads to 4)
    reference, driven = P.acc(), P.acc()
    for args in batches:
        reference.update(*args)
    report = P.Pipeline(driven, P.Config(fuse=4)).run(batches)
    _assert_same(_states(reference), _states(driven))
    return {"states": _states(driven), "report": _report(report)}


def _masked_tail_on_masked_buffer(P):
    vals = _value_batches(P, 3, seed=11)  # fuse=4 -> one padded chunk
    reference, driven = P.cat(64), P.cat(64)
    for args in vals:
        reference.update(*args)
    report = P.Pipeline(driven, P.Config(fuse=4)).run(vals)
    _assert_same(_states(reference), _states(driven))
    return {"states": _states(driven), "value": _np(driven.compute()), "report": _report(report)}


def _bucket_variants_stay_bounded(P):
    metric = P.acc()
    pipe = P.Pipeline(metric, P.Config(fuse=8))
    batches = _class_batches(P, 8, seed=12)
    for n in (3, 5, 6, 7, 2, 1):  # six distinct flush lengths
        for args in batches[:n]:
            pipe.feed(*args)
        pipe.flush()
    fused = list(pipe._fused_fns.values())
    info = fused[0].cache_info()
    assert info["compiled_variants"] <= len(pipe.config.buckets())
    return {"fused_fns": len(fused), "variants": info["compiled_variants"], "hits": info["hits"],
            "misses": info["misses"], "states": _states(metric)}


def _masked_buffer_overflow_detected(P):
    driven = P.cat(8)
    pipe = P.Pipeline(driven, P.Config(fuse=4))
    with pytest.raises(ValueError, match="overflowed"):
        pipe.run(_value_batches(P, 20, size=8, seed=40))
    return {"raised": True}


def _shape_change_flushes(P):
    small = _class_batches(P, 3, batch=8, seed=13)
    large = _class_batches(P, 3, batch=24, seed=14)
    stream = [small[0], small[1], large[0], large[1], small[2], large[2]]
    reference, driven = P.acc(), P.acc()
    for args in stream:
        reference.update(*args)
    report = P.Pipeline(driven, P.Config(fuse=4)).run(stream)
    _assert_same(_states(reference), _states(driven))
    return {"states": _states(driven), "report": _report(report)}


def _quarantine_fields(metric):
    return {"ok": metric.updates_ok, "skipped": metric.updates_skipped, "quarantined": metric.updates_quarantined,
            "indices": [q["update_index"] for q in metric.quarantined_batches],
            "reasons": ["non-finite" in q["reason"] for q in metric.quarantined_batches]}


def _poisoned_batch_quarantined(P, tmp_path):
    data = _pair_batches(P, 8, seed=15)
    clean = P.mse()
    for i, args in enumerate(data):
        if i != 5:
            clean.update(*args)
    driven = P.mse(error_policy="quarantine")
    pipe = P.Pipeline(driven, P.Config(fuse=4, flight_dump_dir=str(tmp_path / P.name)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with P.faults.inject_nan_updates(indices=[5]):
            report = pipe.run(data)
    _assert_same(_np(clean.compute()), _np(driven.compute()))
    dumps = [json.loads(open(p).readline()) for p in pipe.flight_dumps]
    return {"report": _report(report), "robust": _quarantine_fields(driven), "value": _np(driven.compute()),
            "dumps": [(d["reason"], d["poisoned_batches"]) for d in dumps]}


def _warn_skip_policy(P):
    data = _pair_batches(P, 4, seed=16)
    driven = P.mse(error_policy="warn_skip")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with P.faults.inject_nan_updates(indices=[2]):
            report = P.Pipeline(driven, P.Config(fuse=4)).run(data)
    return {"robust": _quarantine_fields(driven), "report": _report(report)}


def _raise_policy_propagates(P):
    data = _pair_batches(P, 4, seed=17)
    driven = P.mse(error_policy="raise")
    pipe = P.Pipeline(driven, P.Config(fuse=4))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with P.faults.inject_nan_updates(indices=[1]):
            with pytest.raises(Exception, match="non-finite"):
                pipe.run(data)
    return {"robust": _quarantine_fields(driven)}


def _no_policy_never_screened(P):
    data = _pair_batches(P, 4, seed=18)
    clean_style, driven = P.mse(), P.mse()
    with P.faults.inject_nan_updates(indices=[1]):
        P.Pipeline(clean_style, fuse=1).run(data)
    with P.faults.inject_nan_updates(indices=[1]):
        report = P.Pipeline(driven, P.Config(fuse=4)).run(data)
    both = [_np(clean_style.compute()), _np(driven.compute())]
    return {"report": _report(report), "nan": [bool(np.isnan(v)) for v in both]}


def _degrade_event_recorded(P):
    data = _pair_batches(P, 4, seed=19)
    driven = P.mse(error_policy="quarantine")
    with P.trace.observe() as rec:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with P.faults.inject_nan_updates(indices=[0]):
                P.Pipeline(driven, P.Config(fuse=4, flight_records=0)).run(data)
    degraded = [e for e in rec.events() if e["name"] == "engine.chunk_degraded"]
    return {"degraded": [(e["attrs"]["reason"], e["attrs"]["steps"]) for e in degraded],
            "counters": _engine_counters(rec)}


def _prefetch_hits(P):
    batches = _pair_batches(P, 6, seed=20)
    return _report(P.Pipeline(P.mse(), P.Config(fuse=2, prefetch=2)).run(batches))


def _feed_path_no_prefetch(P):
    pipe = P.Pipeline(P.mse(), P.Config(fuse=2))
    for args in _pair_batches(P, 4, seed=21):
        pipe.feed(*args)
    return _report(pipe.close())


def _in_flight_window_bounded(P):
    config = P.Config(fuse=1, max_in_flight=2)
    pipe = P.Pipeline(P.mse(), config)
    depths = []
    for args in _pair_batches(P, 8, seed=22):
        pipe.feed(*args)
        depths.append(len(pipe._inflight))
    report = pipe.close()
    return {"depths": depths, "after": len(pipe._inflight), "report": _report(report)}


def _inflight_gauge_and_counters(P):
    with P.trace.observe() as rec:
        P.Pipeline(P.mse(), P.Config(fuse=2, prefetch=2)).run(_pair_batches(P, 6, seed=23))
    gauges = {g["name"] for g in rec.snapshot()["gauges"]}
    return {"counters": _engine_counters(rec),
            "gauges": sorted(gauges & {"engine.queue_depth", "engine.fused_chunk_size", "engine.in_flight"})}


def _fewer_host_dispatches(P):
    batches = _class_batches(P, 8, seed=24)
    baseline = P.acc()
    for args in batches:
        baseline.update(*args)
    driven = P.acc()
    pipe = P.Pipeline(driven, P.Config(fuse=4))
    pipe.warmup(*batches[0])
    with P.trace.observe() as rec:
        report = pipe.run(batches)
    _assert_same(_np(baseline.compute()), _np(driven.compute()))
    return {"counters": _engine_counters(rec), "report": _report(report)}


def _warmup_every_bucket(P):
    batches = _class_batches(P, 7, seed=25)
    pipe = P.Pipeline(P.acc(), P.Config(fuse=4))
    manifest = pipe.warmup(*batches[0])
    fused_entries = [e for e in manifest["entries"] if e["kind"] == "fused"]
    assert manifest["total_compile_seconds"] > 0
    with P.trace.observe() as rec:
        pipe.run(batches)
    compiles = [e for e in rec.events() if e["name"] == "jit.compile"]
    return {"buckets": [e["bucket"] for e in fused_entries], "fresh": all(e["fresh"] for e in fused_entries),
            "compiles_in_loop": len(compiles), "misses_in_loop": rec.counter_value("jit.cache_miss")}


def _warmup_abstract_specs(P):
    pipe = P.Pipeline(P.mse(), P.Config(fuse=2))
    spec = P.spec((8,), np.float32)
    manifest = pipe.warmup(spec, spec)
    assert manifest["fresh_compiles"] == manifest["variants"] > 0
    with P.trace.observe() as rec:
        pipe.run(_pair_batches(P, 4, seed=26))
    fused = [e for e in manifest["entries"] if e["kind"] == "fused"]
    return {"fused": [(e["bucket"], e["shapes"]) for e in fused], "misses_in_loop": rec.counter_value("jit.cache_miss")}


def _repeat_warmup_is_free(P):
    pipe = P.Pipeline(P.mse(), P.Config(fuse=2))
    args = _pair_batches(P, 1, seed=27)[0]
    first = pipe.warmup(*args)
    second = pipe.warmup(*args)
    assert first["fresh_compiles"] > 0
    fused = lambda m: [(e["bucket"], e["fresh"]) for e in m["entries"] if e["kind"] == "fused"]  # noqa: E731
    return {"first": fused(first), "second": fused(second), "second_seconds": second["total_compile_seconds"]}


def _manifest_round_trip(P, tmp_path):
    pipe = P.Pipeline(P.mse(), P.Config(fuse=2))
    path = str(tmp_path / f"{P.name}_warmup_manifest.json")
    manifest = pipe.warmup(*_pair_batches(P, 1, seed=28)[0], manifest_path=path)
    loaded = P.engine.load_manifest(path)
    assert loaded == json.loads(json.dumps(manifest))  # JSON-faithful round-trip
    loaded["schema_version"] = 99
    P.engine.save_manifest(loaded, path)
    with pytest.raises(ValueError, match="not a warmup manifest"):
        P.engine.load_manifest(path)
    return {"schema": manifest["schema_version"], "variants_match": manifest["variants"] == len(manifest["entries"])}


def _compile_and_first_run_spans(P):
    sl = P.jit.StaticLeafJit(lambda state, x: state + x)
    with P.trace.observe() as rec:
        sl(P.zeros(3), P.ones(3))
        sl(P.zeros(3), P.ones(3))
    names = [e["name"] for e in rec.events()]
    return {"compile": names.count("jit.compile"), "first_run": names.count("jit.first_run"),
            "miss": rec.counter_value("jit.cache_miss"), "hit": rec.counter_value("jit.cache_hit")}


def _shape_change_is_a_counted_miss(P):
    sl = P.jit.StaticLeafJit(lambda state, x: state + x.sum())
    with P.trace.observe() as rec:
        sl(P.zeros(()), P.ones(4))
        sl(P.zeros(()), P.ones(8))
    return {"miss": rec.counter_value("jit.cache_miss"),
            "compiles": len([e for e in rec.events() if e["name"] == "jit.compile"])}


def _warmup_then_call_is_pure_hit(P):
    sl = P.jit.StaticLeafJit(lambda state, x: state + x)
    info = sl.warmup(P.spec((3,), np.float32), P.spec((3,), np.float32))
    assert info["fresh"] and info["seconds"] > 0
    with P.trace.observe() as rec:
        out = sl(P.arr(np.zeros(3, np.float32)), P.arr(np.ones(3, np.float32)))
    again = sl.warmup(P.spec((3,), np.float32), P.spec((3,), np.float32))
    return {"out": _np(out), "miss": rec.counter_value("jit.cache_miss"), "hit": rec.counter_value("jit.cache_hit"),
            "again": [again["fresh"], again["seconds"], again["fn"] == info["fn"]]}


def _cache_info_accounting(P):
    sl = P.jit.StaticLeafJit(lambda state, x, k: state + x * k)
    sl(P.zeros(3), P.ones(3), 2)
    sl(P.zeros(3), P.ones(3), 2)
    sl(P.zeros(3), P.ones(3), 3)
    info = sl.cache_info()
    return {k: info[k] for k in ("static_variants", "compiled_variants", "hits", "misses")}


def _warmup_rejects_unhashable(P):
    sl = P.jit.StaticLeafJit(lambda state, x, opts: state + x)
    with pytest.raises(TypeError, match="unhashable"):
        sl.warmup(P.zeros(3), P.spec((3,), np.float32), type("U", (), {"__hash__": None})())
    return {"raised": True}


def _config_validation(P):
    for kwargs, match in (({"fuse": 0}, "fuse"), ({"max_in_flight": 0}, "max_in_flight"),
                          ({"prefetch": -1}, "prefetch"), ({"fuse_buckets": (0, 2)}, "fuse_buckets")):
        with pytest.raises(ValueError, match=match):
            P.Config(**kwargs)
    with pytest.raises(ValueError, match="Metric or MetricCollection"):
        P.Pipeline(object())
    return {"raised": True}


def _context_manager_flushes(P):
    data = _pair_batches(P, 3, seed=32)
    driven = P.mse()
    with P.Pipeline(driven, P.Config(fuse=4)) as pipe:
        for args in data:
            pipe.feed(*args)
    return {"value": _np(driven.compute()), "count": driven._update_count}


def _pipeline_compute_flushes(P):
    data = _pair_batches(P, 3, seed=33)
    pipe = P.Pipeline(P.mse(), P.Config(fuse=4))
    for args in data:
        pipe.feed(*args)
    return {"value": _np(pipe.compute())}


def _report_is_a_snapshot(P):
    pipe = P.Pipeline(P.mse(), P.Config(fuse=2))
    snap = pipe.report()
    pipe.run(_pair_batches(P, 2, seed=34))
    d = pipe.report().asdict()
    return {"snap": snap.batches, "after": pipe.report().batches,
            "host": d["host_dispatches"] == d["dispatches"] + d["eager_dispatches"]}


SCENARIOS = {
    **{f"fused_equals_per_batch[{k}]": (lambda P, _k=k: _fused_equals_per_batch(P, *FUSION_CASES[_k]))
       for k in FUSION_CASES},
    "fused_equals_per_batch[cat_masked_buffer]": _fused_cat_masked_buffer,
    "ragged_list_state_degrades_to_eager_and_matches": _ragged_list_state_degrades,
    "fuse_1_is_per_batch_pipelining": _fuse_1_is_per_batch,
    "single_array_and_dict_batches": _single_array_and_dict_batches,
    "fused_groups_identical_and_aliased": _fused_groups_identical_and_aliased,
    "collection_with_unfusable_member": _collection_with_unfusable_member,
    "default_buckets_are_powers_of_two": _default_buckets,
    "partial_flush_pads_to_bucket_with_masked_tail": _partial_flush_pads,
    "masked_tail_on_masked_buffer_state": _masked_tail_on_masked_buffer,
    "bucket_variants_stay_bounded": _bucket_variants_stay_bounded,
    "masked_buffer_overflow_detected_mid_stream": _masked_buffer_overflow_detected,
    "shape_change_flushes_and_stays_correct": _shape_change_flushes,
    "poisoned_batch_is_quarantined_not_the_chunk": _poisoned_batch_quarantined,
    "warn_skip_policy_skips_poisoned_batch": _warn_skip_policy,
    "raise_policy_propagates_from_replay": _raise_policy_propagates,
    "no_policy_chunk_is_never_screened": _no_policy_never_screened,
    "degrade_event_recorded": _degrade_event_recorded,
    "prefetch_hits_for_steady_stream": _prefetch_hits,
    "feed_path_counts_no_prefetch": _feed_path_no_prefetch,
    "in_flight_window_stays_bounded": _in_flight_window_bounded,
    "inflight_gauge_and_counters": _inflight_gauge_and_counters,
    "fused_engine_issues_fewer_host_dispatches_than_per_step": _fewer_host_dispatches,
    "warmup_precompiles_every_bucket_no_compiles_in_loop": _warmup_every_bucket,
    "warmup_accepts_abstract_specs": _warmup_abstract_specs,
    "repeat_warmup_is_free": _repeat_warmup_is_free,
    "manifest_round_trip": _manifest_round_trip,
    "compile_and_first_run_get_distinct_spans": _compile_and_first_run_spans,
    "shape_change_is_a_counted_miss": _shape_change_is_a_counted_miss,
    "warmup_then_call_is_pure_hit": _warmup_then_call_is_pure_hit,
    "cache_info_accounting": _cache_info_accounting,
    "warmup_rejects_unhashable_statics": _warmup_rejects_unhashable,
    "config_validation": _config_validation,
    "context_manager_flushes": _context_manager_flushes,
    "pipeline_compute_flushes": _pipeline_compute_flushes,
    "report_is_a_snapshot": _report_is_a_snapshot,
}
_NEEDS_TMP = {"poisoned_batch_is_quarantined_not_the_chunk", "manifest_round_trip"}


@pytest.fixture(autouse=True)
def _clean_trace():
    for module in (jtrace, ttrace):
        module.disable()
        module.get_recorder().clear()
    yield
    for module in (jtrace, ttrace):
        module.disable()
        module.get_recorder().clear()


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_engine_scenario_matches_jax(scenario, tmp_path):
    run = SCENARIOS[scenario]
    extra = (tmp_path,) if scenario in _NEEDS_TMP else ()
    _assert_same(run(JAX, *extra), run(TORCH, *extra), scenario)


# ------------------------------------------------------------------ port-only checks


def test_seams_of_later_slices_raise_not_implemented():
    # admission waits for the multiplexer slice; the session seams are ported
    with pytest.raises(NotImplementedError, match="mux"):
        tengine.PipelineConfig(admission=object())
    for kwargs in ({"tenant": "a"}, {"alert_engine": object()}, {"alert_every": 3}, {"checkpoint": object()},
                   {"lease_seconds": 10.0}):
        cfg = tengine.PipelineConfig(**kwargs)
        assert all(getattr(cfg, k) is v or getattr(cfg, k) == v for k, v in kwargs.items())
    assert tengine.persistent_cache_stats() == {"dir": None, "entries": 0, "requests": 0, "hits": 0, "misses": 0}
    assert tengine.configure_compile_cache("/nonexistent") is None and tengine.configured_cache_dir() is None


def test_tree_flatten_round_trips_states_and_buffers():
    buf = MaskedBuffer.create(4, (2,)).append(torch.ones(1, 2))
    tree = ({"a": torch.zeros(2), "b": [buf, 3]}, (torch.ones(1), "s"))
    leaves, treedef = tjit.tree_flatten(tree)
    assert len(leaves) == 6 and hash(treedef) is not None
    back = tjit.tree_unflatten(treedef, leaves)
    assert back[0]["b"][0].count == 1 and back[0]["b"][1] == 3 and back[1][1] == "s"
    assert torch.equal(back[0]["b"][0].data, buf.data)


def test_traced_masked_buffer_append_writes_at_its_tensor_count():
    eager = MaskedBuffer.create(6).append(torch.tensor([1.0, 2.0]))
    traced = MaskedBuffer.create(6).traced().append(torch.tensor([1.0, 2.0]))
    assert isinstance(traced.count, torch.Tensor) and int(traced.count) == 2
    assert torch.equal(traced.data, eager.data)
    # past the capacity the write is clamped inside the buffer; the count says so
    over = traced.append(torch.arange(6, dtype=torch.float32))
    assert int(over.count) == 8 and over.data.shape == (6,)


def test_jit_update_metric_equals_eager_on_the_cpu():
    batches = _class_batches(TORCH, 5, seed=50)
    eager, jitted = TORCH.acc(), tc.MulticlassAccuracy(num_classes=5, validate_args=False, jit_update=True, **CPU)
    for args in batches:
        eager.update(*args)
        jitted.update(*args)
    info = jitted._jitted_update.cache_info()
    assert (info["misses"], info["hits"]) == (1, 4)
    assert torch.equal(eager.compute(), jitted.compute())
    jitted.set_dtype(torch.float64)
    assert jitted._jitted_update is None  # a dtype change drops the captured variants


def test_buffered_overflow_raises_before_commit_and_keeps_state():
    driven = CatMetric(capacity=20)
    pipe = tengine.MetricPipeline(driven, tengine.PipelineConfig(fuse=2))
    batches = _value_batches(TORCH, 6, size=4, seed=51)
    pipe.run(batches[:4])  # 16 of 20
    before = driven.value.data.clone()
    with pytest.raises(ValueError, match="overflowed"):
        pipe.run(batches[4:])  # a chunk of 8 more: raises before its replay
    assert driven.value.count == 16 and torch.equal(driven.value.data, before)
