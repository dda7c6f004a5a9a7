"""The port's state-memory accounting (``obs/memory.py``) held against the JAX package's.

The same metrics and collections are built in both packages (the port's on
``device="cpu"``) and fed the same seeded numpy batches; then the footprints must be
equal exactly: every row (state, kind, nbytes, shape, dtype, unique bytes, list items,
buffer capacity and fill) and every total (``total_bytes``, ``unique_bytes``, device and
host bytes, list items). Cases: the ImageNet and CTR collections of ``chip_smoke.py``
at a small width, grouped (compute-group members alias their leader's state) and
ungrouped, a ``MaskedBuffer`` AUROC empty and filled, ragged list states before and
after ``compute_on_cpu`` moves them to the host, and quarantined batches. Rows are
compared in state-name order. Before the first update JAX's stat-scores states share
one immutable zeros array, so there only the bytes that depend on that sharing are left
aside. The gauges,
the report and ``format_bytes`` are compared the same way (the ``inst`` label is each
process's construction ordinal, so it is left aside).
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import torchmetrics_tpu.classification as jc  # noqa: E402
import torchmetrics_tpu.obs.memory as jmemory  # noqa: E402
import torchmetrics_tpu.obs.trace as jtrace  # noqa: E402
import torchmetrics_tpu_torch.classification as tc  # noqa: E402
import torchmetrics_tpu_torch.obs.memory as tmemory  # noqa: E402
import torchmetrics_tpu_torch.obs.trace as ttrace  # noqa: E402
from test_torch_robust import MeanSquaredError as TMeanSquaredError  # noqa: E402
from torchmetrics_tpu import MetricCollection as JMetricCollection  # noqa: E402
from torchmetrics_tpu.regression import MeanSquaredError as JMeanSquaredError  # noqa: E402
from torchmetrics_tpu_torch import MetricCollection as TMetricCollection  # noqa: E402

C = 10
N = 96
BATCH = 32


@pytest.fixture(autouse=True)
def _clean():
    for tr in (jtrace, ttrace):
        tr.disable()
        tr.get_recorder().clear()
    yield
    for tr in (jtrace, ttrace):
        tr.disable()
        tr.get_recorder().clear()


def _imagenet(mod, kw):
    return {
        "accuracy_top1": mod.MulticlassAccuracy(C, average="micro", **kw),
        "accuracy_macro": mod.MulticlassAccuracy(C, average="macro", **kw),
        "f1_macro": mod.MulticlassF1Score(C, average="macro", **kw),
        "precision_macro": mod.MulticlassPrecision(C, average="macro", **kw),
        "recall_macro": mod.MulticlassRecall(C, average="macro", **kw),
        "confusion_matrix": mod.MulticlassConfusionMatrix(C, **kw),
        "jaccard_macro": mod.MulticlassJaccardIndex(C, average="macro", **kw),
        "matthews": mod.MulticlassMatthewsCorrCoef(C, **kw),
        "cohen_kappa": mod.MulticlassCohenKappa(C, **kw),
        "calibration_error_b15": mod.MulticlassCalibrationError(C, n_bins=15, **kw),
        "auroc_t100": mod.MulticlassAUROC(C, thresholds=100, **kw),
        "pr_curve_micro_t200": mod.MulticlassPrecisionRecallCurve(C, average="micro", thresholds=200, **kw),
    }


def _ctr(mod, kw):
    kw = {**kw, "ignore_index": -1}
    return {
        "auroc_t1000": mod.BinaryAUROC(thresholds=1000, **kw),
        "accuracy": mod.BinaryAccuracy(**kw),
        "f1": mod.BinaryF1Score(**kw),
        "confusion_matrix": mod.BinaryConfusionMatrix(**kw),
        "average_precision_t1000": mod.BinaryAveragePrecision(thresholds=1000, **kw),
        "matthews": mod.BinaryMatthewsCorrCoef(**kw),
        "jaccard": mod.BinaryJaccardIndex(**kw),
        "calibration_error_b15": mod.BinaryCalibrationError(n_bins=15, **kw),
    }


def _data(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "imagenet":
        logits = rng.standard_normal((N, C)).astype(np.float32)
        target = rng.integers(0, C, N).astype(np.int32)
        logits[np.arange(N), target] += 3.0
        probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        return probs.astype(np.float32), target
    target = rng.integers(0, 2, N).astype(np.int32)
    target[rng.random(N) < 0.05] = -1
    scores = (1 / (1 + np.exp(-(rng.standard_normal(N) + target)))).astype(np.float32)
    return scores, target


def _drive(metric, preds, target, jax_side, batches=None):
    as_in = (lambda a: jnp.asarray(a)) if jax_side else (lambda a: torch.as_tensor(a))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for start in range(0, preds.shape[0], BATCH) if batches is None else batches:
            metric.update(as_in(preds[start:start + BATCH]), as_in(target[start:start + BATCH]))
    return metric


def _both(build, kind=None, drive=True):
    """(jax footprint, port footprint) of the same metric driven on the same data."""
    out = []
    for jax_side in (True, False):
        metric = build(jax_side)
        if drive:
            _drive(metric, *_data(kind), jax_side)
        out.append(tmemory.footprint(metric) if not jax_side else jmemory.footprint(metric))
    return out


_ALIAS_KEYS = ("unique_bytes", "device_bytes", "host_bytes")


def _by_state(fp, drop=()):
    """A footprint with its rows ordered by state name (a jitted JAX update hands its
    state dict back in sorted key order, the port keeps the declared order); ``drop``
    leaves keys aside at every level."""
    out = {k: v for k, v in fp.items() if k not in drop and k not in ("states", "children")}
    out["states"] = sorted(({k: v for k, v in row.items() if k not in drop} for row in fp["states"]),
                           key=lambda row: row["state"])
    out["children"] = [_by_state(child, drop) for child in fp["children"]]
    return out


@pytest.mark.parametrize("groups", [True, False])
@pytest.mark.parametrize("kind", ["imagenet", "ctr"])
@pytest.mark.parametrize("drive", [False, True])
def test_collection_footprint_matches_jax(kind, groups, drive):
    metrics_of = _imagenet if kind == "imagenet" else _ctr

    def build(jax_side):
        if jax_side:
            return JMetricCollection(metrics_of(jc, {"validate_args": False}), compute_groups=groups)
        return TMetricCollection(metrics_of(tc, {"validate_args": False, "device": "cpu"}), compute_groups=groups)

    jax_fp, port_fp = _both(build, kind, drive)
    if drive:
        assert _by_state(port_fp) == _by_state(jax_fp)
        if groups:
            assert port_fp["unique_bytes"] < port_fp["total_bytes"]  # aliases billed once
    else:
        # before the first update JAX's stat-scores states share one immutable zeros
        # array (billed once); the port's are separate tensors. Every row and total but
        # the dedup-dependent bytes must agree.
        assert _by_state(port_fp, _ALIAS_KEYS) == _by_state(jax_fp, _ALIAS_KEYS)
        assert port_fp["unique_bytes"] >= jax_fp["unique_bytes"]


def test_collection_memory_footprint_method_is_the_module_function():
    col = TMetricCollection(_ctr(tc, {"validate_args": False, "device": "cpu"}))
    assert col.memory_footprint() == tmemory.footprint(col)
    m = tc.BinaryAccuracy(device="cpu")
    assert m.memory_footprint() == tmemory.footprint(m)


@pytest.mark.parametrize("fill", [0, 1, 2])
def test_masked_buffer_auroc_capacity_against_fill_matches_jax(fill):
    def build(jax_side):
        mod, kw = (jc, {}) if jax_side else (tc, {"device": "cpu"})
        return mod.BinaryAUROC(thresholds=None, buffer_capacity=128, validate_args=False, **kw)

    out = []
    for jax_side in (True, False):
        m = build(jax_side)
        scores, target = _data("ctr")
        target = np.clip(target, 0, 1)
        _drive(m, scores, target, jax_side, batches=range(0, fill * BATCH, BATCH))
        out.append(jmemory.footprint(m) if jax_side else tmemory.footprint(m))
    assert _by_state(out[1]) == _by_state(out[0])
    rows = {r["state"]: r for r in out[1]["states"]}
    buffered = [r for r in rows.values() if r["kind"] == "masked_buffer"]
    assert buffered and all(r["fill_items"] == fill * BATCH for r in buffered)


@pytest.mark.parametrize("compute_on_cpu", [False, True])
@pytest.mark.parametrize("batches", [0, 1, 3])
def test_list_states_before_and_after_compute_on_cpu_match_jax(compute_on_cpu, batches):
    out = []
    for jax_side in (True, False):
        mod, kw = (jc, {}) if jax_side else (tc, {"device": "cpu"})
        m = mod.BinaryAUROC(thresholds=None, validate_args=False, compute_on_cpu=compute_on_cpu, **kw)
        scores, target = _data("ctr")
        _drive(m, scores, np.clip(target, 0, 1), jax_side, batches=range(0, batches * BATCH, BATCH))
        out.append(jmemory.footprint(m) if jax_side else tmemory.footprint(m))
    assert _by_state(out[1]) == _by_state(out[0])
    assert out[1]["list_items"] == 3 * batches  # preds, target and mask per update
    if batches:
        assert (out[1]["host_bytes"] > 0) == compute_on_cpu


def test_quarantined_batches_are_billed_as_jax_bills_them():
    out = []
    for jax_side in (True, False):
        if jax_side:
            m = JMeanSquaredError(error_policy="quarantine")
            batches = [(jnp.ones(4), jnp.zeros(4)), (jnp.full(4, jnp.nan), jnp.zeros(4))]
        else:
            m = TMeanSquaredError(error_policy="quarantine")
            batches = [(torch.ones(4), torch.zeros(4)), (torch.full((4,), float("nan")), torch.zeros(4))]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for p, t in batches:
                m.update(p, t)
        out.append(jmemory.footprint(m) if jax_side else tmemory.footprint(m))
    assert _by_state(out[1]) == _by_state(out[0])
    assert any(r["state"] == "__quarantine__" and r["nbytes"] == 32 for r in out[1]["states"])


def _gauges(snapshot):
    return sorted(
        (g["name"], sorted((k, v) for k, v in g["labels"].items() if k != "inst"), g["value"])
        for g in snapshot["gauges"]
    )


def test_record_gauges_and_report_match_jax():
    results = []
    for jax_side, (mem, tr) in ((True, (jmemory, jtrace)), (False, (tmemory, ttrace))):
        mod, kw = (jc, {}) if jax_side else (tc, {"device": "cpu"})
        metrics = [mod.MulticlassAccuracy(C, validate_args=False, **kw),
                   mod.BinaryAUROC(thresholds=None, validate_args=False, **kw)]
        _drive(metrics[0], *_data("imagenet"), jax_side)
        scores, target = _data("ctr")
        _drive(metrics[1], scores, np.clip(target, 0, 1), jax_side)
        out = mem.record_gauges(metrics)
        report = mem.report(metrics, top_k=5)
        results.append((
            _gauges(tr.get_recorder().snapshot()),
            [(r["labels"] if "labels" in r else {k: v for k, v in r.items() if k not in ("inst", "footprint")})
             for r in out["metrics"]],
            [_by_state(r["footprint"]) for r in out["metrics"]],
            {k: ([_by_state(r) for r in v] if k == "metrics" else v)
             for k, v in report.items() if k != "device_memory_stats"},
        ))
    assert results[1] == results[0]


@pytest.mark.parametrize("n", [None, 0, 1, 1023, 1024, 1536, 1 << 20, 5 * (1 << 30), 3.5e12])
def test_format_bytes_matches_jax(n):
    assert tmemory.format_bytes(n) == jmemory.format_bytes(n)


def test_device_memory_stats_is_empty_without_a_card():
    assert tmemory.device_memory_stats() == {}
    assert tmemory.peak_device_bytes() is None


def test_memory_names_are_jax_names():
    assert sorted(tmemory.__all__) == sorted(jmemory.__all__)
