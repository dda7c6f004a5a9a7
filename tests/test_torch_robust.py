"""The port's update guards and fault injection held against the JAX package's.

Every case of ``tests/core/test_fault_tolerance.py::TestUpdateGuards`` runs here as one
parametrised scenario, played in both packages on the same seeded numpy batches: the
computed values (floats within ``ATOL`` = 1e-5), the update-guard counters, the
quarantined batches (host copies, reasons, update indices), the ``__robust__``
``state_dict`` entry and the errors raised must be the same. The orbax checkpoint case
waits for the checkpoint module (the migrate slice). ``SpearmanCorrCoef`` (a ragged-list
metric of the JAX case) is not ported: ``BinaryAUROC`` without thresholds, a ragged-list
metric in both packages, takes its place.

The JAX suite's ``MeanSquaredError`` and ``CatMetric`` are not ported yet: small port
metrics below hold the same states and compute the same values.
"""

from __future__ import annotations

import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import torchmetrics_tpu.aggregation as jagg  # noqa: E402
import torchmetrics_tpu.classification as jc  # noqa: E402
import torchmetrics_tpu.regression as jreg  # noqa: E402
import torchmetrics_tpu.robust as jrobust  # noqa: E402
import torchmetrics_tpu.robust.faults as jfaults  # noqa: E402
import torchmetrics_tpu.robust.policy as jpolicy  # noqa: E402
import torchmetrics_tpu_torch.classification as tc  # noqa: E402
import torchmetrics_tpu_torch.robust as trobust  # noqa: E402
import torchmetrics_tpu_torch.robust.faults as tfaults  # noqa: E402
import torchmetrics_tpu_torch.robust.policy as tpolicy  # noqa: E402
from torchmetrics_tpu_torch import Metric  # noqa: E402

ATOL = 1e-5
CPU = {"device": "cpu"}


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


class CatMetric(Metric):
    """The JAX package's ``CatMetric`` (list state)."""

    full_state_update = True

    def __init__(self, **kwargs):
        super().__init__(**{**CPU, **kwargs})
        self.add_state("value", [], dist_reduce_fx="cat")

    def update(self, value):
        self.value.append(value.to(torch.float32).reshape(-1))

    def compute(self):
        return torch.cat(self.value)


JAX = SimpleNamespace(
    name="jax", arr=jnp.asarray, faults=jfaults, robust=jrobust, policy=jpolicy,
    mse=lambda **k: jreg.MeanSquaredError(**k), cat=lambda **k: jagg.CatMetric(**k),
    acc=lambda **k: jc.MulticlassAccuracy(num_classes=3, **k), auroc=lambda **k: jc.BinaryAUROC(**k),
    full=lambda n, v: jnp.full(n, v), zeros=jnp.zeros, ones=jnp.ones,
)
TORCH = SimpleNamespace(
    name="torch", arr=lambda a: torch.as_tensor(np.asarray(a)), faults=tfaults, robust=trobust, policy=tpolicy,
    mse=lambda **k: MeanSquaredError(**k), cat=lambda **k: CatMetric(**k),
    acc=lambda **k: tc.MulticlassAccuracy(num_classes=3, **CPU, **k), auroc=lambda **k: tc.BinaryAUROC(**CPU, **k),
    full=lambda n, v: torch.full((n,), v), zeros=torch.zeros, ones=torch.ones,
)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _counters(m):
    return {"ok": m.updates_ok, "skipped": m.updates_skipped, "quarantined": m.updates_quarantined,
            "last_ok": m.last_update_ok, "count": m.update_count}


def _mse_batches(P, n=5, seed=31):
    rng = np.random.RandomState(seed)
    return [(P.arr(rng.rand(8).astype(np.float32)), P.arr(rng.rand(8).astype(np.float32))) for _ in range(n)]


def _class_batch(P, seed, classes=3):
    rng = np.random.RandomState(seed)
    return P.arr(rng.rand(8, classes).astype(np.float32)), P.arr(rng.randint(0, 3, 8))


def _nan_burst_warn_skip(P):
    batches = _mse_batches(P)
    bad = {1, 3}
    clean = P.mse()
    for i, b in enumerate(batches):
        if i not in bad:
            clean.update(*b)
    guarded = P.mse(error_policy="warn_skip")
    with P.faults.inject_nan_updates(indices=bad):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for b in batches:
                guarded.update(*b)
    np.testing.assert_allclose(_np(guarded.compute()), _np(clean.compute()), atol=0)
    return {"value": _np(guarded.compute()), "counters": _counters(guarded),
            "warned": sum("skipped" in str(w.message) for w in caught)}


def _global_policy_scope(P):
    m = P.mse()
    with P.robust.error_policy("warn_skip"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m.update(P.full(4, float("nan")), P.zeros(4))
    first = _counters(m)
    m.update(P.full(4, float("nan")), P.zeros(4))
    return {"first": first, "after": _counters(m), "nan": bool(np.isnan(_np(m.compute())))}


def _quarantine_retains_host_batch(P):
    m = P.mse(error_policy="quarantine")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.update(P.ones(4), P.zeros(4))
        m.update(P.full(4, float("nan")), P.zeros(4))
    (rec,) = m.quarantined_batches
    out = {"counters": _counters(m), "reason": rec["reason"], "index": rec["update_index"],
           "host": isinstance(rec["args"][0], np.ndarray), "nan": bool(np.isnan(rec["args"][0]).all()),
           "value": _np(m.compute())}
    m.clear_quarantine()
    out["cleared"] = m.quarantined_batches == []
    return out


def _exception_rolled_back(P):
    m = P.acc(error_policy="warn_skip")
    m.update(*_class_batch(P, 0))
    before = _np(m.compute())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.update(*_class_batch(P, 1, classes=5))
    np.testing.assert_allclose(_np(m.compute()), before, atol=0)
    return {"counters": _counters(m), "value": before}


def _list_state_rollback(P):
    m = P.cat(error_policy="warn_skip")
    m.update(P.arr(np.array([1.0, 2.0], np.float32)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.update(P.arr(np.array([np.nan, 4.0], np.float32)))
    return {"value": _np(m.compute()), "counters": _counters(m)}


def _raise_policy_detects_nonfinite(P):
    m = P.mse(error_policy="raise")
    m.update(P.ones(4), P.zeros(4))
    with pytest.raises(P.policy.UpdateGuardError, match="non-finite") as err:
        m.update(P.full(4, float("nan")), P.zeros(4))
    return {"counters": _counters(m), "value": _np(m.compute()), "message": str(err.value)}


def _default_policy_is_legacy(P):
    assert P.robust.get_error_policy() is None
    m = P.mse()
    m.update(P.full(4, float("nan")), P.zeros(4))
    m2 = P.acc()
    with pytest.raises(Exception):
        m2.update(*_class_batch(P, 2, classes=5))
    sd = P.mse().state_dict(persistent_only=False)
    return {"nan": bool(np.isnan(_np(m.compute()))), "robust_key": any(k.startswith("__robust__") for k in sd),
            "last_ok": m2.last_update_ok}


def _forward_skips_bad_batch(P):
    batches = _mse_batches(P, 3, seed=32)
    clean = P.mse()
    for i, b in enumerate(batches):
        if i != 1:
            clean(*b)
    guarded = P.mse(error_policy="warn_skip")
    outs = []
    with P.faults.inject_nan_updates(indices={1}):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for b in batches:
                outs.append(guarded(*b))
    np.testing.assert_allclose(_np(guarded.compute()), _np(clean.compute()), atol=0)
    return {"value": _np(guarded.compute()), "counters": _counters(guarded),
            "batch_values": [None if o is None else _np(o) for o in outs]}


def _forward_raise_restores(P):
    m = P.mse(error_policy="raise")
    m(P.ones(4), P.zeros(4))
    with pytest.raises(P.policy.UpdateGuardError):
        m(P.full(4, float("nan")), P.zeros(4))
    return {"count": m.update_count, "value": _np(m.compute())}


def _forward_skip_on_list_state(P):
    rng = np.random.RandomState(33)
    p, t = P.arr(rng.rand(8).astype(np.float32)), P.arr(rng.randint(0, 2, 8))
    m = P.auroc(error_policy="warn_skip")
    m(p, t)
    before = _np(m.compute())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = m(P.full(8, float("nan")), t)
    np.testing.assert_allclose(_np(m.compute()), before, atol=0)
    return {"out": out, "counters": _counters(m), "value": before}


def _guarded_clean_run_roundtrips(P):
    m = P.mse(error_policy="warn_skip")
    m.update(P.ones(4), P.zeros(4))
    m.update(P.ones(4), P.zeros(4))
    sd = m.state_dict(persistent_only=False)
    m2 = P.mse()
    m2.load_state_dict(sd)
    return {"robust": _np(sd["__robust__"]).tolist(), "loaded": _counters(m2)}


def _unguarded_raise_keeps_legacy(P):
    m = P.acc()
    with pytest.raises(Exception):
        m.update(*_class_batch(P, 3, classes=5))
    return {"last_ok": m.last_update_ok, "robust_key": "__robust__" in m.state_dict(persistent_only=False)}


def _counters_roundtrip_state_dict(P):
    m = P.mse(error_policy="warn_skip")
    m.update(P.ones(4), P.zeros(4))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.update(P.full(4, float("nan")), P.zeros(4))
    sd = m.state_dict(persistent_only=False)
    m2 = P.mse()
    m2.load_state_dict(sd)
    np.testing.assert_allclose(_np(m2.compute()), _np(m.compute()), atol=0)
    return {"robust": _np(sd["__robust__"]).tolist(), "loaded": _counters(m2), "value": _np(m2.compute())}


def _reset_clears_counters(P):
    m = P.mse(error_policy="warn_skip")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m.update(P.full(4, float("nan")), P.zeros(4))
    m.reset()
    return {"counters": _counters(m), "quarantine": m.quarantined_batches}


def _invalid_policy_rejected(P):
    with pytest.raises(ValueError, match="Invalid error policy") as a:
        P.mse(error_policy="explode")
    with pytest.raises(ValueError, match="Invalid error policy") as b:
        P.robust.set_error_policy("explode")
    return {"messages": [str(a.value), str(b.value)]}


def _nonfinite_step_indices(P):
    rng = np.random.RandomState(34)
    stacked = rng.rand(6, 4, 3).astype(np.float32)
    stacked[1, 2, 0] = np.nan
    stacked[4, 0, 1] = np.inf
    labels = rng.randint(0, 3, (6, 4))
    return P.policy.nonfinite_step_indices([P.arr(stacked), P.arr(labels)])


def _first_nonfinite(P):
    return [P.policy.first_nonfinite((P.ones(3), [P.ones(2), P.full(2, float("nan"))]), {}),
            P.policy.first_nonfinite((P.ones(3),), {"weight": P.full(1, float("inf"))}),
            P.policy.first_nonfinite((P.ones(3), 1.0, "s"), {})]


SCENARIOS = {
    "nan_burst_warn_skip_equals_clean_run": _nan_burst_warn_skip,
    "global_policy_scope": _global_policy_scope,
    "quarantine_retains_host_batch": _quarantine_retains_host_batch,
    "exception_inside_update_skipped_and_rolled_back": _exception_rolled_back,
    "list_state_rollback": _list_state_rollback,
    "raise_policy_detects_nonfinite": _raise_policy_detects_nonfinite,
    "default_policy_is_legacy": _default_policy_is_legacy,
    "forward_skips_bad_batch": _forward_skips_bad_batch,
    "forward_raise_policy_restores_global_state": _forward_raise_restores,
    "forward_skip_on_list_state_metric_returns_none_and_keeps_state": _forward_skip_on_list_state,
    "guarded_clean_run_roundtrips_updates_ok": _guarded_clean_run_roundtrips,
    "unguarded_raise_keeps_legacy_state_dict": _unguarded_raise_keeps_legacy,
    "counters_roundtrip_state_dict": _counters_roundtrip_state_dict,
    "reset_clears_counters": _reset_clears_counters,
    "invalid_policy_rejected": _invalid_policy_rejected,
    "nonfinite_step_indices": _nonfinite_step_indices,
    "first_nonfinite": _first_nonfinite,
}


def _assert_same(a, b, where):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), atol=ATOL, rtol=0,
                                   err_msg=where)
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, abs=ATOL), where
    else:
        assert a == b, f"{where}: {a!r} != {b!r}"


@pytest.fixture(autouse=True)
def _no_global_policy():
    jrobust.set_error_policy(None)
    trobust.set_error_policy(None)
    yield
    jrobust.set_error_policy(None)
    trobust.set_error_policy(None)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_update_guard_scenario_matches_jax(scenario):
    _assert_same(SCENARIOS[scenario](JAX), SCENARIOS[scenario](TORCH), scenario)


# ------------------------------------------------------------------ port-only checks


def test_collective_and_download_fault_plans():
    assert not tfaults.collective_faults_active()
    with tfaults.inject_collective_fault("hang", times=2):
        assert tfaults.collective_faults_active()
        assert [tfaults.next_collective_fault() for _ in range(3)] == ["hang", "hang", None]
    with pytest.raises(ValueError, match="mode"):
        with tfaults.inject_collective_fault("explode"):
            pass
    with tfaults.inject_download_fault("truncate", times=1):
        assert tfaults.corrupt_download(b"abcd") == b"ab"
        assert tfaults.corrupt_download(b"abcd") == b"abcd"
    with tfaults.inject_download_fault("corrupt"):
        assert tfaults.corrupt_download(b"\x00b") == b"\xffb"
    with pytest.raises(ValueError, match="corruptor"):
        with tfaults.inject_download_fault("custom"):
            pass


def test_nan_injection_leaves_integer_tensors_alone():
    with tfaults.inject_nan_updates(every=2) as plan:
        hit = tfaults.apply_update_fault((torch.ones(2), torch.ones(2, dtype=torch.int64)), {"w": np.ones(2)})
        miss = tfaults.apply_update_fault((torch.ones(2),), {})
    assert plan["seen"] == 2
    assert torch.isnan(hit[0][0]).all() and hit[0][1].dtype == torch.int64 and np.isnan(hit[1]["w"]).all()
    assert torch.equal(miss[0][0], torch.ones(2))
