"""Calibration error in the port against the JAX package, functional and stateful,
binary and multiclass.

Inputs come from a numpy seed and go through both packages. The ``bins`` state
(sum of confidences, sum of accuracies, count per bin) is compared with its count
and accuracy rows exactly and its confidence row at ``BINS_RTOL``: JAX sums in
float32 in the order of its one-hot dot product, the port in float64, rounded once.
Values are compared at ``VALUE_ATOL``/``VALUE_RTOL``, which that difference bounds.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import torchmetrics_tpu.classification as jc  # noqa: E402
import torchmetrics_tpu.functional.classification as jf  # noqa: E402
import torchmetrics_tpu_torch.classification as tc  # noqa: E402
import torchmetrics_tpu_torch.functional.classification as tf  # noqa: E402
from torchmetrics_tpu.functional.classification.calibration_error import _binning_update as jax_binning  # noqa: E402
from torchmetrics_tpu_torch.functional.classification.calibration_error import _binning_update  # noqa: E402

BINS_RTOL = 1e-5
VALUE_ATOL, VALUE_RTOL = 1e-6, 1e-5
C = 5


def _binary(seed: int, n: int = 200, logits: bool = False, ignore: bool = False):
    rng = np.random.RandomState(seed)
    target = rng.randint(0, 2, n).astype(np.int32)
    preds = (rng.randn(n) * 2 + target - 0.5) if logits else np.clip(rng.rand(n) * 0.8 + 0.2 * target, 0, 1)
    if ignore:
        target[rng.rand(n) < 0.15] = -1
    return preds.astype(np.float32), target


def _multiclass(seed: int, n: int = 200, logits: bool = False, ignore: bool = False):
    rng = np.random.RandomState(seed)
    target = rng.randint(0, C, n).astype(np.int32)
    scores = rng.randn(n, C).astype(np.float32)
    scores[np.arange(n), target] += 1.0
    if not logits:
        scores = np.exp(scores) / np.exp(scores).sum(axis=1, keepdims=True)
    if ignore:
        target[rng.rand(n) < 0.15] = -1
    return scores.astype(np.float32), target


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=VALUE_ATOL, rtol=VALUE_RTOL)


def _bins_match(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    np.testing.assert_array_equal(got[1:].numpy(), want[1:])
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=BINS_RTOL, atol=0)


FUNCTIONAL = [
    (task, norm, n_bins, ignore, logits)
    for task in ("binary", "multiclass")
    for norm in ("l1", "l2", "max")
    for n_bins in (1, 3, 15)
    for ignore, logits in ((False, False), (True, True))
]


@pytest.mark.parametrize("task, norm, n_bins, ignore, logits", FUNCTIONAL)
def test_functional_matches_jax(task, norm, n_bins, ignore, logits):
    seed = n_bins * 7 + len(norm) + 2 * ignore
    preds, target = (_binary if task == "binary" else _multiclass)(seed, logits=logits, ignore=ignore)
    kw = dict(n_bins=n_bins, norm=norm, ignore_index=-1 if ignore else None)
    if task == "multiclass":
        kw["num_classes"] = C
    want = jf.calibration_error(jnp.asarray(preds), jnp.asarray(target), task, **kw)
    got = tf.calibration_error(torch.from_numpy(preds), torch.from_numpy(target), task, **kw)
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("n_bins", [1, 3, 15])
def test_binning_update_matches_jax_with_bin_edges(n_bins):
    # confidences on the bin edges k/n, at 0 and at 1, where ceil() decides the bin
    rng = np.random.RandomState(n_bins)
    edges = np.arange(n_bins + 1, dtype=np.float32) / np.float32(n_bins)
    conf = np.concatenate([edges, rng.rand(300).astype(np.float32), np.zeros(3, np.float32)])
    acc = (rng.rand(conf.size) < 0.6).astype(np.float32)
    valid = rng.rand(conf.size) >= 0.1
    got = _binning_update(torch.from_numpy(conf), torch.from_numpy(acc), torch.from_numpy(valid), n_bins)
    want = jax_binning(jnp.asarray(conf), jnp.asarray(acc), jnp.asarray(valid), n_bins)
    assert got.dtype == torch.float32 and got.shape == (3, n_bins)
    _bins_match(got, want)


def test_nan_confidence_lands_where_jax_puts_it():
    # JAX casts NaN to the integer 0 (bin 0) and its one-hot contraction spreads the
    # NaN over the whole confidence row (0 * NaN); the count and accuracy rows stay finite
    conf = np.array([0.1, np.nan, 0.9, 0.5, 0.7], dtype=np.float32)
    acc = np.array([1, 0, 1, 0, 1], dtype=np.float32)
    valid = np.array([True, True, True, False, True])
    got = _binning_update(torch.from_numpy(conf), torch.from_numpy(acc), torch.from_numpy(valid), 3)
    want = np.asarray(jax_binning(jnp.asarray(conf), jnp.asarray(acc), jnp.asarray(valid), 3))
    assert np.isnan(want[0]).all() and want[2, 0] == 2
    np.testing.assert_array_equal(got.numpy(), want)  # NaN positions included


@pytest.mark.parametrize("task", ["binary", "multiclass"])
@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
def test_nan_confidence_gives_nan_like_jax(task, norm):
    preds, target = (_binary if task == "binary" else _multiclass)(3, n=50)
    preds[7] = np.nan
    kw = dict(n_bins=10, norm=norm, **({"num_classes": C} if task == "multiclass" else {}))
    want = np.asarray(jf.calibration_error(jnp.asarray(preds), jnp.asarray(target), task, **kw))
    got = tf.calibration_error(torch.from_numpy(preds), torch.from_numpy(target), task, **kw)
    assert np.isnan(want) and torch.isnan(got)


STATEFUL = {
    "binary_l1": (lambda m, **k: m.BinaryCalibrationError(n_bins=15, **k), _binary),
    "binary_max_ignore": (lambda m, **k: m.BinaryCalibrationError(n_bins=4, norm="max", ignore_index=-1, **k),
                          _binary),
    "multiclass_l1": (lambda m, **k: m.MulticlassCalibrationError(C, n_bins=15, **k), _multiclass),
    "multiclass_l2_ignore": (lambda m, **k: m.MulticlassCalibrationError(C, n_bins=3, norm="l2", ignore_index=-1,
                                                                         **k), _multiclass),
    "task_wrapper_multiclass": (lambda m, **k: m.CalibrationError("multiclass", n_bins=7, num_classes=C, **k),
                                _multiclass),
}


@pytest.mark.parametrize("case", sorted(STATEFUL))
def test_stateful_matches_jax(case):
    factory, data = STATEFUL[case]
    jm, tm = factory(jc), factory(tc, device="cpu")
    for step in range(3):
        preds, target = data(seed=100 + step, n=64, logits=step == 1, ignore="ignore" in case)
        _close(tm(torch.from_numpy(preds), torch.from_numpy(target)), jm(jnp.asarray(preds), jnp.asarray(target)))
    _bins_match(tm.bins, jm.bins)
    _close(tm.compute(), jm.compute())


def test_argument_errors_match_jax():
    for kw in (dict(n_bins=0), dict(n_bins=2.5), dict(norm="l3"), dict(ignore_index=1.5)):
        with pytest.raises(ValueError) as want:
            jc.BinaryCalibrationError(**kw)
        with pytest.raises(ValueError) as got:
            tc.BinaryCalibrationError(device="cpu", **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="Invalid Classification"):
        tc.CalibrationError("multilabel", device="cpu")
    with pytest.raises(ValueError, match="larger than 1"):
        tc.MulticlassCalibrationError(1, device="cpu")
