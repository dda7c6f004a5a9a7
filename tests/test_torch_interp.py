"""The port's ``interp`` against ``jnp.interp``, and the macro-averaged curves built on it.

``jnp.interp`` brackets each query with ``jnp.searchsorted(side="right")``, which JAX
computes by a bisection of fixed depth. On a sorted ``xp`` every binary search agrees;
on an unsorted one (a precision curve is not monotone) each takes its own path, so the
port repeats JAX's. The bracket must be JAX's index on unsorted, tied, NaN and
``-0.0`` inputs, ``interp`` must be ``jnp.interp`` bit for bit, and the macro PR curves
must give JAX's ``mean_precision`` and thresholds bitwise and its ``mean_recall``
within 1e-6 (the mean over classes sums in another order). The macro ROC, whose ``fpr``
is ascending, stays as it was.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torchmetrics_tpu.classification as jc  # noqa: E402
import torchmetrics_tpu.functional.classification as jf  # noqa: E402
import torchmetrics_tpu_torch.classification as tc  # noqa: E402
import torchmetrics_tpu_torch.functional.classification as tf  # noqa: E402
from test_torch_functional import assert_match  # noqa: E402
from torchmetrics_tpu.functional.classification.precision_recall_curve import (  # noqa: E402
    _binary_precision_recall_curve_compute as jax_pr_compute,
)
from torchmetrics_tpu.functional.classification.roc import _binary_roc_compute as jax_roc_compute  # noqa: E402
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (  # noqa: E402
    _binary_precision_recall_curve_static,
)
from torchmetrics_tpu_torch.functional.classification.roc import _binary_roc_static  # noqa: E402
from torchmetrics_tpu_torch.utils.data import interp, searchsorted_right  # noqa: E402

RECALL_ATOL = 1e-6
C = 5


def _case(seed: int):
    """A random ``xp`` of length 1..59 (sorted for seeds divisible by 11; with ties, a
    NaN and a ``-0.0`` for others), ``fp``, and sorted queries with NaN, ±0.0 and
    values outside ``xp``."""
    rng = np.random.RandomState(seed)
    n = rng.randint(1, 60)
    xp = rng.rand(n).astype(np.float32)
    if seed % 3 == 0:
        xp = (np.round(xp * 4) / 4).astype(np.float32)
    if seed % 7 == 0:
        xp[rng.randint(n)] = np.nan
    if seed % 5 == 0:
        xp[rng.randint(n)] = -0.0
    if seed % 11 == 0:
        xp = np.sort(xp)
    x = np.sort(rng.rand(40).astype(np.float32))
    if seed % 4 == 0:
        x = np.concatenate([x, np.array([np.nan, -0.0, 0.0, -1.0, 2.0, 0.25, 0.5], np.float32)])
    return xp, rng.rand(n).astype(np.float32), x


@pytest.mark.parametrize("seed", range(60))
def test_bracket_is_jax_searchsorted_right(seed):
    xp, _, x = _case(seed)
    want = np.asarray(jnp.searchsorted(jnp.asarray(xp), jnp.asarray(x), side="right"))
    got = searchsorted_right(torch.from_numpy(xp), torch.from_numpy(x))
    assert got.dtype == torch.int32  # as JAX's
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(60))
def test_interp_is_jnp_interp_bitwise(seed):
    xp, fp, x = _case(seed)
    want = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp)))
    got = interp(torch.from_numpy(x), torch.from_numpy(xp), torch.from_numpy(fp)).numpy()
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_zero_signs_and_nan_order_as_jax_sorts_them():
    # -0.0 equals 0.0, and a NaN comes after every number, query or entry alike
    xp = np.array([0.5, 0.0, np.nan, -0.0, 1.0, 0.25], np.float32)
    x = np.array([-0.0, 0.0, np.nan, 0.5, 1.0, np.inf, -np.inf], np.float32)
    want = np.asarray(jnp.searchsorted(jnp.asarray(xp), jnp.asarray(x), side="right"))
    np.testing.assert_array_equal(searchsorted_right(torch.from_numpy(xp), torch.from_numpy(x)).numpy(), want)


def test_torch_searchsorted_brackets_elsewhere_on_an_unsorted_xp():
    # a precision curve's shape: why interp cannot use torch.searchsorted
    xp = np.array([0.25, 1.0, 0.0, 1.0, 0.75], np.float32)
    x = np.array([0.25, 0.875], np.float32)
    want = np.asarray(jnp.searchsorted(jnp.asarray(xp), jnp.asarray(x), side="right"))
    torch_index = torch.searchsorted(torch.from_numpy(xp), torch.from_numpy(x), right=True).numpy()
    assert not np.array_equal(torch_index, want)
    np.testing.assert_array_equal(searchsorted_right(torch.from_numpy(xp), torch.from_numpy(x)).numpy(), want)


# ----------------------------------------------------------------- macro curves


def _multiclass(seed: int, n: int = 48, ignore: bool = False):
    """Probabilities made in numpy (the two packages' softmax differ in the last bit,
    and unbinned thresholds are the scores) and int32 targets."""
    rng = np.random.RandomState(seed)
    target = rng.randint(0, C, n).astype(np.int32)
    logits = rng.randn(n, C).astype(np.float32)
    logits[np.arange(n), target] += 1.0
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    if ignore:
        target[rng.rand(n) < 0.15] = -1
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32), target


def _macro_match(want, got) -> None:
    """mean_precision and thresholds bitwise, mean_recall within RECALL_ATOL."""
    (wp, wr, wt), (gp, gr, gt) = want, got
    for w, g in ((wp, gp), (wt, gt)):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype and g.numpy().tobytes() == w.tobytes()
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), atol=RECALL_ATOL, rtol=0)


@pytest.mark.parametrize("thresholds", [None, 11, [0.05, 0.3, 0.5, 0.8]])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("seed", [31, 32])
def test_macro_precision_recall_curve_matches_jax(thresholds, ignore_index, seed):
    preds, target = _multiclass(seed, ignore=ignore_index is not None)
    kw = {"num_classes": C, "thresholds": thresholds, "average": "macro", "ignore_index": ignore_index}
    _macro_match(jf.multiclass_precision_recall_curve(jnp.asarray(preds), jnp.asarray(target), **kw),
                 tf.multiclass_precision_recall_curve(torch.from_numpy(preds), torch.from_numpy(target), **kw))


@pytest.mark.parametrize("thresholds", [None, 11])
def test_macro_precision_recall_curve_class_matches_jax(thresholds):
    jm = jc.MulticlassPrecisionRecallCurve(C, thresholds=thresholds, average="macro")
    tm = tc.MulticlassPrecisionRecallCurve(C, thresholds=thresholds, average="macro", device="cpu")
    for seed in (33, 34, 35):
        preds, target = _multiclass(seed, n=16)
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    _macro_match(jm.compute(), tm.compute())


def test_macro_precision_recall_curve_through_the_task_dispatch():
    preds, target = _multiclass(36)
    kw = {"task": "multiclass", "num_classes": C, "thresholds": 7, "average": "macro"}
    _macro_match(jf.precision_recall_curve(jnp.asarray(preds), jnp.asarray(target), **kw),
                 tf.precision_recall_curve(torch.from_numpy(preds), torch.from_numpy(target), **kw))


@pytest.mark.parametrize("thresholds", [None, 11])
def test_macro_roc_is_unchanged(thresholds):
    preds, target = _multiclass(37)
    kw = {"num_classes": C, "thresholds": thresholds, "average": "macro"}
    assert_match(jf.multiclass_roc(jnp.asarray(preds), jnp.asarray(target), **kw),
                 tf.multiclass_roc(torch.from_numpy(preds), torch.from_numpy(target), **kw), RECALL_ATOL)


# ------------------------------------------- the static curves of a recorded compute


@pytest.mark.parametrize("seed", [41, 42])
def test_static_curves_are_jax_jitted_curves(seed):
    # JAX takes this branch under jit; the port when a CUDA graph records the compute
    rng = np.random.RandomState(seed)
    preds = rng.rand(30).astype(np.float32)
    target = (rng.rand(30) < 0.4).astype(np.int32)
    valid = rng.rand(30) > 0.2
    args = (jnp.asarray(preds), jnp.asarray(target), jnp.asarray(valid))
    targs = (torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(valid))
    want = jax.jit(lambda p, t, v: jax_pr_compute((p, t, v), None))(*args)
    assert_match(want, _binary_precision_recall_curve_static(*targs), RECALL_ATOL)
    want = jax.jit(lambda p, t, v: jax_roc_compute((p, t, v), None))(*args)
    assert_match(want, _binary_roc_static(*targs), RECALL_ATOL)
