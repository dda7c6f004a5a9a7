"""Precision/recall, Jaccard, Matthews, Cohen's kappa and average precision in the port
against the JAX package, binary and multiclass, functional and stateful.

Inputs come from a numpy seed and go through both packages. The states are integer
counts and compared exactly (``tests/test_torch_slice.py`` does that for the eval
loop); the values are float32 formulas of equal counts, compared at
``ATOL``/``RTOL``, which only the order of float32 sums separates.
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
from torchmetrics_tpu.functional.classification.matthews_corrcoef import (  # noqa: E402
    _matthews_corrcoef_reduce as jax_mcc_reduce,
)
from torchmetrics_tpu_torch.functional.classification.matthews_corrcoef import _matthews_corrcoef_reduce  # noqa: E402

ATOL, RTOL = 1e-6, 1e-5
C = 6


def _labels(seed: int, n: int = 120, ignore: bool = False, binary: bool = False):
    """int32 preds and target (target -1 where ignored)."""
    rng = np.random.RandomState(seed)
    c = 2 if binary else C
    target = rng.randint(0, c, n).astype(np.int32)
    preds = np.where(rng.rand(n) < 0.6, target, rng.randint(0, c, n)).astype(np.int32)
    if ignore:
        target[rng.rand(n) < 0.1] = -1
    return preds, target


def _scores(seed: int, n: int = 120, ignore: bool = False, binary: bool = False):
    """float32 probabilities (binary [N], multiclass [N, C]) and int32 target."""
    rng = np.random.RandomState(seed)
    if binary:
        target = rng.randint(0, 2, n).astype(np.int32)
        preds = np.clip(rng.rand(n) * 0.8 + 0.2 * target, 0, 1).astype(np.float32)
    else:
        target = rng.randint(0, C, n).astype(np.int32)
        logits = rng.randn(n, C).astype(np.float32)
        logits[np.arange(n), target] += 1.0
        preds = (np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)).astype(np.float32)
    if ignore:
        target[rng.rand(n) < 0.1] = -1
    return preds, target


def _close(got, want) -> None:
    if isinstance(want, (list, tuple)):
        for a, b in zip(got, want, strict=True):
            _close(a, b)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def _both(name: str, preds: np.ndarray, target: np.ndarray, *args, **kwargs):
    want = getattr(jf, name)(jnp.asarray(preds), jnp.asarray(target), *args, **kwargs)
    got = getattr(tf, name)(torch.from_numpy(preds), torch.from_numpy(target), *args, **kwargs)
    _close(got, want)


# ------------------------------------------------------------- precision / recall


@pytest.mark.parametrize("stat", ["precision", "recall"])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("top_k", [1, 2])
def test_multiclass_precision_recall_matches_jax(stat, average, top_k):
    preds, target = _scores(seed=len(average) + top_k, ignore=top_k == 1)
    _both(f"multiclass_{stat}", preds, target, C, average=average, top_k=top_k,
          ignore_index=-1 if top_k == 1 else None)


@pytest.mark.parametrize("stat", ["precision", "recall"])
@pytest.mark.parametrize("zero_division", [0.0, 1.0])
def test_binary_precision_recall_matches_jax(stat, zero_division):
    preds, target = _scores(seed=3, binary=True, ignore=True)
    _both(f"binary_{stat}", preds, target, ignore_index=-1, zero_division=zero_division)
    # no predicted (or no actual) positives: the zero-division value
    _both(f"binary_{stat}", np.zeros(8, np.int32), np.zeros(8, np.int32), zero_division=zero_division)


# ------------------------------------------------------------------------ jaccard


@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("ignore_index", [None, -1, 2])
def test_multiclass_jaccard_matches_jax(average, ignore_index):
    preds, target = _labels(seed=len(average), ignore=ignore_index == -1)
    _both("multiclass_jaccard_index", preds, target, C, average=average, ignore_index=ignore_index)


def test_binary_jaccard_matches_jax():
    preds, target = _scores(seed=5, binary=True, ignore=True)
    _both("binary_jaccard_index", preds, target, ignore_index=-1)
    _both("binary_jaccard_index", np.zeros(6, np.int32), np.zeros(6, np.int32), zero_division=1.0)


# ------------------------------------------------------------------------ matthews


@pytest.mark.parametrize("ignore", [False, True])
def test_matthews_matches_jax(ignore):
    preds, target = _labels(seed=7, ignore=ignore)
    _both("multiclass_matthews_corrcoef", preds, target, C, ignore_index=-1 if ignore else None)
    preds, target = _scores(seed=8, binary=True, ignore=ignore)
    _both("binary_matthews_corrcoef", preds, target, ignore_index=-1 if ignore else None)


# the degenerate binary matrices of ``matthews_corrcoef.py:55-67``, as [[tn, fp], [fn, tp]]
DEGENERATE = {
    "all_right_one_class": [[0, 0], [0, 9]],
    "all_right_negatives": [[9, 0], [0, 0]],
    "all_wrong": [[0, 5], [4, 0]],
    "all_wrong_one_class": [[0, 0], [7, 0]],
    "constant_predictor": [[3, 0], [5, 0]],
    "constant_positive_predictor": [[0, 3], [0, 5]],
    "empty": [[0, 0], [0, 0]],
    "general": [[30, 4], [6, 21]],
    "large_counts": [[1_900_000, 100_000], [150_000, 1_850_000]],
}


@pytest.mark.parametrize("case", sorted(DEGENERATE))
def test_matthews_degenerate_cases_match_jax(case):
    confmat = np.array(DEGENERATE[case], dtype=np.int32)
    got = _matthews_corrcoef_reduce(torch.from_numpy(confmat))
    want = jax_mcc_reduce(jnp.asarray(confmat))
    assert got.dtype == torch.float32
    _close(got, want)


def test_multiclass_matthews_zero_denominator_is_zero_like_jax():
    confmat = np.zeros((4, 4), np.int32)
    confmat[:, 2] = [3, 1, 4, 1]  # one predicted class only
    _close(_matthews_corrcoef_reduce(torch.from_numpy(confmat)), jax_mcc_reduce(jnp.asarray(confmat)))


# --------------------------------------------------------------------- cohen kappa


@pytest.mark.parametrize("weights", [None, "none", "linear", "quadratic"])
def test_cohen_kappa_matches_jax(weights):
    preds, target = _labels(seed=11, ignore=True)
    _both("multiclass_cohen_kappa", preds, target, C, weights=weights, ignore_index=-1)
    preds, target = _scores(seed=12, binary=True)
    _both("binary_cohen_kappa", preds, target, weights=weights)


# --------------------------------------------------------------- average precision


@pytest.mark.parametrize("thresholds", [None, 11, [0.0, 0.25, 0.5, 0.8, 1.0]])
def test_binary_average_precision_matches_jax(thresholds):
    preds, target = _scores(seed=13, binary=True, ignore=True)
    _both("binary_average_precision", preds, target, thresholds=thresholds, ignore_index=-1)


@pytest.mark.parametrize("average", ["macro", "weighted", "none"])
@pytest.mark.parametrize("thresholds", [None, 20])
def test_multiclass_average_precision_matches_jax(average, thresholds):
    preds, target = _scores(seed=14, ignore=thresholds is None)
    _both("multiclass_average_precision", preds, target, C, average=average, thresholds=thresholds,
          ignore_index=-1 if thresholds is None else None)


@pytest.mark.parametrize("thresholds", [None, 10])
def test_multiclass_average_precision_with_a_class_without_positives_matches_jax(thresholds):
    preds, target = _scores(seed=15)
    target[target == 4] = 0
    for average in ("macro", "weighted", "none"):
        _both("multiclass_average_precision", preds, target, C, average=average, thresholds=thresholds)


# ------------------------------------------------------------------------ stateful

STATEFUL = {
    "precision_macro": lambda m, **k: m.MulticlassPrecision(C, average="macro", **k),
    "recall_weighted_ignore": lambda m, **k: m.MulticlassRecall(C, average="weighted", ignore_index=-1, **k),
    "precision_binary": lambda m, **k: m.BinaryPrecision(**k),
    "recall_task": lambda m, **k: m.Recall("multiclass", num_classes=C, average="micro", **k),
    "jaccard_macro_ignore": lambda m, **k: m.MulticlassJaccardIndex(C, ignore_index=-1, **k),
    "jaccard_binary": lambda m, **k: m.BinaryJaccardIndex(**k),
    "jaccard_task": lambda m, **k: m.JaccardIndex("multiclass", num_classes=C, average="none", **k),
    "mcc_multiclass": lambda m, **k: m.MulticlassMatthewsCorrCoef(C, **k),
    "mcc_binary_ignore": lambda m, **k: m.BinaryMatthewsCorrCoef(ignore_index=-1, **k),
    "mcc_task": lambda m, **k: m.MatthewsCorrCoef("binary", **k),
    "kappa_linear": lambda m, **k: m.MulticlassCohenKappa(C, weights="linear", **k),
    "kappa_binary": lambda m, **k: m.BinaryCohenKappa(weights="quadratic", **k),
    "kappa_task": lambda m, **k: m.CohenKappa("multiclass", num_classes=C, **k),
    "ap_binary_binned": lambda m, **k: m.BinaryAveragePrecision(thresholds=15, **k),
    "ap_binary_exact_ignore": lambda m, **k: m.BinaryAveragePrecision(ignore_index=-1, **k),
    "ap_multiclass_binned": lambda m, **k: m.MulticlassAveragePrecision(C, thresholds=15, **k),
    "ap_multiclass_exact_weighted": lambda m, **k: m.MulticlassAveragePrecision(C, average="weighted", **k),
    "ap_task": lambda m, **k: m.AveragePrecision("binary", thresholds=[0.2, 0.5, 0.7], **k),
}


@pytest.mark.parametrize("case", sorted(STATEFUL))
def test_stateful_matches_jax(case):
    binary = "binary" in case or case in ("precision_binary", "mcc_task", "ap_task")
    jm, tm = STATEFUL[case](jc), STATEFUL[case](tc, device="cpu")
    for step in range(3):
        preds, target = _scores(seed=20 + step, n=48, binary=binary, ignore="ignore" in case)
        _close(tm(torch.from_numpy(preds), torch.from_numpy(target)), jm(jnp.asarray(preds), jnp.asarray(target)))
    _close(tm.compute(), jm.compute())


@pytest.mark.parametrize("wrapper", ["Precision", "Recall", "JaccardIndex", "MatthewsCorrCoef", "AveragePrecision"])
def test_multilabel_raises_until_its_slice(wrapper):
    # the multilabel slice has landed: the wrapper builds JAX's multilabel class
    m = getattr(tc, wrapper)("multilabel", num_labels=3, device="cpu")
    assert type(m).__name__ == type(getattr(jc, wrapper)("multilabel", num_labels=3)).__name__
    assert type(m).__name__.startswith("Multilabel") and m.num_labels == 3
