"""Multiclass curves of the port (PR curve, ROC, AUROC) held against the JAX package on the CPU.

Same inputs and tolerances as ``test_torch_curves.py``: integers exactly, floats
within 1e-6.
"""

from __future__ import annotations

import pytest
import torch

torch.set_num_threads(2)

import torchmetrics_tpu.functional.classification as jf  # noqa: E402
import torchmetrics_tpu_torch.functional.classification as tf  # noqa: E402
from test_torch_functional import C, _multiclass_inputs, both  # noqa: E402


@pytest.mark.parametrize("thresholds", [None, 20])
@pytest.mark.parametrize("average", [None, "micro"])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("fn", ["multiclass_precision_recall_curve", "multiclass_roc"])
def test_multiclass_curves(fn, thresholds, average, ignore_index):
    preds, target = _multiclass_inputs(17, ignore_index, kind="logits", multidim=False)
    both(getattr(jf, fn), getattr(tf, fn), preds, target, num_classes=C, thresholds=thresholds,
         average=average, ignore_index=ignore_index)


@pytest.mark.parametrize("thresholds", [None, 20])
def test_multiclass_roc_macro(thresholds):
    preds, target = _multiclass_inputs(18, None, multidim=False)
    both(jf.multiclass_roc, tf.multiclass_roc, preds, target, num_classes=C, thresholds=thresholds, average="macro")


def test_macro_precision_recall_curve_is_not_ported_yet():
    # ported: the binned macro curve equals JAX's (tests/test_torch_interp.py holds the rest)
    preds, target = _multiclass_inputs(18, None, multidim=False)
    both(jf.multiclass_precision_recall_curve, tf.multiclass_precision_recall_curve, preds, target,
         num_classes=C, thresholds=5, average="macro")


@pytest.mark.parametrize("thresholds", [None, 50])
@pytest.mark.parametrize("average", ["macro", "weighted", "none"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_multiclass_auroc(thresholds, average, ignore_index):
    preds, target = _multiclass_inputs(19, ignore_index, multidim=False)
    both(jf.multiclass_auroc, tf.multiclass_auroc, preds, target, num_classes=C, thresholds=thresholds,
         average=average, ignore_index=ignore_index)
