"""Matthews correlation coefficient: binary, multiclass and multilabel, plus task dispatch.

Counterpart of ``torchmetrics_tpu/functional/classification/matthews_corrcoef.py``:
computed from the confusion matrix (the confusion-matrix kernel on the card), with the
JAX package's formula and its float32 arithmetic. ``s**2 - sum(pk**2)`` cancels at
large sample counts (at 4e6 samples one float32 ulp of ``s**2`` is 2^21), and the
card and the CPU sum the class marginals in different orders, so the two agree to
about 1e-6 absolute rather than bitwise. A multilabel ``[L, 2, 2]`` state is summed
to one 2x2 matrix first.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_arg_validation,
    _binary_confusion_matrix_format,
    _binary_confusion_matrix_tensor_validation,
    _binary_confusion_matrix_update,
    _multiclass_confusion_matrix_arg_validation,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_tensor_validation,
    _multiclass_confusion_matrix_update,
    _multilabel_confusion_matrix_arg_validation,
    _multilabel_confusion_matrix_format,
    _multilabel_confusion_matrix_tensor_validation,
    _multilabel_confusion_matrix_update,
)
from torchmetrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor

_EPS = float(np.finfo(np.float32).eps)
_SQRT_EPS = float(np.sqrt(np.float32(_EPS)))  # rounded to float32, as JAX computes it


def _matthews_corrcoef_reduce(confmat: Tensor) -> Tensor:
    """MCC from a [C, C] confusion matrix (a multilabel [L, 2, 2] one is summed over its
    labels first); a zero denominator gives 0.

    A binary matrix with a zero covariance denominator takes the eps-regularised
    formula instead, which gives +-1 for perfect and inverted constant predictors.
    """
    if confmat.ndim == 3:
        confmat = confmat.sum(dim=0)
    confmat = confmat.to(torch.float32)
    tk = confmat.sum(dim=-1)
    pk = confmat.sum(dim=-2)
    c = torch.trace(confmat)
    s = confmat.sum()
    cov_ytyp = c * s - (tk * pk).sum()
    cov_ypyp = s**2 - (pk * pk).sum()
    cov_ytyt = s**2 - (tk * tk).sum()
    denom = cov_ypyp * cov_ytyt
    positive = denom > 0
    general = cov_ytyp / torch.sqrt(torch.where(positive, denom, torch.ones_like(denom)))

    if confmat.numel() == 4:
        tn, fp = confmat[0, 0], confmat[0, 1]
        fn, tp = confmat[1, 0], confmat[1, 1]
        a = tp + tn
        b = fp + fn
        num_eps = _SQRT_EPS * (a - b)
        denom_eps = (tp + fp + _EPS) * (tp + fn + _EPS) * (tn + fp + _EPS) * (tn + fn + _EPS)
        res = torch.where(positive, general, num_eps / torch.sqrt(denom_eps))
        one = torch.ones_like(res)
        res = torch.where((b == 0) & (a != 0), one, res)
        return torch.where((a == 0) & (b != 0), -one, res)
    return torch.where(positive, general, torch.zeros_like(general))


def binary_matthews_corrcoef(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """MCC for binary tasks."""
    if validate_args:
        _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize=None)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target, valid = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    return _matthews_corrcoef_reduce(_binary_confusion_matrix_update(preds, target, valid))


def multiclass_matthews_corrcoef(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """MCC for multiclass tasks."""
    if validate_args:
        _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize=None)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, valid = _multiclass_confusion_matrix_format(preds, target, ignore_index)
    return _matthews_corrcoef_reduce(_multiclass_confusion_matrix_update(preds, target, valid, num_classes))


def multilabel_matthews_corrcoef(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """MCC for multilabel tasks, over the summed per-label 2x2 matrices."""
    if validate_args:
        _multilabel_confusion_matrix_arg_validation(num_labels, threshold, ignore_index, normalize=None)
        _multilabel_confusion_matrix_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, valid = _multilabel_confusion_matrix_format(preds, target, num_labels, threshold, ignore_index)
    return _matthews_corrcoef_reduce(_multilabel_confusion_matrix_update(preds, target, valid, num_labels))


def matthews_corrcoef(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching MCC."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_matthews_corrcoef(preds, target, threshold, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_matthews_corrcoef(preds, target, num_classes, ignore_index, validate_args)
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_matthews_corrcoef(preds, target, num_labels, threshold, ignore_index, validate_args)
    raise ValueError(f"Not handled value: {task}")
