"""Jaccard index (IoU): binary and multiclass, plus task dispatch.

Counterpart of ``torchmetrics_tpu/functional/classification/jaccard.py``: computed from
the confusion matrix (the confusion-matrix kernel on the card), per class
``diag / (rowsum + colsum - diag)``. Multilabel comes with a later slice.
"""

from __future__ import annotations

from typing import Optional

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
)
from torchmetrics_tpu_torch.functional.classification.stat_scores import _multilabel_not_ported
from torchmetrics_tpu_torch.utils.data import safe_divide
from torchmetrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


def _jaccard_index_arg_validation(average: Optional[str]) -> None:
    allowed_average = ("micro", "macro", "weighted", "none", None, "binary")
    if average not in allowed_average:
        raise ValueError(f"Expected argument `average` to be one of {allowed_average}, but got {average}.")


def _jaccard_index_reduce(
    confmat: Tensor,
    average: Optional[str],
    ignore_index: Optional[int] = None,
    zero_division: float = 0.0,
) -> Tensor:
    """The Jaccard score from a [C, C] confusion matrix.

    An ``ignore_index`` that is a valid class id is left out of the micro sums and of
    the macro and weighted weights.
    """
    confmat = confmat.to(torch.float32)
    if average == "binary":
        return safe_divide(confmat[1, 1], confmat[0, 1] + confmat[1, 0] + confmat[1, 1], zero_division)

    ignore_index_cond = ignore_index is not None and 0 <= ignore_index < confmat.shape[0]
    num = torch.diagonal(confmat)
    denom = confmat.sum(dim=0) + confmat.sum(dim=1) - num
    keep = torch.arange(num.shape[0], device=confmat.device) != ignore_index if ignore_index_cond else None

    if average == "micro":
        if keep is not None:
            num = torch.where(keep, num, torch.zeros_like(num))
            denom = torch.where(keep, denom, torch.zeros_like(denom))
        return safe_divide(num.sum(), denom.sum(), zero_division)

    jaccard = safe_divide(num, denom, zero_division)
    if average is None or average == "none":
        return jaccard
    if average == "weighted":
        weights = confmat.sum(dim=1)
    else:
        weights = torch.ones_like(jaccard)
        weights = torch.where(confmat.sum(dim=1) + confmat.sum(dim=0) == 0, torch.zeros_like(weights), weights)
    if keep is not None:
        weights = torch.where(keep, weights, torch.zeros_like(weights))
    return (weights * jaccard / weights.sum()).sum()


def binary_jaccard_index(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0.0,
) -> Tensor:
    """Jaccard index for binary tasks."""
    if validate_args:
        _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize=None)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target, valid = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    confmat = _binary_confusion_matrix_update(preds, target, valid)
    return _jaccard_index_reduce(confmat, average="binary", zero_division=zero_division)


def multiclass_jaccard_index(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0.0,
) -> Tensor:
    """Jaccard index for multiclass tasks."""
    if validate_args:
        _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize=None)
        _jaccard_index_arg_validation(average)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, valid = _multiclass_confusion_matrix_format(preds, target, ignore_index)
    confmat = _multiclass_confusion_matrix_update(preds, target, valid, num_classes)
    return _jaccard_index_reduce(confmat, average, ignore_index, zero_division)


def jaccard_index(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0.0,
) -> Tensor:
    """Task-dispatching Jaccard index."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_jaccard_index(preds, target, threshold, ignore_index, validate_args, zero_division)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_jaccard_index(preds, target, num_classes, average, ignore_index, validate_args, zero_division)
    raise _multilabel_not_ported("jaccard_index")
