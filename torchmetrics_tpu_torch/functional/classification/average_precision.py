"""Average precision: binary, multiclass and multilabel, plus task dispatch.

Counterpart of ``torchmetrics_tpu/functional/classification/average_precision.py``:
``AP = sum_n (R_n - R_{n-1}) * P_n`` over the precision-recall curve. The binned
binary update counts with the binned-curve kernel on the card; the binned multiclass
and multilabel updates are the plain ``einsum`` of the curve module.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

from torchmetrics_tpu_torch.functional.classification.auroc import _multilabel_weights, _validate_average_arg
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    CurveState,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from torchmetrics_tpu_torch.utils.data import safe_divide
from torchmetrics_tpu_torch.utils.enums import ClassificationTask
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


def _ap_from_curve(precision: Tensor, recall: Tensor) -> Tensor:
    """AP from curves with decreasing recall along the last axis (one curve or a batch)."""
    return -((recall[..., 1:] - recall[..., :-1]) * precision[..., :-1]).sum(dim=-1)


def _reduce_average_precision(
    precision: Union[Tensor, List[Tensor]],
    recall: Union[Tensor, List[Tensor]],
    average: Optional[str] = "macro",
    weights: Optional[Tensor] = None,
) -> Tensor:
    if isinstance(precision, Tensor):
        res = _ap_from_curve(precision, recall)
        if precision.ndim == 1:
            return res
    else:
        res = torch.stack([_ap_from_curve(p, r) for p, r in zip(precision, recall)])
    if average in (None, "none"):
        return res
    idx = ~torch.isnan(res)
    if not bool(idx.all()):
        rank_zero_warn(
            "Average precision score for one or more classes was `nan`. Ignoring these classes in average",
            UserWarning,
        )
    zero = torch.zeros_like(res)
    if average == "macro":
        return torch.where(idx, res, zero).sum() / idx.sum()
    if average == "weighted" and weights is not None:
        weights = torch.where(idx, weights, torch.zeros_like(weights))
        weights = safe_divide(weights, weights.sum())
        return torch.where(idx, res * weights, zero).sum()
    raise ValueError("Received an incompatible combinations of inputs to make reduction.")


def _binary_average_precision_compute(
    state: CurveState,
    thresholds: Optional[Tensor],
    pos_label: int = 1,
) -> Tensor:
    precision, recall, _ = _binary_precision_recall_curve_compute(state, thresholds, pos_label)
    return _ap_from_curve(precision, recall)


def binary_average_precision(
    preds: Tensor,
    target: Tensor,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Average precision for binary tasks."""
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, valid, thresholds = _binary_precision_recall_curve_format(preds, target, thresholds, ignore_index)
    state = _binary_precision_recall_curve_update(preds, target, valid, thresholds)
    return _binary_average_precision_compute(state, thresholds)


def _multiclass_average_precision_compute(
    state: CurveState,
    num_classes: int,
    thresholds: Optional[Tensor],
    average: Optional[str] = "macro",
) -> Tensor:
    precision, recall, _ = _multiclass_precision_recall_curve_compute(state, num_classes, thresholds)
    if isinstance(state, Tensor) and thresholds is not None:
        weights = state[0, :, 1, :].sum(dim=-1).to(torch.float32)  # per-class support
    else:
        _, target, valid = state
        weights = torch.stack([((target == c) & valid).sum().to(torch.float32) for c in range(num_classes)])
    return _reduce_average_precision(precision, recall, average, weights)


def multiclass_average_precision(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Average precision for multiclass tasks (one-vs-rest)."""
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
        _validate_average_arg(average)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, valid, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, valid, num_classes, thresholds)
    return _multiclass_average_precision_compute(state, num_classes, thresholds, average)


def _multilabel_average_precision_compute(
    state: CurveState,
    num_labels: int,
    thresholds: Optional[Tensor],
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
) -> Tensor:
    if average == "micro":
        if isinstance(state, Tensor) and thresholds is not None:
            return _binary_average_precision_compute(state.sum(dim=1), thresholds)
        preds, target, valid = state
        return _binary_average_precision_compute((preds.reshape(-1), target.reshape(-1), valid.reshape(-1)), None)
    precision, recall, _ = _multilabel_precision_recall_curve_compute(state, num_labels, thresholds, ignore_index)
    return _reduce_average_precision(precision, recall, average, _multilabel_weights(state, thresholds))


def multilabel_average_precision(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    average: Optional[str] = "macro",
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Average precision for multilabel tasks (micro: one curve over every (sample, label) pair)."""
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _validate_average_arg(average, allowed=("micro", "macro", "weighted", "none", None))
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, valid, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, valid, num_labels, thresholds)
    return _multilabel_average_precision_compute(state, num_labels, thresholds, average, ignore_index)


def average_precision(
    preds: Tensor,
    target: Tensor,
    task: str,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "macro",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching average precision."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_average_precision(preds, target, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_average_precision(preds, target, num_classes, average, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_average_precision(
            preds, target, num_labels, average, thresholds, ignore_index, validate_args
        )
    raise ValueError(f"Not handled value: {task}")
