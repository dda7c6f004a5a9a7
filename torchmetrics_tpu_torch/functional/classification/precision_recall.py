"""Precision and recall: binary, multiclass and multilabel, plus task dispatch.

Counterpart of ``torchmetrics_tpu/functional/classification/precision_recall.py``: both
reduce the stat-score counts, whose macro multiclass update is the confusion-matrix
kernel's histogram; the multilabel counts are plain sums.
"""

from __future__ import annotations

from typing import Optional

import torch

from torchmetrics_tpu_torch.functional.classification._stat_reduce import _precision_recall_reduce
from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
    _binary_stat_scores_update,
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multiclass_stat_scores_update,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
    _multilabel_stat_scores_update,
)
from torchmetrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


def _binary_precision_recall(
    stat: str,
    preds: Tensor,
    target: Tensor,
    threshold: float,
    multidim_average: str,
    ignore_index: Optional[int],
    validate_args: bool,
    zero_division: float,
) -> Tensor:
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, multidim_average, ignore_index)
        _binary_stat_scores_tensor_validation(preds, target, multidim_average, ignore_index)
    preds, target, valid = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    tp, fp, tn, fn = _binary_stat_scores_update(preds, target, valid, multidim_average)
    return _precision_recall_reduce(
        stat, tp, fp, tn, fn, average="binary", multidim_average=multidim_average, zero_division=zero_division
    )


def _multiclass_precision_recall(
    stat: str,
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str],
    top_k: int,
    multidim_average: str,
    ignore_index: Optional[int],
    validate_args: bool,
    zero_division: float,
) -> Tensor:
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, top_k, average, multidim_average, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    preds, target = _multiclass_stat_scores_format(preds, target, top_k)
    tp, fp, tn, fn = _multiclass_stat_scores_update(
        preds, target, num_classes, top_k, average, multidim_average, ignore_index
    )
    return _precision_recall_reduce(
        stat, tp, fp, tn, fn, average=average, multidim_average=multidim_average,
        top_k=top_k, zero_division=zero_division,
    )


def _multilabel_precision_recall(
    stat: str,
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float,
    average: Optional[str],
    multidim_average: str,
    ignore_index: Optional[int],
    validate_args: bool,
    zero_division: float,
) -> Tensor:
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, average, multidim_average, ignore_index)
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    preds, target, valid = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
    tp, fp, tn, fn = _multilabel_stat_scores_update(preds, target, valid, multidim_average)
    return _precision_recall_reduce(
        stat, tp, fp, tn, fn, average=average, multidim_average=multidim_average,
        multilabel=True, zero_division=zero_division,
    )


def binary_precision(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0.0,
) -> Tensor:
    """Precision for binary tasks: ``tp / (tp + fp)``."""
    return _binary_precision_recall(
        "precision", preds, target, threshold, multidim_average, ignore_index, validate_args, zero_division
    )


def multiclass_precision(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0.0,
) -> Tensor:
    """Precision for multiclass tasks."""
    return _multiclass_precision_recall(
        "precision", preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args,
        zero_division,
    )


def multilabel_precision(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0.0,
) -> Tensor:
    """Precision for multilabel tasks."""
    return _multilabel_precision_recall(
        "precision", preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args,
        zero_division,
    )


def binary_recall(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0.0,
) -> Tensor:
    """Recall for binary tasks: ``tp / (tp + fn)``."""
    return _binary_precision_recall(
        "recall", preds, target, threshold, multidim_average, ignore_index, validate_args, zero_division
    )


def multiclass_recall(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    top_k: int = 1,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0.0,
) -> Tensor:
    """Recall for multiclass tasks."""
    return _multiclass_precision_recall(
        "recall", preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args,
        zero_division,
    )


def multilabel_recall(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    average: Optional[str] = "macro",
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0.0,
) -> Tensor:
    """Recall for multilabel tasks."""
    return _multilabel_precision_recall(
        "recall", preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args,
        zero_division,
    )


def _dispatch(
    stat: str,
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float,
    num_classes: Optional[int],
    num_labels: Optional[int],
    average: Optional[str],
    multidim_average: str,
    top_k: int,
    ignore_index: Optional[int],
    validate_args: bool,
    zero_division: float,
) -> Tensor:
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return _binary_precision_recall(
            stat, preds, target, threshold, multidim_average, ignore_index, validate_args, zero_division
        )
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        if not isinstance(top_k, int):
            raise ValueError(f"`top_k` is expected to be `int` but `{type(top_k)} was passed.`")
        return _multiclass_precision_recall(
            stat, preds, target, num_classes, average, top_k, multidim_average, ignore_index, validate_args,
            zero_division,
        )
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return _multilabel_precision_recall(
            stat, preds, target, num_labels, threshold, average, multidim_average, ignore_index, validate_args,
            zero_division,
        )
    raise ValueError(f"Not handled value: {task}")


def precision(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "micro",
    multidim_average: str = "global",
    top_k: int = 1,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0.0,
) -> Tensor:
    """Task-dispatching precision."""
    return _dispatch(
        "precision", preds, target, task, threshold, num_classes, num_labels, average, multidim_average, top_k,
        ignore_index, validate_args, zero_division,
    )


def recall(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "micro",
    multidim_average: str = "global",
    top_k: int = 1,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
    zero_division: float = 0.0,
) -> Tensor:
    """Task-dispatching recall."""
    return _dispatch(
        "recall", preds, target, task, threshold, num_classes, num_labels, average, multidim_average, top_k,
        ignore_index, validate_args, zero_division,
    )
