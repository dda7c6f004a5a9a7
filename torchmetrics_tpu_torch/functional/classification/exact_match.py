"""Exact match (subset accuracy): multiclass and multilabel, plus task dispatch.

Counterpart of ``torchmetrics_tpu/functional/classification/exact_match.py``. A sample
counts as correct only if every element (multidim position or label) matches;
``ignore_index`` positions are masked out of the all-reduce.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _multiclass_stat_scores_arg_validation,
    _multiclass_stat_scores_format,
    _multiclass_stat_scores_tensor_validation,
    _multilabel_stat_scores_arg_validation,
    _multilabel_stat_scores_format,
    _multilabel_stat_scores_tensor_validation,
)
from torchmetrics_tpu_torch.utils.data import safe_divide
from torchmetrics_tpu_torch.utils.enums import ClassificationTaskNoBinary

Tensor = torch.Tensor


def _exact_match_reduce(correct: Tensor, total: Tensor) -> Tensor:
    return safe_divide(correct, total)


def _multiclass_exact_match_update(
    preds: Tensor,
    target: Tensor,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    """Per-sample all-match indicator; returns (correct, total)."""
    valid = torch.ones_like(target, dtype=torch.bool) if ignore_index is None else target != ignore_index
    match = (preds == target) | ~valid
    correct = match.all(dim=1).to(torch.int32)
    if multidim_average == "global":
        return correct.sum(dtype=torch.int32), torch.full((), target.shape[0], dtype=torch.int32, device=target.device)
    return correct, torch.ones_like(correct)


def multiclass_exact_match(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Exact match for multidim multiclass tasks."""
    if validate_args:
        _multiclass_stat_scores_arg_validation(num_classes, 1, None, multidim_average, ignore_index)
        _multiclass_stat_scores_tensor_validation(preds, target, num_classes, multidim_average, ignore_index)
    preds, target = _multiclass_stat_scores_format(preds, target, 1)
    correct, total = _multiclass_exact_match_update(preds, target, multidim_average, ignore_index)
    return _exact_match_reduce(correct, total)


def _multilabel_exact_match_update(
    preds: Tensor,
    target: Tensor,
    valid: Tensor,
    num_labels: int,
    multidim_average: str = "global",
) -> Tuple[Tensor, Tensor]:
    """Per-sample all-labels-match indicator over [N, L, X] inputs."""
    match = (preds == target) | ~valid
    correct = match.all(dim=1).to(torch.int32)  # [N, X]
    if multidim_average == "global":
        return correct.sum(dtype=torch.int32), torch.full((), correct.numel(), dtype=torch.int32, device=correct.device)
    return correct.sum(dim=1, dtype=torch.int32), torch.full(
        (correct.shape[0],), correct.shape[1], dtype=torch.int32, device=correct.device
    )


def multilabel_exact_match(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Exact match for multilabel tasks."""
    if validate_args:
        _multilabel_stat_scores_arg_validation(num_labels, threshold, None, multidim_average, ignore_index)
        _multilabel_stat_scores_tensor_validation(preds, target, num_labels, multidim_average, ignore_index)
    preds, target, valid = _multilabel_stat_scores_format(preds, target, num_labels, threshold, ignore_index)
    correct, total = _multilabel_exact_match_update(preds, target, valid, num_labels, multidim_average)
    return _exact_match_reduce(correct, total)


def exact_match(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    multidim_average: str = "global",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching exact match (multiclass and multilabel only)."""
    task = ClassificationTaskNoBinary.from_str(task)
    if task == ClassificationTaskNoBinary.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_exact_match(preds, target, num_classes, multidim_average, ignore_index, validate_args)
    if task == ClassificationTaskNoBinary.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_exact_match(
            preds, target, num_labels, threshold, multidim_average, ignore_index, validate_args
        )
    raise ValueError(f"Not handled value: {task}")
