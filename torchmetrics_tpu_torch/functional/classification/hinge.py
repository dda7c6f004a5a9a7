"""Hinge loss: binary and multiclass, plus task dispatch.

Counterpart of ``torchmetrics_tpu/functional/classification/hinge.py`` (``squared``;
multiclass modes ``crammer-singer`` and ``one-vs-all``). The state is float32 sums.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_format,
    _binary_confusion_matrix_tensor_validation,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_tensor_validation,
)
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _maybe_softmax
from torchmetrics_tpu_torch.utils.data import one_hot, safe_divide
from torchmetrics_tpu_torch.utils.enums import ClassificationTaskNoMultilabel

Tensor = torch.Tensor


def _hinge_loss_arg_validation(squared: bool, ignore_index: Optional[int] = None) -> None:
    if not isinstance(squared, bool):
        raise ValueError(f"Expected argument `squared` to be an bool but got {squared}")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _binary_hinge_loss_update(
    preds: Tensor, target: Tensor, valid: Tensor, squared: bool
) -> Tuple[Tensor, Tensor]:
    """(Σ losses, n): target mapped to ±1, margin = 1 - t·p."""
    target_pm = target.to(torch.float32) * 2.0 - 1.0
    margin = 1.0 - target_pm * preds.to(torch.float32)
    losses = margin.clamp_min(0.0)
    if squared:
        losses = losses**2
    v = valid.to(torch.float32)
    return (losses * v).sum(), v.sum()


def binary_hinge_loss(
    preds: Tensor,
    target: Tensor,
    squared: bool = False,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Mean hinge loss for binary tasks."""
    if validate_args:
        _hinge_loss_arg_validation(squared, ignore_index)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target, valid = _binary_confusion_matrix_format(
        preds, target, threshold=0.5, ignore_index=ignore_index, convert_to_labels=False
    )
    measures, total = _binary_hinge_loss_update(preds, target, valid, squared)
    return safe_divide(measures, total)


def _multiclass_hinge_loss_update(
    preds: Tensor,
    target: Tensor,
    valid: Tensor,
    num_classes: int,
    squared: bool,
    multiclass_mode: str,
) -> Tuple[Tensor, Tensor]:
    """(Σ losses [scalar or C], n)."""
    preds = _maybe_softmax(preds, dim=-1).to(torch.float32)
    target_oh = one_hot(target, num_classes, dtype=torch.float32)
    v = valid.to(torch.float32)
    if multiclass_mode == "crammer-singer":
        margin = (preds * target_oh).sum(dim=-1) - torch.where(
            target_oh == 1, torch.full_like(preds, float("-inf")), preds
        ).amax(dim=-1)
        losses = (1.0 - margin).clamp_min(0.0)
        if squared:
            losses = losses**2
        return (losses * v).sum(), v.sum()
    # one-vs-all: per-class binary hinge on ±1 targets
    target_pm = target_oh * 2.0 - 1.0
    losses = (1.0 - target_pm * preds).clamp_min(0.0)
    if squared:
        losses = losses**2
    return (losses * v[:, None]).sum(dim=0), v.sum()


def multiclass_hinge_loss(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    squared: bool = False,
    multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Mean hinge loss for multiclass tasks."""
    if validate_args:
        _hinge_loss_arg_validation(squared, ignore_index)
        if multiclass_mode not in ("crammer-singer", "one-vs-all"):
            raise ValueError(
                f"Expected argument `multiclass_mode` to be one of ('crammer-singer', 'one-vs-all'),"
                f" but got {multiclass_mode}."
            )
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, valid = _multiclass_confusion_matrix_format(
        preds, target, ignore_index, convert_to_labels=False
    )
    measures, total = _multiclass_hinge_loss_update(preds, target, valid, num_classes, squared, multiclass_mode)
    return safe_divide(measures, total)


def hinge_loss(
    preds: Tensor,
    target: Tensor,
    task: str,
    num_classes: Optional[int] = None,
    squared: bool = False,
    multiclass_mode: str = "crammer-singer",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching hinge loss (binary and multiclass)."""
    task = ClassificationTaskNoMultilabel.from_str(task)
    if task == ClassificationTaskNoMultilabel.BINARY:
        return binary_hinge_loss(preds, target, squared, ignore_index, validate_args)
    if task == ClassificationTaskNoMultilabel.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_hinge_loss(
            preds, target, num_classes, squared, multiclass_mode, ignore_index, validate_args
        )
    raise ValueError(f"Not handled value: {task}")
