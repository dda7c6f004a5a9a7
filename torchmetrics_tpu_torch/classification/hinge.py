"""Hinge loss module classes.

Counterpart of ``torchmetrics_tpu/classification/hinge.py``: float32 sums of the losses
(a scalar, or one per class for ``one-vs-all``) and of the valid samples.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_format,
    _binary_confusion_matrix_tensor_validation,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_tensor_validation,
)
from torchmetrics_tpu_torch.functional.classification.hinge import (
    _binary_hinge_loss_update,
    _hinge_loss_arg_validation,
    _multiclass_hinge_loss_update,
)
from torchmetrics_tpu_torch.utils.data import safe_divide
from torchmetrics_tpu_torch.utils.enums import ClassificationTaskNoMultilabel

Tensor = torch.Tensor


class BinaryHingeLoss(Metric):
    """Binary hinge loss."""

    is_differentiable = True
    higher_is_better = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    measures: Tensor
    total: Tensor

    def __init__(
        self,
        squared: bool = False,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _hinge_loss_arg_validation(squared, ignore_index)
        self.squared = squared
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state("measures", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate hinge-loss sums."""
        if self.validate_args:
            _binary_confusion_matrix_tensor_validation(preds, target, self.ignore_index)
        preds, target, valid = _binary_confusion_matrix_format(
            preds, target, threshold=0.5, ignore_index=self.ignore_index, convert_to_labels=False
        )
        measures, total = _binary_hinge_loss_update(preds, target, valid, self.squared)
        self.measures = self.measures + measures
        self.total = self.total + total

    def compute(self) -> Tensor:
        """Mean hinge loss."""
        return safe_divide(self.measures, self.total)


class MulticlassHingeLoss(Metric):
    """Multiclass hinge loss."""

    is_differentiable = True
    higher_is_better = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    measures: Tensor
    total: Tensor

    def __init__(
        self,
        num_classes: int,
        squared: bool = False,
        multiclass_mode: str = "crammer-singer",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _hinge_loss_arg_validation(squared, ignore_index)
            if multiclass_mode not in ("crammer-singer", "one-vs-all"):
                raise ValueError(
                    f"Expected argument `multiclass_mode` to be one of ('crammer-singer', 'one-vs-all'),"
                    f" but got {multiclass_mode}."
                )
        self.num_classes = num_classes
        self.squared = squared
        self.multiclass_mode = multiclass_mode
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        default = (
            torch.zeros((), dtype=torch.float32)
            if multiclass_mode == "crammer-singer"
            else torch.zeros(num_classes, dtype=torch.float32)
        )
        self.add_state("measures", default, dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate hinge-loss sums."""
        if self.validate_args:
            _multiclass_confusion_matrix_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        preds, target, valid = _multiclass_confusion_matrix_format(
            preds, target, self.ignore_index, convert_to_labels=False
        )
        measures, total = _multiclass_hinge_loss_update(
            preds, target, valid, self.num_classes, self.squared, self.multiclass_mode
        )
        self.measures = self.measures + measures
        self.total = self.total + total

    def compute(self) -> Tensor:
        """Mean hinge loss (per class for one-vs-all mode)."""
        return safe_divide(self.measures, self.total)


class HingeLoss(_ClassificationTaskWrapper):
    """Task-dispatch wrapper for hinge loss (binary / multiclass)."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        num_classes: Optional[int] = None,
        squared: bool = False,
        multiclass_mode: str = "crammer-singer",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ):
        task = ClassificationTaskNoMultilabel.from_str(task)
        kwargs.update({"ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTaskNoMultilabel.BINARY:
            return BinaryHingeLoss(squared, **kwargs)
        if task == ClassificationTaskNoMultilabel.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassHingeLoss(num_classes, squared, multiclass_mode, **kwargs)
        raise ValueError(f"Task {task} not supported!")
