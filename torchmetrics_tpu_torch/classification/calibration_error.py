"""Calibration error module classes.

Counterpart of ``torchmetrics_tpu/classification/calibration_error.py``. The state is
``bins``, the float32 ``[3, n_bins]`` accumulator of the functional module (sum of
confidences, sum of accuracies, count per bin), under the JAX package's key, so a
JAX metric's state loads into the port (``convert.jax_state``).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.functional.classification.calibration_error import (
    _binary_calibration_error_update,
    _binning_update,
    _calibration_error_arg_validation,
    _ce_compute_from_bins,
    _multiclass_calibration_error_update,
)
from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_format,
    _binary_confusion_matrix_tensor_validation,
    _multiclass_confusion_matrix_format,
    _multiclass_confusion_matrix_tensor_validation,
)
from torchmetrics_tpu_torch.utils.enums import ClassificationTaskNoMultilabel

Tensor = torch.Tensor


class BinaryCalibrationError(Metric):
    """Binary expected calibration error."""

    is_differentiable = False
    higher_is_better = False
    full_state_update: bool = False

    def __init__(
        self,
        n_bins: int = 15,
        norm: str = "l1",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _calibration_error_arg_validation(n_bins, norm, ignore_index)
        self.n_bins = n_bins
        self.norm = norm
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state("bins", torch.zeros((3, n_bins), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate the per-bin sums of a batch."""
        if self.validate_args:
            _binary_confusion_matrix_tensor_validation(preds, target, self.ignore_index)
        preds, target, valid = _binary_confusion_matrix_format(
            preds, target, threshold=0.5, ignore_index=self.ignore_index, convert_to_labels=False
        )
        confidences, accuracies, valid = _binary_calibration_error_update(preds, target, valid)
        self.bins = self.bins + _binning_update(confidences, accuracies, valid, self.n_bins)

    def compute(self) -> Tensor:
        """ECE under the configured norm."""
        return _ce_compute_from_bins(self.bins, self.norm)


class MulticlassCalibrationError(Metric):
    """Multiclass expected calibration error (top-1 confidence)."""

    is_differentiable = False
    higher_is_better = False
    full_state_update: bool = False

    def __init__(
        self,
        num_classes: int,
        n_bins: int = 15,
        norm: str = "l1",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _calibration_error_arg_validation(n_bins, norm, ignore_index)
            if not isinstance(num_classes, int) or num_classes < 2:
                raise ValueError(
                    f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}"
                )
        self.num_classes = num_classes
        self.n_bins = n_bins
        self.norm = norm
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state("bins", torch.zeros((3, n_bins), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate the per-bin sums of a batch."""
        if self.validate_args:
            _multiclass_confusion_matrix_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        preds, target, valid = _multiclass_confusion_matrix_format(
            preds, target, self.ignore_index, convert_to_labels=False
        )
        confidences, accuracies, valid = _multiclass_calibration_error_update(preds, target, valid)
        self.bins = self.bins + _binning_update(confidences, accuracies, valid, self.n_bins)

    def compute(self) -> Tensor:
        """ECE under the configured norm."""
        return _ce_compute_from_bins(self.bins, self.norm)


class CalibrationError(_ClassificationTaskWrapper):
    """Task-dispatch wrapper for calibration error (binary or multiclass)."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        n_bins: int = 15,
        norm: str = "l1",
        num_classes: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ):
        task = ClassificationTaskNoMultilabel.from_str(task)
        kwargs.update({"n_bins": n_bins, "norm": norm, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTaskNoMultilabel.BINARY:
            return BinaryCalibrationError(**kwargs)
        if task == ClassificationTaskNoMultilabel.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassCalibrationError(num_classes, **kwargs)
        raise ValueError(f"Task {task} not supported!")
