"""Calibration error (ECE): binary and multiclass, plus task dispatch.

Counterpart of ``torchmetrics_tpu/functional/classification/calibration_error.py``.
The bin boundaries are fixed when the metric is built, so binning commutes with
accumulation: the state is a static float32 ``[3, n_bins]`` accumulator (sum of
confidences, sum of accuracies, count per bin). ``_binning_update`` fills it with the
hand-written weighted-bincount kernel for tensors on the card (``ops.kernels``, K=3),
which sums in float64 and rounds once.
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
from torchmetrics_tpu_torch.ops import kernels
from torchmetrics_tpu_torch.utils.data import first_argmax, safe_divide
from torchmetrics_tpu_torch.utils.enums import ClassificationTaskNoMultilabel

Tensor = torch.Tensor


def _calibration_error_arg_validation(
    n_bins: int,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(n_bins, int) or n_bins < 1:
        raise ValueError(f"Expected argument `n_bins` to be an integer larger than 0, but got {n_bins}")
    allowed_norm = ("l1", "l2", "max")
    if norm not in allowed_norm:
        raise ValueError(f"Expected argument `norm` to be one of {allowed_norm}, but got {norm}.")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _bin_index(confidences: Tensor, n_bins: int) -> Tensor:
    """int32 bin of each confidence: ``clip(ceil(conf * n_bins) - 1, 0, n_bins - 1)``.

    Bins are right-closed ``(i/n, (i+1)/n]`` with 0 clamped into bin 0. The product
    stays float32 (a Python int multiplier keeps the tensor's type), as in JAX. JAX
    converts a NaN to the integer 0, so a NaN confidence lands in bin 0; a float to
    int cast of NaN is undefined in torch, so the NaN is mapped to 0 before it.
    """
    scaled = torch.nan_to_num(torch.ceil(confidences * n_bins), nan=0.0)
    return torch.clamp(scaled - 1, 0, n_bins - 1).to(torch.int32)


def _binning_update(confidences: Tensor, accuracies: Tensor, valid: Tensor, n_bins: int) -> Tensor:
    """float32 [3, n_bins]: per-bin sum of confidences, sum of accuracies and count."""
    v = valid.to(torch.float32)
    weights = torch.stack([confidences.to(torch.float32) * v, accuracies.to(torch.float32) * v, v])
    return kernels.weighted_bincount(_bin_index(confidences, n_bins), weights, n_bins)


def _ce_compute_from_bins(bins: Tensor, norm: str = "l1") -> Tensor:
    """ECE from the [3, n_bins] accumulator."""
    conf_sum, acc_sum, count = bins[0], bins[1], bins[2]
    prop = safe_divide(count, count.sum())
    conf_bin = safe_divide(conf_sum, count)
    acc_bin = safe_divide(acc_sum, count)
    gap = (acc_bin - conf_bin).abs()
    if norm == "l1":
        return (gap * prop).sum()
    if norm == "max":
        return torch.where(count > 0, gap, torch.zeros_like(gap)).max()
    if norm == "l2":
        ce = (gap**2 * prop).sum()
        return torch.sqrt(torch.clamp(ce, min=0.0))
    raise ValueError(f"Argument `norm` expected to be one of 'l1', 'l2', 'max' but got {norm}")


def _binary_calibration_error_update(preds: Tensor, target: Tensor, valid: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """(confidences, accuracies, valid): the positive-class probability against the target."""
    return preds.to(torch.float32), target.to(torch.float32), valid


def binary_calibration_error(
    preds: Tensor,
    target: Tensor,
    n_bins: int = 15,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Expected calibration error for binary tasks."""
    if validate_args:
        _calibration_error_arg_validation(n_bins, norm, ignore_index)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target, valid = _binary_confusion_matrix_format(
        preds, target, threshold=0.5, ignore_index=ignore_index, convert_to_labels=False
    )
    confidences, accuracies, valid = _binary_calibration_error_update(preds, target, valid)
    return _ce_compute_from_bins(_binning_update(confidences, accuracies, valid, n_bins), norm)


def _multiclass_calibration_error_update(
    preds: Tensor, target: Tensor, valid: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Confidence is the largest softmax probability; accuracy is argmax == target."""
    preds = _maybe_softmax(preds, dim=-1)
    confidences = preds.max(dim=-1).values.to(torch.float32)
    accuracies = (first_argmax(preds, dim=-1).to(torch.int32) == target).to(torch.float32)
    return confidences, accuracies, valid


def multiclass_calibration_error(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    n_bins: int = 15,
    norm: str = "l1",
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Expected calibration error for multiclass tasks."""
    if validate_args:
        _calibration_error_arg_validation(n_bins, norm, ignore_index)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, valid = _multiclass_confusion_matrix_format(preds, target, ignore_index, convert_to_labels=False)
    confidences, accuracies, valid = _multiclass_calibration_error_update(preds, target, valid)
    return _ce_compute_from_bins(_binning_update(confidences, accuracies, valid, n_bins), norm)


def calibration_error(
    preds: Tensor,
    target: Tensor,
    task: str,
    n_bins: int = 15,
    norm: str = "l1",
    num_classes: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching calibration error (binary or multiclass)."""
    task = ClassificationTaskNoMultilabel.from_str(task)
    if task == ClassificationTaskNoMultilabel.BINARY:
        return binary_calibration_error(preds, target, n_bins, norm, ignore_index, validate_args)
    if task == ClassificationTaskNoMultilabel.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_calibration_error(preds, target, num_classes, n_bins, norm, ignore_index, validate_args)
    raise ValueError(f"Not handled value: {task}")
