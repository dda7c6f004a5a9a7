"""Confusion matrix: binary, multiclass and multilabel, plus task dispatch.

Counterpart of ``torchmetrics_tpu/functional/classification/confusion_matrix.py``.
The JAX package contracts two one-hot encodings on the MXU, or calls its Pallas
kernel; here ``_masked_confmat`` is a histogram over ``target*C + pred``, counted
by the hand-written CUDA kernel for tensors on the card (``ops.kernels``) at every
C. ``ignore_index`` removal is a validity mask. The multilabel ``[L, 2, 2]`` matrices
are plain sums, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _is_traced,
    _maybe_apply_sigmoid,
    _unique_values,
)
from torchmetrics_tpu_torch.ops import kernels
from torchmetrics_tpu_torch.utils.data import first_argmax
from torchmetrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


def _confusion_matrix_reduce(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    """Normalize the confusion matrix over true labels, predictions or all."""
    allowed_normalize = ("true", "pred", "all", "none", None)
    if normalize not in allowed_normalize:
        raise ValueError(f"Argument `normalize` needs to one of the following: {allowed_normalize}")
    if normalize is not None and normalize != "none":
        confmat = confmat.to(torch.float32)
        if normalize == "true":
            confmat = confmat / confmat.sum(dim=-1, keepdim=True)
        elif normalize == "pred":
            confmat = confmat / confmat.sum(dim=-2, keepdim=True)
        elif normalize == "all":
            confmat = confmat / confmat.sum(dim=(-2, -1), keepdim=True)
        confmat = torch.nan_to_num(confmat, nan=0.0)
    return confmat


def _masked_confmat(preds: Tensor, target: Tensor, valid: Tensor, num_classes: int) -> Tensor:
    """int32 [C, C] counts of (target=row, pred=col) pairs where ``valid``.

    A pair with either label outside ``[0, C)`` counts nowhere, as with the JAX
    package's one-hot rows.
    """
    return kernels.confusion_matrix(preds, target, valid, num_classes)


# --------------------------------------------------------------------------- binary


def _binary_confusion_matrix_arg_validation(
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    normalize: Optional[str] = None,
) -> None:
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float in the [0,1] range, but got {threshold}.")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")
    allowed_normalize = ("true", "pred", "all", "none", None)
    if normalize not in allowed_normalize:
        raise ValueError(f"Expected argument `normalize` to be one of {allowed_normalize}, but got {normalize}.")


def _binary_confusion_matrix_tensor_validation(
    preds: Tensor,
    target: Tensor,
    ignore_index: Optional[int] = None,
) -> None:
    if preds.shape != target.shape:
        raise ValueError(
            "The `preds` and `target` should have the same shape,"
            f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
        )
    if _is_traced(preds, target):
        return
    unique_values = _unique_values(target)
    allowed = {0, 1} if ignore_index is None else {0, 1, ignore_index}
    if not unique_values.issubset(allowed):
        raise RuntimeError(
            f"Detected the following values in `target`: {sorted(unique_values)} but expected only"
            f" the following values {sorted(allowed)}."
        )
    if not preds.is_floating_point():
        unique_p = _unique_values(preds)
        if not unique_p.issubset({0, 1}):
            raise RuntimeError(
                f"Detected the following values in `preds`: {sorted(unique_p)} but expected only"
                " the following values [0,1] since preds is a label tensor."
            )


def _binary_confusion_matrix_format(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    convert_to_labels: bool = True,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Flattened int preds/target plus a validity mask."""
    preds = preds.reshape(-1)
    target = target.reshape(-1)
    if preds.is_floating_point():
        preds = _maybe_apply_sigmoid(preds)
        if convert_to_labels:
            preds = (preds > threshold).to(torch.int32)
    elif convert_to_labels:
        preds = preds.to(torch.int32)
    valid = torch.ones_like(target, dtype=torch.bool) if ignore_index is None else target != ignore_index
    target = torch.where(valid, target, torch.zeros_like(target)).to(torch.int32)
    return preds, target, valid


def _binary_confusion_matrix_update(preds: Tensor, target: Tensor, valid: Tensor) -> Tensor:
    """[2, 2] confusion matrix."""
    return _masked_confmat(preds, target, valid, 2)


def _binary_confusion_matrix_compute(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    return _confusion_matrix_reduce(confmat, normalize)


def binary_confusion_matrix(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """The [2, 2] confusion matrix for binary tasks."""
    if validate_args:
        _binary_confusion_matrix_arg_validation(threshold, ignore_index, normalize)
        _binary_confusion_matrix_tensor_validation(preds, target, ignore_index)
    preds, target, valid = _binary_confusion_matrix_format(preds, target, threshold, ignore_index)
    confmat = _binary_confusion_matrix_update(preds, target, valid)
    return _binary_confusion_matrix_compute(confmat, normalize)


# ------------------------------------------------------------------------ multiclass


def _multiclass_confusion_matrix_arg_validation(
    num_classes: int,
    ignore_index: Optional[int] = None,
    normalize: Optional[str] = None,
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")
    allowed_normalize = ("true", "pred", "all", "none", None)
    if normalize not in allowed_normalize:
        raise ValueError(f"Expected argument `normalize` to be one of {allowed_normalize}, but got {normalize}.")


def _multiclass_confusion_matrix_tensor_validation(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    ignore_index: Optional[int] = None,
) -> None:
    if preds.ndim == target.ndim + 1:
        if not preds.is_floating_point():
            raise ValueError("If `preds` have one dimension more than `target`, `preds` should be a float tensor.")
        if preds.shape[1] != num_classes:
            raise ValueError(
                "If `preds` have one dimension more than `target`, `preds.shape[1]` should be"
                " equal to number of classes."
            )
        if preds.shape[2:] != target.shape[1:]:
            raise ValueError(
                "If `preds` have one dimension more than `target`, the shape of `preds` should be"
                " (N, C, ...), and the shape of `target` should be (N, ...)."
            )
    elif preds.ndim == target.ndim:
        if preds.shape != target.shape:
            raise ValueError(
                "The `preds` and `target` should have the same shape,"
                f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
            )
    else:
        raise ValueError(
            "Either `preds` and `target` both should have the (same) shape (N, ...), or `target` should be (N, ...)"
            " and `preds` should be (N, C, ...)."
        )
    if _is_traced(preds, target):
        return
    check_value = num_classes if ignore_index is None else num_classes + 1
    num_unique = len(torch.unique(target))
    if num_unique > check_value:
        raise RuntimeError(
            f"Detected more unique values in `target` than expected. Expected only {check_value} but found"
            f" {num_unique} in `target`."
        )


def _multiclass_confusion_matrix_format(
    preds: Tensor,
    target: Tensor,
    ignore_index: Optional[int] = None,
    convert_to_labels: bool = True,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Argmax score inputs and flatten; returns preds/target/valid of shape [N]."""
    if preds.ndim == target.ndim + 1 and convert_to_labels:
        preds = first_argmax(preds, dim=1)
    if convert_to_labels:
        preds = preds.reshape(-1).to(torch.int32)
    else:
        preds = torch.movedim(preds, 1, -1).reshape(-1, preds.shape[1])
    target = target.reshape(-1)
    valid = torch.ones_like(target, dtype=torch.bool) if ignore_index is None else target != ignore_index
    target = torch.where(valid, target, torch.zeros_like(target)).to(torch.int32)
    return preds, target, valid


def _multiclass_confusion_matrix_update(preds: Tensor, target: Tensor, valid: Tensor, num_classes: int) -> Tensor:
    """[C, C] confusion matrix."""
    return _masked_confmat(preds, target, valid, num_classes)


def _multiclass_confusion_matrix_compute(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    return _confusion_matrix_reduce(confmat, normalize)


def multiclass_confusion_matrix(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """The [C, C] confusion matrix for multiclass tasks (rows=target, cols=pred)."""
    if validate_args:
        _multiclass_confusion_matrix_arg_validation(num_classes, ignore_index, normalize)
        _multiclass_confusion_matrix_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, valid = _multiclass_confusion_matrix_format(preds, target, ignore_index)
    confmat = _multiclass_confusion_matrix_update(preds, target, valid, num_classes)
    return _multiclass_confusion_matrix_compute(confmat, normalize)


# ------------------------------------------------------------------------ multilabel


def _multilabel_confusion_matrix_arg_validation(
    num_labels: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    normalize: Optional[str] = None,
) -> None:
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
    if not (isinstance(threshold, float) and (0 <= threshold <= 1)):
        raise ValueError(f"Expected argument `threshold` to be a float in the [0,1] range, but got {threshold}.")
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")
    allowed_normalize = ("true", "pred", "all", "none", None)
    if normalize not in allowed_normalize:
        raise ValueError(f"Expected argument `normalize` to be one of {allowed_normalize}, but got {normalize}.")


def _multilabel_confusion_matrix_tensor_validation(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    ignore_index: Optional[int] = None,
) -> None:
    if preds.shape != target.shape:
        raise ValueError(
            "The `preds` and `target` should have the same shape,"
            f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
        )
    if preds.ndim < 2 or preds.shape[1] != num_labels:
        raise ValueError("Expected both `target.shape[1]` and `preds.shape[1]` to be equal to the number of labels")
    if _is_traced(preds, target):
        return
    unique_values = _unique_values(target)
    allowed = {0, 1} if ignore_index is None else {0, 1, ignore_index}
    if not unique_values.issubset(allowed):
        raise RuntimeError(
            f"Detected the following values in `target`: {sorted(unique_values)} but expected only"
            f" the following values {sorted(allowed)}."
        )


def _multilabel_confusion_matrix_format(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    should_threshold: bool = True,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Returns preds/target of shape [N*X, L] (int unless ``should_threshold`` is off)
    plus a validity mask [N*X, L]."""
    if preds.is_floating_point():
        preds = _maybe_apply_sigmoid(preds)
        if should_threshold:
            preds = (preds > threshold).to(torch.int32)
    else:
        preds = preds.to(torch.int32)
    preds = torch.movedim(preds.reshape(preds.shape[0], num_labels, -1), 1, -1).reshape(-1, num_labels)
    target = torch.movedim(target.reshape(target.shape[0], num_labels, -1), 1, -1).reshape(-1, num_labels)
    valid = torch.ones_like(target, dtype=torch.bool) if ignore_index is None else target != ignore_index
    target = torch.where(valid, target, torch.zeros_like(target)).to(torch.int32)
    return preds, target, valid


def _multilabel_confusion_matrix_update(preds: Tensor, target: Tensor, valid: Tensor, num_labels: int) -> Tensor:
    """int32 [L, 2, 2] per-label confusion matrices (rows = target, cols = prediction)."""
    p = preds == 1
    t = target == 1
    tp = (p & t & valid).sum(dim=0, dtype=torch.int32)
    fp = (p & ~t & valid).sum(dim=0, dtype=torch.int32)
    fn = (~p & t & valid).sum(dim=0, dtype=torch.int32)
    tn = (~p & ~t & valid).sum(dim=0, dtype=torch.int32)
    return torch.stack([tn, fp, fn, tp], dim=-1).reshape(num_labels, 2, 2)


def _multilabel_confusion_matrix_compute(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    return _confusion_matrix_reduce(confmat, normalize)


def multilabel_confusion_matrix(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    threshold: float = 0.5,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """The [L, 2, 2] per-label confusion matrices for multilabel tasks."""
    if validate_args:
        _multilabel_confusion_matrix_arg_validation(num_labels, threshold, ignore_index, normalize)
        _multilabel_confusion_matrix_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, valid = _multilabel_confusion_matrix_format(preds, target, num_labels, threshold, ignore_index)
    confmat = _multilabel_confusion_matrix_update(preds, target, valid, num_labels)
    return _multilabel_confusion_matrix_compute(confmat, normalize)


# -------------------------------------------------------------------------- dispatch


def confusion_matrix(
    preds: Tensor,
    target: Tensor,
    task: str,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    normalize: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching confusion matrix."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_confusion_matrix(preds, target, threshold, normalize, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_confusion_matrix(preds, target, num_classes, normalize, ignore_index, validate_args)
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_confusion_matrix(
            preds, target, num_labels, threshold, normalize, ignore_index, validate_args
        )
    raise ValueError(f"Not handled value: {task}")
