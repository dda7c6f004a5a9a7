"""AUROC: binary and multiclass, plus task dispatch.

Counterpart of ``torchmetrics_tpu/functional/classification/auroc.py``: derives from
the ROC curve state and integrates with the trapezoidal rule.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    CurveState,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
)
from torchmetrics_tpu_torch.functional.classification.roc import _binary_roc_compute, _multiclass_roc_compute
from torchmetrics_tpu_torch.functional.classification.stat_scores import _multilabel_not_ported
from torchmetrics_tpu_torch.utils.compute import _auc_compute_without_check
from torchmetrics_tpu_torch.utils.data import interp, safe_divide
from torchmetrics_tpu_torch.utils.enums import ClassificationTask
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


def _validate_average_arg(average: Optional[str], allowed=("macro", "weighted", "none", None)) -> None:
    if average not in allowed:
        raise ValueError(f"Expected argument `average` to be one of {allowed} but got {average}")


def _binary_auroc_arg_validation(
    max_fpr: Optional[float] = None,
    thresholds=None,
    ignore_index: Optional[int] = None,
) -> None:
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
    if max_fpr is not None and not (isinstance(max_fpr, float) and 0 < max_fpr <= 1):
        raise ValueError(f"Arguments `max_fpr` should be a float in range (0, 1], but got: {max_fpr}")


def _binary_auroc_compute(
    state: CurveState,
    thresholds: Optional[Tensor],
    max_fpr: Optional[float] = None,
    pos_label: int = 1,
) -> Tensor:
    fpr, tpr, _ = _binary_roc_compute(state, thresholds, pos_label)
    if max_fpr is None:
        return _auc_compute_without_check(fpr, tpr, 1.0)
    # partial AUC up to max_fpr with McClish standardization
    max_fpr_t = torch.tensor([max_fpr], dtype=fpr.dtype, device=fpr.device)
    fpr_c = torch.cat([fpr, max_fpr_t])
    tpr_c = torch.cat([tpr, interp(max_fpr_t, fpr, tpr)])
    order = torch.argsort(fpr_c, stable=True)
    fpr_c, tpr_c = fpr_c[order], tpr_c[order]
    seg_ok = (fpr_c <= max_fpr)[1:]
    dx = torch.diff(fpr_c)
    ym = (tpr_c[1:] + tpr_c[:-1]) / 2
    partial_auc = torch.where(seg_ok, dx * ym, torch.zeros_like(dx)).sum()
    min_area = 0.5 * max_fpr**2
    max_area = max_fpr
    return (0.5 * (1 + (partial_auc - min_area) / (max_area - min_area))).to(torch.float32)


def binary_auroc(
    preds: Tensor,
    target: Tensor,
    max_fpr: Optional[float] = None,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Area under the ROC curve for binary tasks."""
    if validate_args:
        _binary_auroc_arg_validation(max_fpr, thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, valid, thresholds = _binary_precision_recall_curve_format(
        preds, target, thresholds, ignore_index
    )
    state = _binary_precision_recall_curve_update(preds, target, valid, thresholds)
    return _binary_auroc_compute(state, thresholds, max_fpr)


def _reduce_auroc(fpr, tpr, average: Optional[str] = "macro", weights: Optional[Tensor] = None) -> Tensor:
    """Per-class trapezoid + macro/weighted/none reduction."""
    if isinstance(fpr, Tensor) and fpr.ndim == 2:
        res = _auc_compute_without_check(fpr, tpr, 1.0)
    else:
        res = torch.stack([_auc_compute_without_check(f, t, 1.0) for f, t in zip(fpr, tpr)])
    if average in (None, "none"):
        return res
    idx = ~torch.isnan(res)
    if not bool(idx.all()):
        rank_zero_warn(
            "AUROC score for one or more classes was `nan`. Ignoring these classes in average",
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


def _multiclass_auroc_compute(
    state: CurveState,
    num_classes: int,
    thresholds: Optional[Tensor],
    average: Optional[str] = "macro",
) -> Tensor:
    fpr, tpr, _ = _multiclass_roc_compute(state, num_classes, thresholds)
    if isinstance(state, Tensor) and thresholds is not None:
        weights = state[0, :, 1, :].sum(dim=-1).to(torch.float32)  # per-class support
    else:
        _, target, valid = state
        weights = torch.stack([((target == c) & valid).sum().to(torch.float32) for c in range(num_classes)])
    return _reduce_auroc(fpr, tpr, average, weights)


def multiclass_auroc(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """AUROC for multiclass tasks (one-vs-rest)."""
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
        _validate_average_arg(average)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, valid, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, valid, num_classes, thresholds)
    return _multiclass_auroc_compute(state, num_classes, thresholds, average)


def auroc(
    preds: Tensor,
    target: Tensor,
    task: str,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Task-dispatching AUROC."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_auroc(preds, target, max_fpr, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_auroc(preds, target, num_classes, average, thresholds, ignore_index, validate_args)
    raise _multilabel_not_ported("auroc")
