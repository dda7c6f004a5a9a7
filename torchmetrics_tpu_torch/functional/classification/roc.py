"""ROC curves: binary, multiclass and multilabel, plus task dispatch.

Counterpart of ``torchmetrics_tpu/functional/classification/roc.py``; shares formats
and updates (and so the module state) with the precision-recall curve.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    CurveState,
    _binary_clf_curve,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
    _multilabel_precision_recall_curve_arg_validation,
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
    _multilabel_precision_recall_curve_update,
)
from torchmetrics_tpu_torch.functional.classification.stat_scores import _is_traced
from torchmetrics_tpu_torch.utils.data import interp, safe_divide
from torchmetrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


def _binary_roc_compute(
    state: CurveState,
    thresholds: Optional[Tensor],
    pos_label: int = 1,
) -> Tuple[Tensor, Tensor, Tensor]:
    """(fpr, tpr, thresholds), thresholds in decreasing order."""
    if thresholds is not None and isinstance(state, Tensor):
        tps = state[:, 1, 1].to(torch.float32)
        fps = state[:, 0, 1].to(torch.float32)
        fns = state[:, 1, 0].to(torch.float32)
        tns = state[:, 0, 0].to(torch.float32)
        tpr = safe_divide(tps, tps + fns).flip(0)
        fpr = safe_divide(fps, fps + tns).flip(0)
        return fpr, tpr, thresholds.flip(0)
    preds, target, valid = state
    if _is_traced(preds, target, valid):
        return _binary_roc_static(preds, target, valid)
    preds, target = preds[valid], target[valid]
    fps, tps, thres = _binary_clf_curve(preds, target, pos_label=pos_label)
    # prepend the (0, 0) origin with its threshold pinned at 1.0
    zero = torch.zeros(1, device=tps.device)
    tps = torch.cat([zero, tps])
    fps = torch.cat([zero, fps])
    thres = torch.cat([torch.ones(1, dtype=thres.dtype, device=thres.device), thres])
    return safe_divide(fps, fps[-1]), safe_divide(tps, tps[-1]), thres


def _binary_roc_static(preds: Tensor, target: Tensor, valid: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """The unbinned ROC with static shapes, for a compute that a CUDA graph records
    (JAX's jitted variant): one point per sample after the (0, 0) origin; an ignored
    sample weighs 0."""
    order = torch.argsort(preds, stable=True).flip(0)
    w = valid[order].to(torch.float32)
    t_s = target[order].to(torch.float32) * w
    zero = torch.zeros(1, device=preds.device)
    tps = torch.cat([zero, torch.cumsum(t_s, dim=0)])
    fps = torch.cat([zero, torch.cumsum(w, dim=0) - torch.cumsum(t_s, dim=0)])
    thres = torch.cat([torch.ones(1, dtype=preds.dtype, device=preds.device), preds[order]])
    return safe_divide(fps, fps[-1]), safe_divide(tps, tps[-1]), thres


def binary_roc(
    preds: Tensor,
    target: Tensor,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor, Tensor]:
    """ROC curve for binary tasks."""
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, valid, thresholds = _binary_precision_recall_curve_format(
        preds, target, thresholds, ignore_index
    )
    state = _binary_precision_recall_curve_update(preds, target, valid, thresholds)
    return _binary_roc_compute(state, thresholds)


def _roc_macro_average(fpr, tpr, thres, num_classes: int):
    """Macro-average per-class ROC curves: interpolate each class's tpr onto the sorted
    union of fprs and average."""
    if isinstance(fpr, Tensor) and fpr.ndim == 2:
        all_thres = torch.sort(thres.repeat(num_classes)).values.flip(0)
        mean_fpr = torch.sort(fpr.flatten()).values
        per_class = [interp(mean_fpr, fpr[i], tpr[i]) for i in range(num_classes)]
    else:
        all_thres = torch.sort(torch.cat(thres)).values.flip(0)
        mean_fpr = torch.sort(torch.cat(fpr)).values
        per_class = [interp(mean_fpr, f, t) for f, t in zip(fpr, tpr)]
    mean_tpr = torch.stack(per_class).mean(dim=0)
    return mean_fpr, mean_tpr, all_thres


def _multiclass_roc_compute(
    state: CurveState,
    num_classes: int,
    thresholds: Optional[Tensor],
    average: Optional[str] = None,
):
    if average == "micro":
        return _binary_roc_compute(state, thresholds)
    if thresholds is not None and isinstance(state, Tensor):
        tps = state[:, :, 1, 1].to(torch.float32)
        fps = state[:, :, 0, 1].to(torch.float32)
        fns = state[:, :, 1, 0].to(torch.float32)
        tns = state[:, :, 0, 0].to(torch.float32)
        tpr = safe_divide(tps, tps + fns).flip(0).T  # [C, T]
        fpr = safe_divide(fps, fps + tns).flip(0).T
        if average == "macro":
            return _roc_macro_average(fpr, tpr, thresholds.flip(0), num_classes)
        return fpr, tpr, thresholds.flip(0)
    preds, target, valid = state
    preds, target = preds[valid], target[valid]
    all_valid = torch.ones(target.shape[0], dtype=torch.bool, device=target.device)
    fprs, tprs, thres = [], [], []
    for c in range(num_classes):
        f, t, th = _binary_roc_compute((preds[:, c], (target == c).to(torch.int32), all_valid), None)
        fprs.append(f)
        tprs.append(t)
        thres.append(th)
    if average == "macro":
        return _roc_macro_average(fprs, tprs, thres, num_classes)
    return fprs, tprs, thres


def multiclass_roc(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Per-class one-vs-rest ROC curves (or micro/macro averaged)."""
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index, average)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, valid, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index, average
    )
    if average == "micro":
        state = _binary_precision_recall_curve_update(preds, target, valid, thresholds)
        return _binary_roc_compute(state, thresholds)
    state = _multiclass_precision_recall_curve_update(preds, target, valid, num_classes, thresholds)
    return _multiclass_roc_compute(state, num_classes, thresholds, average)


def _multilabel_roc_compute(
    state: CurveState,
    num_labels: int,
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
):
    """(fpr, tpr, thresholds) per label, thresholds in decreasing order."""
    if thresholds is not None and isinstance(state, Tensor):
        tps = state[:, :, 1, 1].to(torch.float32)
        fps = state[:, :, 0, 1].to(torch.float32)
        fns = state[:, :, 1, 0].to(torch.float32)
        tns = state[:, :, 0, 0].to(torch.float32)
        tpr = safe_divide(tps, tps + fns).flip(0).T  # [L, T]
        fpr = safe_divide(fps, fps + tns).flip(0).T
        return fpr, tpr, thresholds.flip(0)
    preds, target, valid = state
    fprs, tprs, thres = [], [], []
    for label in range(num_labels):
        f, t, th = _binary_roc_compute((preds[:, label], target[:, label], valid[:, label]), None)
        fprs.append(f)
        tprs.append(t)
        thres.append(th)
    return fprs, tprs, thres


def multilabel_roc(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Per-label ROC curves."""
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, valid, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, valid, num_labels, thresholds)
    return _multilabel_roc_compute(state, num_labels, thresholds, ignore_index)


def roc(
    preds: Tensor,
    target: Tensor,
    task: str,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Task-dispatching ROC."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_roc(preds, target, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_roc(preds, target, num_classes, thresholds, average, ignore_index, validate_args)
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_roc(preds, target, num_labels, thresholds, ignore_index, validate_args)
    raise ValueError(f"Not handled value: {task}")
