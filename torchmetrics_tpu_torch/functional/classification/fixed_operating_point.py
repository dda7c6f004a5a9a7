"""Operating-point metrics on the threshold-curve state.

Counterpart of ``torchmetrics_tpu/functional/classification/fixed_operating_point.py``:

- ``*_recall_at_fixed_precision`` and ``*_precision_at_fixed_recall`` take the best
  value subject to a floor on the other quantity, breaking ties lexicographically
  (value, then constraint, then threshold) and reporting the ``1e6`` sentinel threshold
  when the best value is 0;
- ``*_specificity_at_sensitivity`` and ``*_sensitivity_at_specificity`` take the first
  feasible maximum of the ROC curve, with no sentinel for a zero value.

The selection is ``where``/``max`` over the curve state, with no host read, so it runs on
a binned state inside a capture; a ``[C, T]`` curve is selected in one pass, a ragged
unbinned list class by class. The binned binary and micro updates reach the
binned-curve kernel through the PR-curve update.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
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
from torchmetrics_tpu_torch.functional.classification.roc import (
    _binary_roc_compute,
    _multiclass_roc_compute,
    _multilabel_roc_compute,
)
from torchmetrics_tpu_torch.utils.data import first_argmax
from torchmetrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


def _neg_inf(x: Tensor) -> Tensor:
    return torch.full_like(x, float("-inf"))


def _best_subject_to(
    value: Tensor, constraint: Tensor, floor: float, thresholds: Tensor, no_solution_threshold: float = 1e6
) -> Tuple[Tensor, Tensor]:
    """(max value s.t. constraint >= floor, threshold at that point); (0, 1e6) if none.

    Ties break lexicographically: the value, then the constraint, then the threshold,
    without a branch, over any leading (class or label) axes. A curve may carry one
    more point than ``thresholds`` (the synthetic endpoint); that point is not selected.
    """
    n = min(thresholds.shape[0], value.shape[-1])
    value_t, constraint_t, thr_t = value[..., :n], constraint[..., :n], thresholds[:n]
    feasible = constraint_t >= floor
    masked_v = torch.where(feasible, value_t, _neg_inf(value_t))
    best = masked_v.amax(dim=-1)
    tie1 = feasible & (value_t == best[..., None])
    best_c = torch.where(tie1, constraint_t, _neg_inf(constraint_t)).amax(dim=-1)
    tie2 = tie1 & (constraint_t == best_c[..., None])
    thr_b = thr_t.expand(tie2.shape)
    thr = torch.where(tie2, thr_b, _neg_inf(thr_b)).amax(dim=-1)
    any_feasible = feasible.any(dim=-1)
    best = torch.where(any_feasible, best, torch.zeros_like(best))
    # a best value of 0 reports the sentinel threshold even when feasible
    thr = torch.where(any_feasible & (best != 0.0), thr, torch.full_like(thr, no_solution_threshold))
    return best.to(torch.float32), thr.to(torch.float32)


def _first_max_subject_to(
    value: Tensor, constraint: Tensor, floor: float, thresholds: Tensor, no_solution_threshold: float = 1e6
) -> Tuple[Tensor, Tensor]:
    """(max value s.t. constraint >= floor, threshold at the FIRST such maximum).

    The specificity@sensitivity and sensitivity@specificity families take a plain
    argmax over the feasible curve points (first occurrence, no zero-value sentinel),
    unlike the lexicographic choice of the recall and precision families.
    """
    n = min(thresholds.shape[0], value.shape[-1])
    value_t, constraint_t, thr_t = value[..., :n], constraint[..., :n], thresholds[:n]
    feasible = constraint_t >= floor
    masked_v = torch.where(feasible, value_t, _neg_inf(value_t))
    idx = first_argmax(masked_v, dim=-1)
    best = torch.gather(masked_v, -1, idx[..., None])[..., 0]
    thr = thr_t[idx]
    any_feasible = feasible.any(dim=-1)
    best = torch.where(any_feasible, best, torch.zeros_like(best))
    thr = torch.where(any_feasible, thr, torch.full_like(thr, no_solution_threshold))
    return best.to(torch.float32), thr.to(torch.float32)


def _multi_curve_first_max(values, constraints, thresholds, floor):
    """`_first_max_subject_to` class by class over ragged (unbinned) curves; a [C, T]
    binned curve goes to `_first_max_subject_to` whole."""
    vals, thrs = [], []
    for v_curve, c_curve, t in zip(values, constraints, thresholds):
        v, th = _first_max_subject_to(v_curve, c_curve, floor, t)
        vals.append(v)
        thrs.append(th)
    return torch.stack(vals), torch.stack(thrs)


def _validate_floor(name: str, v: float) -> None:
    if not isinstance(v, (int, float)) or not (0 <= v <= 1):
        raise ValueError(f"Expected argument `{name}` to be a float in the [0,1] range, but got {v}")


# ------------------------------------------------------------- recall @ precision


def _binary_recall_at_fixed_precision_compute(state, thresholds, min_precision: float):
    precision, recall, thres = _binary_precision_recall_curve_compute(state, thresholds)
    return _best_subject_to(recall, precision, min_precision, thres)


def binary_recall_at_fixed_precision(
    preds: Tensor,
    target: Tensor,
    min_precision: float,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Highest recall with precision at least ``min_precision`` (+ the threshold)."""
    if validate_args:
        _validate_floor("min_precision", min_precision)
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, valid, thresholds = _binary_precision_recall_curve_format(
        preds, target, thresholds, ignore_index
    )
    state = _binary_precision_recall_curve_update(preds, target, valid, thresholds)
    return _binary_recall_at_fixed_precision_compute(state, thresholds, min_precision)


def _multi_curve_best(precisions, recalls, thresholds, floor, swap=False):
    """`_best_subject_to` per class or label: a [C, T(+1)] tensor curve in one select,
    ragged unbinned lists class by class."""
    if isinstance(precisions, Tensor) and precisions.ndim == 2:
        v_curve, c_curve = (precisions, recalls) if swap else (recalls, precisions)
        thr = thresholds[0] if isinstance(thresholds, (list, tuple)) else thresholds
        return _best_subject_to(v_curve, c_curve, floor, thr)
    vals, thrs = [], []
    for p, r, t in zip(precisions, recalls, thresholds):
        v_curve, c_curve = (p, r) if swap else (r, p)
        v, th = _best_subject_to(v_curve, c_curve, floor, t)
        vals.append(v)
        thrs.append(th)
    return torch.stack(vals), torch.stack(thrs)


def multiclass_recall_at_fixed_precision(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    min_precision: float,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Per-class highest recall with precision >= ``min_precision``."""
    if validate_args:
        _validate_floor("min_precision", min_precision)
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, valid, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, valid, num_classes, thresholds)
    precision, recall, thres = _multiclass_precision_recall_curve_compute(state, num_classes, thresholds)
    return _multi_curve_best(precision, recall, thres, min_precision)


def multilabel_recall_at_fixed_precision(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    min_precision: float,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Per-label highest recall with precision >= ``min_precision``."""
    if validate_args:
        _validate_floor("min_precision", min_precision)
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, valid, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, valid, num_labels, thresholds)
    precision, recall, thres = _multilabel_precision_recall_curve_compute(
        state, num_labels, thresholds, ignore_index
    )
    return _multi_curve_best(precision, recall, thres, min_precision)


def recall_at_fixed_precision(
    preds: Tensor,
    target: Tensor,
    task: str,
    min_precision: float,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Task-dispatching recall@fixed-precision."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_recall_at_fixed_precision(
            preds, target, min_precision, thresholds, ignore_index, validate_args
        )
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_recall_at_fixed_precision(
            preds, target, num_classes, min_precision, thresholds, ignore_index, validate_args
        )
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_recall_at_fixed_precision(
            preds, target, num_labels, min_precision, thresholds, ignore_index, validate_args
        )
    raise ValueError(f"Not handled value: {task}")


# ------------------------------------------------------------- precision @ recall


def binary_precision_at_fixed_recall(
    preds: Tensor,
    target: Tensor,
    min_recall: float,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Highest precision with recall at least ``min_recall`` (+ the threshold)."""
    if validate_args:
        _validate_floor("min_recall", min_recall)
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, valid, thresholds = _binary_precision_recall_curve_format(
        preds, target, thresholds, ignore_index
    )
    state = _binary_precision_recall_curve_update(preds, target, valid, thresholds)
    precision, recall, thres = _binary_precision_recall_curve_compute(state, thresholds)
    return _best_subject_to(precision, recall, min_recall, thres)


def multiclass_precision_at_fixed_recall(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    min_recall: float,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Per-class highest precision with recall >= ``min_recall``."""
    if validate_args:
        _validate_floor("min_recall", min_recall)
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, valid, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, valid, num_classes, thresholds)
    precision, recall, thres = _multiclass_precision_recall_curve_compute(state, num_classes, thresholds)
    return _multi_curve_best(precision, recall, thres, min_recall, swap=True)


def multilabel_precision_at_fixed_recall(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    min_recall: float,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Per-label highest precision with recall >= ``min_recall``."""
    if validate_args:
        _validate_floor("min_recall", min_recall)
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, valid, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, valid, num_labels, thresholds)
    precision, recall, thres = _multilabel_precision_recall_curve_compute(
        state, num_labels, thresholds, ignore_index
    )
    return _multi_curve_best(precision, recall, thres, min_recall, swap=True)


def precision_at_fixed_recall(
    preds: Tensor,
    target: Tensor,
    task: str,
    min_recall: float,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Task-dispatching precision@fixed-recall."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_precision_at_fixed_recall(preds, target, min_recall, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_precision_at_fixed_recall(
            preds, target, num_classes, min_recall, thresholds, ignore_index, validate_args
        )
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_precision_at_fixed_recall(
            preds, target, num_labels, min_recall, thresholds, ignore_index, validate_args
        )
    raise ValueError(f"Not handled value: {task}")


# ------------------------------------------------------ specificity @ sensitivity


def _spec_at_sens_from_roc(fpr, tpr, thres, min_sensitivity: float):
    specificity = 1.0 - fpr
    return _first_max_subject_to(specificity, tpr, min_sensitivity, thres)


def binary_specificity_at_sensitivity(
    preds: Tensor,
    target: Tensor,
    min_sensitivity: float,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Highest specificity with sensitivity (TPR) at least ``min_sensitivity``."""
    if validate_args:
        _validate_floor("min_sensitivity", min_sensitivity)
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, valid, thresholds = _binary_precision_recall_curve_format(
        preds, target, thresholds, ignore_index
    )
    state = _binary_precision_recall_curve_update(preds, target, valid, thresholds)
    fpr, tpr, thres = _binary_roc_compute(state, thresholds)
    return _spec_at_sens_from_roc(fpr, tpr, thres, min_sensitivity)


def multiclass_specificity_at_sensitivity(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    min_sensitivity: float,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Per-class highest specificity with sensitivity >= ``min_sensitivity``."""
    if validate_args:
        _validate_floor("min_sensitivity", min_sensitivity)
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, valid, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, valid, num_classes, thresholds)
    fpr, tpr, thres = _multiclass_roc_compute(state, num_classes, thresholds)
    if isinstance(fpr, Tensor) and fpr.ndim == 2:
        return _first_max_subject_to(1.0 - fpr, tpr, min_sensitivity, thres)
    return _multi_curve_first_max([1.0 - f for f in fpr], tpr, thres, min_sensitivity)


def multilabel_specificity_at_sensitivity(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    min_sensitivity: float,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Per-label highest specificity with sensitivity >= ``min_sensitivity``."""
    if validate_args:
        _validate_floor("min_sensitivity", min_sensitivity)
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, valid, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, valid, num_labels, thresholds)
    fpr, tpr, thres = _multilabel_roc_compute(state, num_labels, thresholds, ignore_index)
    if isinstance(fpr, Tensor) and fpr.ndim == 2:
        return _first_max_subject_to(1.0 - fpr, tpr, min_sensitivity, thres)
    return _multi_curve_first_max([1.0 - f for f in fpr], tpr, thres, min_sensitivity)


def specificity_at_sensitivity(
    preds: Tensor,
    target: Tensor,
    task: str,
    min_sensitivity: float,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Task-dispatching specificity@sensitivity."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_specificity_at_sensitivity(
            preds, target, min_sensitivity, thresholds, ignore_index, validate_args
        )
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_specificity_at_sensitivity(
            preds, target, num_classes, min_sensitivity, thresholds, ignore_index, validate_args
        )
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_specificity_at_sensitivity(
            preds, target, num_labels, min_sensitivity, thresholds, ignore_index, validate_args
        )
    raise ValueError(f"Not handled value: {task}")


# ------------------------------------------------------ sensitivity @ specificity


def binary_sensitivity_at_specificity(
    preds: Tensor,
    target: Tensor,
    min_specificity: float,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Highest sensitivity (TPR) with specificity at least ``min_specificity``."""
    if validate_args:
        _validate_floor("min_specificity", min_specificity)
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, valid, thresholds = _binary_precision_recall_curve_format(
        preds, target, thresholds, ignore_index
    )
    state = _binary_precision_recall_curve_update(preds, target, valid, thresholds)
    fpr, tpr, thres = _binary_roc_compute(state, thresholds)
    return _first_max_subject_to(tpr, 1.0 - fpr, min_specificity, thres)


def multiclass_sensitivity_at_specificity(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    min_specificity: float,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Per-class highest sensitivity with specificity >= ``min_specificity``."""
    if validate_args:
        _validate_floor("min_specificity", min_specificity)
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, valid, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index
    )
    state = _multiclass_precision_recall_curve_update(preds, target, valid, num_classes, thresholds)
    fpr, tpr, thres = _multiclass_roc_compute(state, num_classes, thresholds)
    if isinstance(fpr, Tensor) and fpr.ndim == 2:
        return _first_max_subject_to(tpr, 1.0 - fpr, min_specificity, thres)
    return _multi_curve_first_max(tpr, [1.0 - f for f in fpr], thres, min_specificity)


def multilabel_sensitivity_at_specificity(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    min_specificity: float,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Per-label highest sensitivity with specificity >= ``min_specificity``."""
    if validate_args:
        _validate_floor("min_specificity", min_specificity)
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, valid, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, valid, num_labels, thresholds)
    fpr, tpr, thres = _multilabel_roc_compute(state, num_labels, thresholds, ignore_index)
    if isinstance(fpr, Tensor) and fpr.ndim == 2:
        return _first_max_subject_to(tpr, 1.0 - fpr, min_specificity, thres)
    return _multi_curve_first_max(tpr, [1.0 - f for f in fpr], thres, min_specificity)


def sensitivity_at_specificity(
    preds: Tensor,
    target: Tensor,
    task: str,
    min_specificity: float,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Task-dispatching sensitivity@specificity."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_sensitivity_at_specificity(
            preds, target, min_specificity, thresholds, ignore_index, validate_args
        )
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_sensitivity_at_specificity(
            preds, target, num_classes, min_specificity, thresholds, ignore_index, validate_args
        )
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_sensitivity_at_specificity(
            preds, target, num_labels, min_specificity, thresholds, ignore_index, validate_args
        )
    raise ValueError(f"Not handled value: {task}")
