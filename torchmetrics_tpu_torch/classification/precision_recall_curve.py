"""PrecisionRecallCurve module classes — the state of the threshold-curve family.

Counterpart of ``torchmetrics_tpu/classification/precision_recall_curve.py``. With
``thresholds`` the state is a static int32 confusion accumulator and the thresholds
are a buffer on the metric's device; without, raw scores accumulate in list states.
``MulticlassPrecisionRecallCurve(average="micro")`` flattens to one binary problem
and so reaches the binned-curve CUDA kernel. ``buffer_capacity`` (``MaskedBuffer``
states) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    _adjust_threshold_arg,
    _binary_precision_recall_curve_arg_validation,
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_format,
    _binary_precision_recall_curve_tensor_validation,
    _binary_precision_recall_curve_update,
    _macro_curves_not_ported,
    _multiclass_precision_recall_curve_arg_validation,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_format,
    _multiclass_precision_recall_curve_tensor_validation,
    _multiclass_precision_recall_curve_update,
)
from torchmetrics_tpu_torch.functional.classification.stat_scores import _multilabel_not_ported
from torchmetrics_tpu_torch.utils.data import dim_zero_cat
from torchmetrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


def _add_curve_states(metric: Metric, thresholds: Optional[Tensor], binned_shape: Tuple[int, ...]) -> None:
    """Register the thresholds buffer and the binned accumulator, or the unbinned lists."""
    if thresholds is None:
        metric.thresholds = None
        for name in ("preds", "target", "valid"):
            metric.add_state(name, [], dist_reduce_fx="cat")
    else:
        metric.register_buffer("thresholds", thresholds.to(metric.device), persistent=False)
        metric.add_state("confmat", torch.zeros(binned_shape, dtype=torch.int32), dist_reduce_fx="sum")


def _append_unbinned(metric: Metric, preds: Tensor, target: Tensor, valid: Tensor) -> None:
    """Accumulate one formatted batch into the unbinned list states, dropping masked samples."""
    if valid.ndim == 1 and not bool(valid.all()):
        preds, target, valid = preds[valid], target[valid], valid[valid]
    metric.preds.append(preds)
    metric.target.append(target)
    metric.valid.append(valid)


def _curve_state(metric: Metric):
    if metric.thresholds is None:
        return dim_zero_cat(metric.preds), dim_zero_cat(metric.target), dim_zero_cat(metric.valid)
    return metric.confmat


class BinaryPrecisionRecallCurve(Metric):
    """Binary precision-recall curve (binned with ``thresholds``, else exact)."""

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False

    def __init__(
        self,
        thresholds: Union[int, Sequence[float], Tensor, None] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        thresholds = _adjust_threshold_arg(thresholds)
        _add_curve_states(self, thresholds, (0 if thresholds is None else len(thresholds), 2, 2))

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate scores (unbinned) or the threshold-binned confusion counts."""
        if self.validate_args:
            _binary_precision_recall_curve_tensor_validation(preds, target, self.ignore_index)
        preds, target, valid, _ = _binary_precision_recall_curve_format(preds, target, None, self.ignore_index)
        if self.thresholds is None:
            _append_unbinned(self, preds, target, valid)
        else:
            self.confmat = self.confmat + _binary_precision_recall_curve_update(
                preds, target, valid, self.thresholds
            )

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        """(precision, recall, thresholds)."""
        return _binary_precision_recall_curve_compute(_curve_state(self), self.thresholds)


class MulticlassPrecisionRecallCurve(Metric):
    """Multiclass (one-vs-rest) precision-recall curves, or one micro-averaged curve."""

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False

    def __init__(
        self,
        num_classes: int,
        thresholds: Union[int, Sequence[float], Tensor, None] = None,
        average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index, average)
        if average == "macro":
            raise _macro_curves_not_ported()
        self.num_classes = num_classes
        self.average = average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        thresholds = _adjust_threshold_arg(thresholds)
        n_thr = 0 if thresholds is None else len(thresholds)
        _add_curve_states(self, thresholds, (n_thr, 2, 2) if average == "micro" else (n_thr, num_classes, 2, 2))

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate scores or binned confusion counts."""
        if self.validate_args:
            _multiclass_precision_recall_curve_tensor_validation(preds, target, self.num_classes, self.ignore_index)
        preds, target, valid, _ = _multiclass_precision_recall_curve_format(
            preds, target, self.num_classes, None, self.ignore_index, self.average
        )
        if self.thresholds is None:
            _append_unbinned(self, preds, target, valid)
        elif self.average == "micro":
            self.confmat = self.confmat + _binary_precision_recall_curve_update(
                preds, target, valid, self.thresholds
            )
        else:
            self.confmat = self.confmat + _multiclass_precision_recall_curve_update(
                preds, target, valid, self.num_classes, self.thresholds
            )

    def compute(self):
        """(precision, recall, thresholds), per class unless micro-averaged."""
        state = _curve_state(self)
        if self.average == "micro":
            return _binary_precision_recall_curve_compute(state, self.thresholds)
        return _multiclass_precision_recall_curve_compute(state, self.num_classes, self.thresholds, self.average)


class PrecisionRecallCurve(_ClassificationTaskWrapper):
    """Task-dispatch wrapper for the precision-recall curve."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: Union[int, Sequence[float], Tensor, None] = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ):
        task = ClassificationTask.from_str(task)
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryPrecisionRecallCurve(**kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassPrecisionRecallCurve(num_classes, **kwargs)
        raise _multilabel_not_ported(cls.__name__)
