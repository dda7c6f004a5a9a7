"""PrecisionRecallCurve module classes — the state of the threshold-curve family.

Counterpart of ``torchmetrics_tpu/classification/precision_recall_curve.py``. With
``thresholds`` the state is a static int32 confusion accumulator and the thresholds
are a buffer on the metric's device; without, raw scores accumulate in list states,
or, with ``buffer_capacity``, in ``MaskedBuffer`` states of that many samples (of
``num_labels`` scores each for multilabel), whose padding counts as invalid samples at
compute.
``MulticlassPrecisionRecallCurve(average="micro")`` flattens to one binary problem
and so reaches the binned-curve CUDA kernel.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.core.buffer import MaskedBuffer
from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    _adjust_threshold_arg,
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
from torchmetrics_tpu_torch.utils.data import dim_zero_cat
from torchmetrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


def _thresholds_key(thresholds: Optional[Tensor]) -> Optional[tuple]:
    """Hashable form of the thresholds for the static compute-group key."""
    return None if thresholds is None else tuple(thresholds.tolist())


def _add_curve_states(
    metric: Metric,
    thresholds: Optional[Tensor],
    binned_shape: Tuple[int, ...],
    buffer_capacity: Optional[int],
    pred_item: Tuple[int, ...] = (),
    label_item: Tuple[int, ...] = (),
) -> None:
    """Register the thresholds buffer and the binned accumulator, or the unbinned states:
    ``MaskedBuffer``s of ``buffer_capacity`` samples when it is given (scores of shape
    ``pred_item``, labels and validity of shape ``label_item``), else lists."""
    if buffer_capacity is not None and thresholds is not None:
        raise ValueError(
            "`buffer_capacity` only applies to unbinned mode — it cannot be combined"
            " with `thresholds` (binned mode already has static-shape state)."
        )
    metric.buffer_capacity = buffer_capacity
    # read once here, while the thresholds are still where the caller made them: the
    # key then needs no copy from the card
    metric._thresholds_key = _thresholds_key(thresholds)
    if thresholds is None:
        metric.thresholds = None
        if buffer_capacity is None:
            for name in ("preds", "target", "valid"):
                metric.add_state(name, [], dist_reduce_fx="cat")
        else:
            for name, item, dtype in (("preds", pred_item, torch.float32), ("target", label_item, torch.int32),
                                      ("valid", label_item, torch.bool)):
                metric.add_state(name, MaskedBuffer.create(buffer_capacity, item, dtype), dist_reduce_fx="cat")
    else:
        metric.register_buffer("thresholds", thresholds.to(metric.device), persistent=False)
        metric.add_state("confmat", torch.zeros(binned_shape, dtype=torch.int32), dist_reduce_fx="sum")


def _append_unbinned(metric: Metric, preds: Tensor, target: Tensor, valid: Tensor) -> None:
    """Accumulate one formatted batch into the unbinned states: appended whole to the
    buffers, or with masked samples dropped to the lists."""
    if metric.buffer_capacity is not None:
        metric.preds = metric.preds.append(preds)
        metric.target = metric.target.append(target)
        metric.valid = metric.valid.append(valid)
        return
    if valid.ndim == 1 and not bool(valid.all()):
        preds, target, valid = preds[valid], target[valid], valid[valid]
    metric.preds.append(preds)
    metric.target.append(target)
    metric.valid.append(valid)


def _curve_state(metric: Metric):
    if metric.thresholds is not None:
        return metric.confmat
    if metric.buffer_capacity is not None:
        # the padding past the count is invalid, as an ignored sample is
        valid = metric.valid.data
        mask = metric.preds.mask.reshape(metric.preds.mask.shape + (1,) * (valid.ndim - 1))
        return metric.preds.data, metric.target.data, valid & mask
    return dim_zero_cat(metric.preds), dim_zero_cat(metric.target), dim_zero_cat(metric.valid)


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
        buffer_capacity: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        thresholds = _adjust_threshold_arg(thresholds)
        _add_curve_states(self, thresholds, (0 if thresholds is None else len(thresholds), 2, 2), buffer_capacity)

    def _compute_group_params(self):
        return (self._thresholds_key, self.ignore_index, self.buffer_capacity)

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

    def plot(self, curve: Optional[Tuple] = None, score: Optional[Tensor] = None, ax: Any = None):
        """Plot the curve (``compute()`` when ``curve`` is None)."""
        from torchmetrics_tpu_torch.utils.plot import plot_curve

        curve = curve or self.compute()
        return plot_curve(curve, score=score, ax=ax, label_names=("Recall", "Precision"))


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
        buffer_capacity: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index, average)
        self.num_classes = num_classes
        self.average = average
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        thresholds = _adjust_threshold_arg(thresholds)
        n_thr = 0 if thresholds is None else len(thresholds)
        # micro-averaged, the problem is binary: a buffer counts (sample, class) pairs
        _add_curve_states(
            self, thresholds, (n_thr, 2, 2) if average == "micro" else (n_thr, num_classes, 2, 2),
            buffer_capacity, () if average == "micro" else (num_classes,),
        )

    def _compute_group_params(self):
        # micro-averaging changes the accumulated state itself (one binary confmat)
        return (self.num_classes, self._thresholds_key, self.ignore_index, self.average == "micro",
                self.buffer_capacity)

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

    def plot(self, curve: Optional[Tuple] = None, score: Optional[Tensor] = None, ax: Any = None):
        """Plot the curve (``compute()`` when ``curve`` is None)."""
        from torchmetrics_tpu_torch.utils.plot import plot_curve

        curve = curve or self.compute()
        return plot_curve(curve, score=score, ax=ax, label_names=("Recall", "Precision"))


class MultilabelPrecisionRecallCurve(Metric):
    """Per-label precision-recall curves."""

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False

    def __init__(
        self,
        num_labels: int,
        thresholds: Union[int, Sequence[float], Tensor, None] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        buffer_capacity: Optional[int] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        self.num_labels = num_labels
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        thresholds = _adjust_threshold_arg(thresholds)
        _add_curve_states(
            self, thresholds, (0 if thresholds is None else len(thresholds), num_labels, 2, 2), buffer_capacity,
            (num_labels,), (num_labels,),
        )

    def _compute_group_params(self):
        return (self.num_labels, self._thresholds_key, self.ignore_index, self.buffer_capacity)

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate scores or binned confusion counts."""
        if self.validate_args:
            _multilabel_precision_recall_curve_tensor_validation(preds, target, self.num_labels, self.ignore_index)
        preds, target, valid, _ = _multilabel_precision_recall_curve_format(
            preds, target, self.num_labels, None, self.ignore_index
        )
        if self.thresholds is None:
            _append_unbinned(self, preds, target, valid)
        else:
            self.confmat = self.confmat + _multilabel_precision_recall_curve_update(
                preds, target, valid, self.num_labels, self.thresholds
            )

    def compute(self):
        """(precision, recall, thresholds) per label."""
        return _multilabel_precision_recall_curve_compute(
            _curve_state(self), self.num_labels, self.thresholds, self.ignore_index
        )

    def plot(self, curve: Optional[Tuple] = None, score: Optional[Tensor] = None, ax: Any = None):
        """Plot the curve (``compute()`` when ``curve`` is None)."""
        from torchmetrics_tpu_torch.utils.plot import plot_curve

        curve = curve or self.compute()
        return plot_curve(curve, score=score, ax=ax, label_names=("Recall", "Precision"))


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
        if task == ClassificationTask.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
            return MultilabelPrecisionRecallCurve(num_labels, **kwargs)
        raise ValueError(f"Task {task} not supported!")
