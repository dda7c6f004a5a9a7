"""ROC module classes.

Counterpart of ``torchmetrics_tpu/classification/roc.py``: each subclasses its task's
PR-curve class and shares its state (and so its compute group); only ``compute``
differs. The binned binary and micro-averaged updates reach the binned-curve kernel.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
    _curve_state,
)
from torchmetrics_tpu_torch.functional.classification.roc import (
    _binary_roc_compute,
    _multiclass_roc_compute,
    _multilabel_roc_compute,
)
from torchmetrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


class BinaryROC(BinaryPrecisionRecallCurve):
    """Binary ROC curve."""

    def compute(self) -> Tuple[Tensor, Tensor, Tensor]:
        """(fpr, tpr, thresholds)."""
        return _binary_roc_compute(_curve_state(self), self.thresholds)

    def plot(self, curve: Optional[Tuple] = None, score: Optional[Tensor] = None, ax: Any = None):
        """Plot the ROC curve (``compute()`` when ``curve`` is None)."""
        from torchmetrics_tpu_torch.utils.plot import plot_curve

        curve = curve or self.compute()
        return plot_curve(curve, score=score, ax=ax, label_names=("False positive rate", "True positive rate"))


class MulticlassROC(MulticlassPrecisionRecallCurve):
    """Multiclass one-vs-rest ROC curves, or one micro-averaged curve."""

    def compute(self):
        """(fpr, tpr, thresholds) per class unless micro-averaged."""
        state = _curve_state(self)
        if self.average == "micro":
            return _binary_roc_compute(state, self.thresholds)
        return _multiclass_roc_compute(state, self.num_classes, self.thresholds, self.average)

    def plot(self, curve: Optional[Tuple] = None, score: Optional[Tensor] = None, ax: Any = None):
        """Plot the ROC curve (``compute()`` when ``curve`` is None)."""
        from torchmetrics_tpu_torch.utils.plot import plot_curve

        curve = curve or self.compute()
        return plot_curve(curve, score=score, ax=ax, label_names=("False positive rate", "True positive rate"))


class MultilabelROC(MultilabelPrecisionRecallCurve):
    """Per-label ROC curves."""

    def compute(self):
        """(fpr, tpr, thresholds) per label."""
        return _multilabel_roc_compute(_curve_state(self), self.num_labels, self.thresholds, self.ignore_index)

    def plot(self, curve: Optional[Tuple] = None, score: Optional[Tensor] = None, ax: Any = None):
        """Plot the ROC curve (``compute()`` when ``curve`` is None)."""
        from torchmetrics_tpu_torch.utils.plot import plot_curve

        curve = curve or self.compute()
        return plot_curve(curve, score=score, ax=ax, label_names=("False positive rate", "True positive rate"))


class ROC(_ClassificationTaskWrapper):
    """Task-dispatch wrapper for ROC."""

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
            return BinaryROC(**kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassROC(num_classes, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
            return MultilabelROC(num_labels, **kwargs)
        raise ValueError(f"Task {task} not supported!")
