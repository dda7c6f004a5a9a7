"""AUROC module classes (they share state with the precision-recall curve).

Counterpart of ``torchmetrics_tpu/classification/auroc.py``.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    MultilabelPrecisionRecallCurve,
    _curve_state,
)
from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.functional.classification.auroc import (
    _binary_auroc_arg_validation,
    _binary_auroc_compute,
    _multiclass_auroc_compute,
    _multilabel_auroc_compute,
    _validate_average_arg,
)
from torchmetrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


class BinaryAUROC(BinaryPrecisionRecallCurve):
    """Binary area under the ROC curve."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        max_fpr: Optional[float] = None,
        thresholds: Union[int, Sequence[float], Tensor, None] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs)
        if validate_args:
            _binary_auroc_arg_validation(max_fpr, thresholds, ignore_index)
        self.max_fpr = max_fpr
        self.validate_args = validate_args

    def compute(self) -> Tensor:
        """AUROC from the accumulated state."""
        return _binary_auroc_compute(_curve_state(self), self.thresholds, self.max_fpr)


class MulticlassAUROC(MulticlassPrecisionRecallCurve):
    """Multiclass AUROC (one-vs-rest)."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Class"

    def __init__(
        self,
        num_classes: int,
        average: Optional[str] = "macro",
        thresholds: Union[int, Sequence[float], Tensor, None] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        # the curve state never takes the micro shortcut here; average applies at compute
        super().__init__(
            num_classes=num_classes, thresholds=thresholds, average=None,
            ignore_index=ignore_index, validate_args=False, **kwargs,
        )
        if validate_args:
            _validate_average_arg(average)
        self.average_auroc = average
        self.validate_args = validate_args

    def compute(self) -> Tensor:
        """AUROC from the accumulated state."""
        return _multiclass_auroc_compute(_curve_state(self), self.num_classes, self.thresholds, self.average_auroc)


class MultilabelAUROC(MultilabelPrecisionRecallCurve):
    """Multilabel AUROC (micro: one curve over every (sample, label) pair)."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Label"

    def __init__(
        self,
        num_labels: int,
        average: Optional[str] = "macro",
        thresholds: Union[int, Sequence[float], Tensor, None] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            num_labels=num_labels, thresholds=thresholds, ignore_index=ignore_index, validate_args=False, **kwargs
        )
        if validate_args:
            _validate_average_arg(average, allowed=("micro", "macro", "weighted", "none", None))
        self.average_auroc = average
        self.validate_args = validate_args

    def compute(self) -> Tensor:
        """AUROC from the accumulated state."""
        return _multilabel_auroc_compute(
            _curve_state(self), self.num_labels, self.thresholds, self.average_auroc, self.ignore_index
        )


class AUROC(_ClassificationTaskWrapper):
    """Task-dispatch wrapper for AUROC."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: Union[int, Sequence[float], Tensor, None] = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "macro",
        max_fpr: Optional[float] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ):
        task = ClassificationTask.from_str(task)
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryAUROC(max_fpr, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassAUROC(num_classes, average, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
            return MultilabelAUROC(num_labels, average, **kwargs)
        raise ValueError(f"Task {task} not supported!")


# These classes inherit curve/heatmap state handling but compute scalars;
# restore the base single-value plot, as the JAX package does.
for _cls in (BinaryAUROC, MulticlassAUROC, MultilabelAUROC):
    _cls.plot = Metric.plot
del _cls
