"""Jaccard index module classes.

Counterpart of ``torchmetrics_tpu/classification/jaccard.py``: the state is the
confusion matrix of the confusion-matrix classes.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.confusion_matrix import (
    BinaryConfusionMatrix,
    MulticlassConfusionMatrix,
    MultilabelConfusionMatrix,
)
from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.functional.classification.jaccard import (
    _jaccard_index_arg_validation,
    _jaccard_index_reduce,
)
from torchmetrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


class BinaryJaccardIndex(BinaryConfusionMatrix):
    """Binary Jaccard index (IoU)."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(threshold, ignore_index, normalize=None, validate_args=validate_args, **kwargs)
        self.zero_division = zero_division

    def compute(self) -> Tensor:
        """The Jaccard index from the confusion matrix."""
        return _jaccard_index_reduce(self.confmat, average="binary", zero_division=self.zero_division)


class MulticlassJaccardIndex(MulticlassConfusionMatrix):
    """Multiclass Jaccard index."""

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
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes, ignore_index, normalize=None, validate_args=validate_args, **kwargs)
        if validate_args:
            _jaccard_index_arg_validation(average)
        self.average = average
        self.zero_division = zero_division

    def compute(self) -> Tensor:
        """The Jaccard index from the confusion matrix."""
        return _jaccard_index_reduce(
            self.confmat, average=self.average, ignore_index=self.ignore_index, zero_division=self.zero_division
        )


class MultilabelJaccardIndex(MultilabelConfusionMatrix):
    """Multilabel Jaccard index."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0
    plot_legend_name: str = "Label"

    def __init__(
        self,
        num_labels: int,
        threshold: float = 0.5,
        average: Optional[str] = "macro",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_labels, threshold, ignore_index, normalize=None, validate_args=validate_args, **kwargs)
        if validate_args:
            _jaccard_index_arg_validation(average)
        self.average = average
        self.zero_division = zero_division

    def compute(self) -> Tensor:
        """The Jaccard index from the per-label confusion matrices."""
        return _jaccard_index_reduce(
            self.confmat, average=self.average, ignore_index=self.ignore_index, zero_division=self.zero_division
        )


class JaccardIndex(_ClassificationTaskWrapper):
    """Task-dispatch wrapper for the Jaccard index."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "macro",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0.0,
        **kwargs: Any,
    ):
        task = ClassificationTask.from_str(task)
        kwargs.update({"ignore_index": ignore_index, "validate_args": validate_args, "zero_division": zero_division})
        if task == ClassificationTask.BINARY:
            return BinaryJaccardIndex(threshold, **kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassJaccardIndex(num_classes, average, **kwargs)
        if task == ClassificationTask.MULTILABEL:
            if not isinstance(num_labels, int):
                raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
            return MultilabelJaccardIndex(num_labels, threshold, average, **kwargs)
        raise ValueError(f"Task {task} not supported!")


# These classes inherit curve/heatmap state handling but compute scalars;
# restore the base single-value plot, as the JAX package does.
for _cls in (BinaryJaccardIndex, MulticlassJaccardIndex, MultilabelJaccardIndex):
    _cls.plot = Metric.plot
del _cls
