"""Cohen's kappa module classes.

Counterpart of ``torchmetrics_tpu/classification/cohen_kappa.py``: the state is the
confusion matrix of the confusion-matrix classes.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.confusion_matrix import BinaryConfusionMatrix, MulticlassConfusionMatrix
from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.functional.classification.cohen_kappa import (
    _cohen_kappa_arg_validation,
    _cohen_kappa_reduce,
)
from torchmetrics_tpu_torch.utils.enums import ClassificationTaskNoMultilabel

Tensor = torch.Tensor


class BinaryCohenKappa(BinaryConfusionMatrix):
    """Binary Cohen's kappa."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        weights: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(threshold, ignore_index, normalize=None, validate_args=False, **kwargs)
        if validate_args:
            _cohen_kappa_arg_validation(weights)
        self.weights = weights
        self.validate_args = validate_args

    def compute(self) -> Tensor:
        """Kappa from the confusion matrix."""
        return _cohen_kappa_reduce(self.confmat, self.weights)


class MulticlassCohenKappa(MulticlassConfusionMatrix):
    """Multiclass Cohen's kappa."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        num_classes: int,
        ignore_index: Optional[int] = None,
        weights: Optional[str] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(num_classes, ignore_index, normalize=None, validate_args=False, **kwargs)
        if validate_args:
            _cohen_kappa_arg_validation(weights)
        self.weights = weights
        self.validate_args = validate_args

    def compute(self) -> Tensor:
        """Kappa from the confusion matrix."""
        return _cohen_kappa_reduce(self.confmat, self.weights)


class CohenKappa(_ClassificationTaskWrapper):
    """Task-dispatch wrapper for Cohen's kappa (binary or multiclass)."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        weights: Optional[str] = None,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ):
        task = ClassificationTaskNoMultilabel.from_str(task)
        kwargs.update({"weights": weights, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTaskNoMultilabel.BINARY:
            return BinaryCohenKappa(threshold, **kwargs)
        if task == ClassificationTaskNoMultilabel.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassCohenKappa(num_classes, **kwargs)
        raise ValueError(f"Task {task} not supported!")


# These classes inherit curve/heatmap state handling but compute scalars;
# restore the base single-value plot, as the JAX package does.
for _cls in (BinaryCohenKappa, MulticlassCohenKappa):
    _cls.plot = Metric.plot
del _cls
