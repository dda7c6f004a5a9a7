"""Average precision module classes (they share state with the precision-recall curve).

Counterpart of ``torchmetrics_tpu/classification/average_precision.py``.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.precision_recall_curve import (
    BinaryPrecisionRecallCurve,
    MulticlassPrecisionRecallCurve,
    _curve_state,
)
from torchmetrics_tpu_torch.functional.classification.auroc import _validate_average_arg
from torchmetrics_tpu_torch.functional.classification.average_precision import (
    _binary_average_precision_compute,
    _multiclass_average_precision_compute,
)
from torchmetrics_tpu_torch.functional.classification.stat_scores import _multilabel_not_ported
from torchmetrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


class BinaryAveragePrecision(BinaryPrecisionRecallCurve):
    """Binary average precision."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False

    def compute(self) -> Tensor:
        """AP from the accumulated state."""
        return _binary_average_precision_compute(_curve_state(self), self.thresholds)


class MulticlassAveragePrecision(MulticlassPrecisionRecallCurve):
    """Multiclass average precision (one-vs-rest)."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False

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
        self.average_ap = average
        self.validate_args = validate_args

    def compute(self) -> Tensor:
        """AP from the accumulated state."""
        return _multiclass_average_precision_compute(
            _curve_state(self), self.num_classes, self.thresholds, self.average_ap
        )


class AveragePrecision(_ClassificationTaskWrapper):
    """Task-dispatch wrapper for average precision."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        thresholds: Union[int, Sequence[float], Tensor, None] = None,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "macro",
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ):
        task = ClassificationTask.from_str(task)
        kwargs.update({"thresholds": thresholds, "ignore_index": ignore_index, "validate_args": validate_args})
        if task == ClassificationTask.BINARY:
            return BinaryAveragePrecision(**kwargs)
        if task == ClassificationTask.MULTICLASS:
            if not isinstance(num_classes, int):
                raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
            return MulticlassAveragePrecision(num_classes, average, **kwargs)
        raise _multilabel_not_ported(cls.__name__)
