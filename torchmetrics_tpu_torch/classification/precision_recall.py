"""Precision and recall module classes.

Counterpart of ``torchmetrics_tpu/classification/precision_recall.py``: each class
overrides only ``compute`` on a stat-scores base.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.classification.base import _ClassificationTaskWrapper
from torchmetrics_tpu_torch.classification.stat_scores import BinaryStatScores, MulticlassStatScores
from torchmetrics_tpu_torch.functional.classification._stat_reduce import _precision_recall_reduce
from torchmetrics_tpu_torch.functional.classification.stat_scores import _multilabel_not_ported
from torchmetrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor


class _BinaryPrecisionRecall(BinaryStatScores):
    _stat: str

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(self, *args: Any, zero_division: float = 0.0, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self.zero_division = zero_division

    def compute(self) -> Tensor:
        """The statistic from the counts."""
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce(
            self._stat, tp, fp, tn, fn, average="binary", multidim_average=self.multidim_average,
            zero_division=self.zero_division,
        )


class _MulticlassPrecisionRecall(MulticlassStatScores):
    _stat: str

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(self, *args: Any, zero_division: float = 0.0, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self.zero_division = zero_division

    def compute(self) -> Tensor:
        """The statistic from the per-class counts."""
        tp, fp, tn, fn = self._final_state()
        return _precision_recall_reduce(
            self._stat, tp, fp, tn, fn, average=self.average, multidim_average=self.multidim_average,
            top_k=self.top_k, zero_division=self.zero_division,
        )


class BinaryPrecision(_BinaryPrecisionRecall):
    """Binary precision: ``tp / (tp + fp)``."""

    _stat = "precision"


class MulticlassPrecision(_MulticlassPrecisionRecall):
    """Multiclass precision."""

    _stat = "precision"


class BinaryRecall(_BinaryPrecisionRecall):
    """Binary recall: ``tp / (tp + fn)``."""

    _stat = "recall"


class MulticlassRecall(_MulticlassPrecisionRecall):
    """Multiclass recall."""

    _stat = "recall"


def _task_metric(
    binary_cls: type,
    multiclass_cls: type,
    task: str,
    threshold: float,
    num_classes: Optional[int],
    average: Optional[str],
    multidim_average: str,
    top_k: Optional[int],
    ignore_index: Optional[int],
    validate_args: bool,
    zero_division: float,
    kwargs: dict,
):
    task = ClassificationTask.from_str(task)
    kwargs.update({
        "multidim_average": multidim_average,
        "ignore_index": ignore_index,
        "validate_args": validate_args,
        "zero_division": zero_division,
    })
    if task == ClassificationTask.BINARY:
        return binary_cls(threshold, **kwargs)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        if not isinstance(top_k, int):
            raise ValueError(f"`top_k` is expected to be `int` but `{type(top_k)} was passed.`")
        return multiclass_cls(num_classes, top_k, average, **kwargs)
    raise _multilabel_not_ported(binary_cls._stat.capitalize())


class Precision(_ClassificationTaskWrapper):
    """Task-dispatch wrapper: ``Precision(task="multiclass", num_classes=3)``."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "micro",
        multidim_average: str = "global",
        top_k: Optional[int] = 1,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0.0,
        **kwargs: Any,
    ):
        return _task_metric(
            BinaryPrecision, MulticlassPrecision, task, threshold, num_classes, average, multidim_average, top_k,
            ignore_index, validate_args, zero_division, kwargs,
        )


class Recall(_ClassificationTaskWrapper):
    """Task-dispatch wrapper: ``Recall(task="multiclass", num_classes=3)``."""

    def __new__(  # type: ignore[misc]
        cls,
        task: str,
        threshold: float = 0.5,
        num_classes: Optional[int] = None,
        num_labels: Optional[int] = None,
        average: Optional[str] = "micro",
        multidim_average: str = "global",
        top_k: Optional[int] = 1,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        zero_division: float = 0.0,
        **kwargs: Any,
    ):
        return _task_metric(
            BinaryRecall, MulticlassRecall, task, threshold, num_classes, average, multidim_average, top_k,
            ignore_index, validate_args, zero_division, kwargs,
        )
