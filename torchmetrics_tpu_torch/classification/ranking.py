"""Multilabel ranking module classes.

Counterpart of ``torchmetrics_tpu/classification/ranking.py``: float32 ``measure`` and
``total`` sums.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    _multilabel_precision_recall_curve_format,
)
from torchmetrics_tpu_torch.functional.classification.ranking import (
    _multilabel_coverage_error_update,
    _multilabel_ranking_average_precision_update,
    _multilabel_ranking_loss_update,
    _multilabel_ranking_tensor_validation,
)
from torchmetrics_tpu_torch.utils.data import safe_divide

Tensor = torch.Tensor


class _AbstractRanking(Metric):
    """Shared (measure, total) states + formatted update driver."""

    is_differentiable = False
    full_state_update: bool = False
    plot_lower_bound: float = 0.0

    measure: Tensor
    total: Tensor

    _update_fn = None  # set by subclass

    def __init__(
        self,
        num_labels: int,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args and (not isinstance(num_labels, int) or num_labels < 2):
            raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
        self.num_labels = num_labels
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self.add_state("measure", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate the ranking measure over the batch."""
        if self.validate_args:
            _multilabel_ranking_tensor_validation(preds, target, self.num_labels, self.ignore_index)
        preds, target, valid, _ = _multilabel_precision_recall_curve_format(
            preds, target, self.num_labels, None, self.ignore_index
        )
        measure, total = type(self)._update_fn(preds, target, valid)
        self.measure = self.measure + measure
        self.total = self.total + total

    def compute(self) -> Tensor:
        """Mean measure over all samples."""
        return safe_divide(self.measure, self.total)


class MultilabelCoverageError(_AbstractRanking):
    """Multilabel coverage error."""

    higher_is_better = False
    _update_fn = staticmethod(_multilabel_coverage_error_update)


class MultilabelRankingAveragePrecision(_AbstractRanking):
    """Multilabel label-ranking average precision."""

    higher_is_better = True
    plot_upper_bound: float = 1.0
    _update_fn = staticmethod(_multilabel_ranking_average_precision_update)


class MultilabelRankingLoss(_AbstractRanking):
    """Multilabel ranking loss."""

    higher_is_better = False
    _update_fn = staticmethod(_multilabel_ranking_loss_update)
