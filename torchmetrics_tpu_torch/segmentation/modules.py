"""Segmentation metric modules.

Counterpart of ``torchmetrics_tpu/segmentation/modules.py``: the same states, their
reductions and JAX's semantics. ``GeneralizedDiceScore`` sums the per-sample scores
(``score``) and the samples (``samples``). ``MeanIoU`` adds each batch's mean to
``score``, which a sync reduces by ``"mean"``, and ``compute`` returns that sum of
batch means, the reference's documented behaviour. With index input each update is
one bincount-kernel launch (``functional/segmentation/scores.py``).
"""

from __future__ import annotations

from typing import Any

import torch

from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.functional.segmentation.scores import (
    _generalized_dice_compute,
    _generalized_dice_update,
    _generalized_dice_validate_args,
    _mean_iou_compute,
    _mean_iou_update,
    _mean_iou_validate_args,
)

Tensor = torch.Tensor


class GeneralizedDiceScore(Metric):
    r"""Generalized dice score for semantic segmentation.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.segmentation import GeneralizedDiceScore
        >>> preds = torch.randint(0, 2, (4, 5, 16, 16), generator=torch.Generator().manual_seed(0))
        >>> target = torch.randint(0, 2, (4, 5, 16, 16), generator=torch.Generator().manual_seed(1))
        >>> gds = GeneralizedDiceScore(num_classes=5, device="cpu")
        >>> 0 <= float(gds(preds, target)) <= 1
        True
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    score: Tensor
    samples: Tensor

    def __init__(
        self,
        num_classes: int,
        include_background: bool = True,
        per_class: bool = False,
        weight_type: str = "square",
        input_format: str = "one-hot",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _generalized_dice_validate_args(num_classes, include_background, per_class, weight_type, input_format)
        self.num_classes = num_classes
        self.include_background = include_background
        self.per_class = per_class
        self.weight_type = weight_type
        self.input_format = input_format

        num_score_classes = num_classes - (0 if include_background else 1)
        self.add_state("score", torch.zeros(num_score_classes if per_class else 1), dist_reduce_fx="sum")
        self.add_state("samples", torch.zeros(1), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate per-sample dice scores."""
        numerator, denominator = _generalized_dice_update(
            preds, target, self.num_classes, self.include_background, self.weight_type, self.input_format
        )
        self.score = self.score + _generalized_dice_compute(numerator, denominator, self.per_class).sum(dim=0)
        self.samples = self.samples + preds.shape[0]

    def compute(self) -> Tensor:
        """Mean dice score over all samples."""
        return self.score / self.samples


class MeanIoU(Metric):
    r"""Mean intersection over union for semantic segmentation.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.segmentation import MeanIoU
        >>> preds = torch.randint(0, 2, (4, 5, 16, 16), generator=torch.Generator().manual_seed(0))
        >>> target = torch.randint(0, 2, (4, 5, 16, 16), generator=torch.Generator().manual_seed(1))
        >>> miou = MeanIoU(num_classes=5, device="cpu")
        >>> 0 <= float(miou(preds, target)) <= 1
        True
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    score: Tensor

    def __init__(
        self,
        num_classes: int,
        include_background: bool = True,
        per_class: bool = False,
        input_format: str = "one-hot",
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        _mean_iou_validate_args(num_classes, include_background, per_class, input_format)
        self.num_classes = num_classes
        self.include_background = include_background
        self.per_class = per_class
        self.input_format = input_format

        num_score_classes = num_classes - (0 if include_background else 1)
        self.add_state("score", torch.zeros(num_score_classes if per_class else 1).squeeze(), dist_reduce_fx="mean")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate the batch-mean IoU (running mean via the reference's sum-then-rely-on-mean-sync)."""
        intersection, union = _mean_iou_update(
            preds, target, self.num_classes, self.include_background, self.input_format
        )
        score = _mean_iou_compute(intersection, union, per_class=self.per_class)
        self.score = self.score + (score.mean(dim=0) if self.per_class else score.mean())

    def compute(self) -> Tensor:
        """Accumulated IoU score (reference semantics: sum of batch means)."""
        return self.score
