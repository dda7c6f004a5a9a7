"""Functional segmentation metrics.

Counterpart of ``torchmetrics_tpu/functional/segmentation/__init__.py``.
"""

from torchmetrics_tpu_torch.functional.segmentation.scores import generalized_dice_score, mean_iou

__all__ = ["generalized_dice_score", "mean_iou"]
