"""Segmentation metrics (stateful modules).

Counterpart of ``torchmetrics_tpu/segmentation/__init__.py`` (2 classes).
"""

from torchmetrics_tpu_torch.segmentation.modules import GeneralizedDiceScore, MeanIoU

__all__ = ["GeneralizedDiceScore", "MeanIoU"]
