"""Detection metrics (stateful modules).

Counterpart of ``torchmetrics_tpu/detection/__init__.py`` (7 classes).
"""

from torchmetrics_tpu_torch.detection.iou_modules import (
    CompleteIntersectionOverUnion,
    DistanceIntersectionOverUnion,
    GeneralizedIntersectionOverUnion,
    IntersectionOverUnion,
)
from torchmetrics_tpu_torch.detection.mean_ap import MeanAveragePrecision
from torchmetrics_tpu_torch.detection.panoptic import ModifiedPanopticQuality, PanopticQuality

__all__ = [
    "CompleteIntersectionOverUnion",
    "DistanceIntersectionOverUnion",
    "GeneralizedIntersectionOverUnion",
    "IntersectionOverUnion",
    "MeanAveragePrecision",
    "ModifiedPanopticQuality",
    "PanopticQuality",
]
