"""Functional detection metrics.

Counterpart of ``torchmetrics_tpu/functional/detection/__init__.py``.
"""

from torchmetrics_tpu_torch.functional.detection.box_ops import (
    complete_intersection_over_union,
    distance_intersection_over_union,
    generalized_intersection_over_union,
    intersection_over_union,
)
from torchmetrics_tpu_torch.functional.detection.panoptic import (
    modified_panoptic_quality,
    panoptic_quality,
)

__all__ = [
    "complete_intersection_over_union",
    "distance_intersection_over_union",
    "generalized_intersection_over_union",
    "intersection_over_union",
    "modified_panoptic_quality",
    "panoptic_quality",
]
