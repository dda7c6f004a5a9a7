"""Functional multimodal metrics.

Counterpart of ``torchmetrics_tpu/functional/multimodal/__init__.py``.
"""

from torchmetrics_tpu_torch.functional.multimodal.clip_score import clip_score
from torchmetrics_tpu_torch.functional.multimodal.clip_iqa import clip_image_quality_assessment

__all__ = ["clip_image_quality_assessment", "clip_score"]
