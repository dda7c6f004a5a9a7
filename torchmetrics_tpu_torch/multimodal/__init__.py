"""Multimodal metrics (stateful modules).

Counterpart of ``torchmetrics_tpu/multimodal/__init__.py``.
"""

from torchmetrics_tpu_torch.multimodal.clip_score import CLIPScore
from torchmetrics_tpu_torch.multimodal.clip_iqa import CLIPImageQualityAssessment

__all__ = ["CLIPImageQualityAssessment", "CLIPScore"]
