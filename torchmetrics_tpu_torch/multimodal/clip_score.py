"""CLIPScore module.

Counterpart of ``torchmetrics_tpu/multimodal/clip_score.py``, with its states
(``score``, ``n_samples``): the CLIP model of a local snapshot is loaded at construction
on the metric's device.
"""

from __future__ import annotations

from typing import Any, List, Union

import torch

from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.functional.multimodal.clip_score import (
    _DEFAULT_MODEL,
    _clip_score_update,
    _get_clip_model_and_processor,
)

Tensor = torch.Tensor


class CLIPScore(Metric):
    r"""CLIPScore: CLIP-embedding agreement between images and captions.

    ``model_name_or_path`` is a local snapshot directory (nothing is downloaded);
    construction raises a descriptive ``OSError`` when it is not there.
    """

    feature_network: str = "model"
    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 100.0

    score: Tensor
    n_samples: Tensor

    def __init__(self, model_name_or_path: str = _DEFAULT_MODEL, **kwargs: Any) -> None:
        kwargs.setdefault("jit_update", False)
        super().__init__(**kwargs)
        self.model, self.processor = _get_clip_model_and_processor(model_name_or_path, self.device)
        self.add_state("score", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("n_samples", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, images: Union[Tensor, List[Tensor]], text: Union[str, List[str]]) -> None:
        """Accumulate per-sample CLIP scores."""
        score, n_samples = _clip_score_update(images, text, self.model, self.processor)
        self.score = self.score + score.sum(0)
        self.n_samples = self.n_samples + n_samples

    def compute(self) -> Tensor:
        """Mean CLIPScore, clamped at zero."""
        return torch.maximum(self.score / self.n_samples, torch.zeros_like(self.score))
