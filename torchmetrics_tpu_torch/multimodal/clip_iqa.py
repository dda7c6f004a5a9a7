"""CLIPImageQualityAssessment module.

Counterpart of ``torchmetrics_tpu/multimodal/clip_iqa.py``, with its state
(``probs_list``); the functional runs on the metric's device.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch

from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.functional.multimodal.clip_iqa import (
    _clip_iqa_format_prompts,
    clip_image_quality_assessment,
)
from torchmetrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class CLIPImageQualityAssessment(Metric):
    r"""CLIP-IQA: no-reference image quality from antonym prompt pairs.

    ``model_name_or_path`` is a local snapshot directory (``"clip_iqa"`` names
    ``openai/clip-vit-base-patch32``); the first ``update`` raises a descriptive
    ``OSError`` when it is not there.
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        model_name_or_path: str = "clip_iqa",
        data_range: float = 1.0,
        prompts: Union[Tuple[str, ...], str] = ("quality",),
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("jit_update", False)
        super().__init__(**kwargs)
        self.model_name_or_path = model_name_or_path
        self.data_range = data_range
        self.prompts = prompts
        self.prompts_names, _ = _clip_iqa_format_prompts(prompts)
        self.add_state("probs_list", [], dist_reduce_fx="cat")

    def update(self, images: Tensor) -> None:
        """Score the batch against the prompt pairs and store per-sample probabilities."""
        result = clip_image_quality_assessment(
            images, self.model_name_or_path, self.data_range, self.prompts, device=self.device
        )
        if isinstance(result, dict):
            stacked = torch.stack([result[name] for name in self.prompts_names], dim=1)
        else:
            stacked = result[:, None]
        self.probs_list.append(stacked)

    def compute(self) -> Union[Tensor, Dict[str, Tensor]]:
        """Per-sample scores (single prompt) or a dict of per-prompt score vectors."""
        probs = dim_zero_cat(self.probs_list)
        if len(self.prompts_names) == 1:
            return probs.squeeze(-1)
        return {name: probs[:, i] for i, name in enumerate(self.prompts_names)}
