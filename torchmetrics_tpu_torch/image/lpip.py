"""Learned perceptual image patch similarity (LPIPS) module.

Counterpart of ``torchmetrics_tpu/image/lpip.py``, with the same states. The named
backbone is built at construction on the metric's device (a missing weights file
raises there, as in JAX); the metric owns it, and it moves with the metric.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch

from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.functional.image.lpips import (
    _cached_backbone_fn,
    learned_perceptual_image_patch_similarity,
)

Tensor = torch.Tensor


class LearnedPerceptualImagePatchSimilarity(Metric):
    r"""LPIPS metric module.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.image import LearnedPerceptualImagePatchSimilarity
        >>> feature_fn = lambda img: [img, img[:, :, ::2, ::2]]
        >>> lpips = LearnedPerceptualImagePatchSimilarity(feature_fn=feature_fn, device="cpu")
        >>> g = torch.Generator().manual_seed(42)
        >>> img1 = torch.rand(4, 3, 16, 16, generator=g) * 2 - 1
        >>> img2 = torch.rand(4, 3, 16, 16, generator=g) * 2 - 1
        >>> lpips.update(img1, img2)
        >>> float(lpips.compute()) > 0
        True
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    sum_scores: Tensor
    total: Tensor

    def __init__(
        self,
        net_type: str = "alex",
        reduction: str = "mean",
        normalize: bool = False,
        feature_fn: Optional[Callable[[Tensor], Sequence[Tensor]]] = None,
        head_weights: Optional[Sequence[Tensor]] = None,
        weights_path: Optional[str] = None,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("jit_update", False)
        super().__init__(**kwargs)
        valid_net_type = ("vgg", "alex", "squeeze")
        if net_type not in valid_net_type:
            raise ValueError(f"Argument `net_type` must be one of {valid_net_type}, but got {net_type}.")
        valid_reduction = ("mean", "sum")
        if reduction not in valid_reduction:
            raise ValueError(f"Argument `reduction` must be one of {valid_reduction}, but got {reduction}")
        if not isinstance(normalize, bool):
            raise ValueError(f"Argument `normalize` should be a bool but got {normalize}")
        if feature_fn is None:
            # fail at construction (the reference raises at __init__ too when torchvision
            # is missing) rather than on the first update
            try:
                feature_fn = _cached_backbone_fn(net_type, weights_path, self.device, shared=False)
            except FileNotFoundError as err:
                raise ModuleNotFoundError(
                    f"The `{net_type}` LPIPS backbone requires pretrained torchvision weights,"
                    " which cannot be downloaded in this environment. Provide them locally"
                    " (`weights_path` / $TORCHMETRICS_TPU_LPIPS_BACKBONES) or pass"
                    " `feature_fn` to use the native LPIPS machinery with your own backbone."
                ) from err
        self.net_type = net_type
        self.reduction = reduction
        self.normalize = normalize
        self.feature_fn = feature_fn
        self.head_weights = head_weights

        self.add_state("sum_scores", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, img1: Tensor, img2: Tensor) -> None:
        """Accumulate per-pair LPIPS distances."""
        loss = learned_perceptual_image_patch_similarity(
            img1, img2, self.net_type, reduction="sum", normalize=self.normalize,
            feature_fn=self.feature_fn, head_weights=self.head_weights,
        )
        self.sum_scores = self.sum_scores + loss
        self.total = self.total + torch.as_tensor(img1).shape[0]

    def compute(self) -> Tensor:
        """Reduced LPIPS over all pairs."""
        if self.reduction == "mean":
            return self.sum_scores / self.total
        return self.sum_scores
