"""Quality with no reference (QNR): ``(1 - D_lambda)^alpha * (1 - D_s)^beta``.

Counterpart of ``torchmetrics_tpu/functional/image/qnr.py``.
"""

from __future__ import annotations

from typing import Optional

import torch

from torchmetrics_tpu_torch.functional.image.d_lambda import spectral_distortion_index
from torchmetrics_tpu_torch.functional.image.d_s import spatial_distortion_index

Tensor = torch.Tensor


def quality_with_no_reference(
    preds: Tensor,
    ms: Tensor,
    pan: Tensor,
    pan_lr: Optional[Tensor] = None,
    alpha: float = 1,
    beta: float = 1,
    norm_order: int = 1,
    window_size: int = 7,
    reduction: str = "elementwise_mean",
) -> Tensor:
    """Compute QNR, the combined no-reference pan-sharpening quality score.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image import quality_with_no_reference
        >>> g = torch.Generator().manual_seed(42)
        >>> preds = torch.rand(16, 3, 32, 32, generator=g)
        >>> ms, pan = torch.rand(16, 3, 16, 16, generator=g), torch.rand(16, 3, 32, 32, generator=g)
        >>> float(quality_with_no_reference(preds, ms, pan)) > 0.8
        True
    """
    if not isinstance(alpha, (int, float)) or alpha < 0:
        raise ValueError(f"Expected `alpha` to be a non-negative real number. Got alpha: {alpha}.")
    if not isinstance(beta, (int, float)) or beta < 0:
        raise ValueError(f"Expected `beta` to be a non-negative real number. Got beta: {beta}.")
    d_lambda = spectral_distortion_index(preds, ms, norm_order, reduction)
    d_s = spatial_distortion_index(preds, ms, pan, pan_lr, norm_order, window_size, reduction)
    return (1 - d_lambda) ** alpha * (1 - d_s) ** beta
