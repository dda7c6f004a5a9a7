"""Spectral angle mapper.

Counterpart of ``torchmetrics_tpu/functional/image/sam.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.image.utils import _as_jax_dtype, _dtype_name, reduce
from torchmetrics_tpu_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor


def _sam_update(preds, target) -> Tuple[Tensor, Tensor]:
    """Validate multi-band BxCxHxW inputs (C > 1)."""
    preds = _as_jax_dtype(preds)
    target = _as_jax_dtype(target).to(preds.device)
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got preds: {_dtype_name(preds.dtype)} and target: {_dtype_name(target.dtype)}."
        )
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW shape."
            f" Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    if preds.shape[1] <= 1:
        raise ValueError(
            "Expected channel dimension of `preds` and `target` to be larger than 1."
            f" Got preds: {preds.shape[1]} and target: {target.shape[1]}."
        )
    return preds, target


def _sam_compute(preds: Tensor, target: Tensor, reduction: Optional[str] = "elementwise_mean") -> Tensor:
    """Per-pixel spectral angle between prediction and target band vectors."""
    dot_product = (preds * target).sum(dim=1)
    preds_norm = torch.sqrt((preds * preds).sum(dim=1))
    target_norm = torch.sqrt((target * target).sum(dim=1))
    sam_score = torch.arccos(torch.clamp(dot_product / (preds_norm * target_norm), -1, 1))
    return reduce(sam_score, reduction)


def spectral_angle_mapper(preds: Tensor, target: Tensor, reduction: Optional[str] = "elementwise_mean") -> Tensor:
    """Compute the spectral angle mapper score.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image import spectral_angle_mapper
        >>> g = torch.Generator().manual_seed(42)
        >>> preds, target = torch.rand(16, 3, 16, 16, generator=g), torch.rand(16, 3, 16, 16, generator=g)
        >>> float(spectral_angle_mapper(preds, target)) > 0
        True
    """
    preds, target = _sam_update(preds, target)
    return _sam_compute(preds, target, reduction)
