"""Relative average spectral error.

Counterpart of ``torchmetrics_tpu/functional/image/rase.py``, on the port's
sliding-window RMSE and its uniform filter.
"""

from __future__ import annotations

from typing import Tuple

import torch

from torchmetrics_tpu_torch.functional.image.rmse_sw import _rmse_sw_compute, _rmse_sw_update
from torchmetrics_tpu_torch.functional.image.utils import _as_jax_dtype, _uniform_filter

Tensor = torch.Tensor


def _rase_update(
    preds: Tensor,
    target: Tensor,
    window_size: int,
    rmse_map: Tensor,
    target_sum: Tensor,
    total_images: Tensor,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Accumulate the RMSE map and windowed target mean over the batch."""
    _, rmse_map, total_images = _rmse_sw_update(
        preds, target, window_size, rmse_val_sum=None, rmse_map=rmse_map, total_images=total_images
    )
    target_sum = target_sum + torch.sum(_uniform_filter(target, window_size) / (window_size**2), dim=0)
    return rmse_map, target_sum, total_images


def _rase_compute(rmse_map: Tensor, target_sum: Tensor, total_images: Tensor, window_size: int) -> Tensor:
    """RASE from the accumulated RMSE map and target means."""
    _, rmse_map = _rmse_sw_compute(rmse_val_sum=None, rmse_map=rmse_map, total_images=total_images)
    target_mean = target_sum / total_images
    target_mean = target_mean.mean(dim=0)  # mean over image channels
    rase_map = 100 / target_mean * torch.sqrt(torch.mean(torch.square(rmse_map), dim=0))
    crop = round(window_size / 2)
    return torch.mean(rase_map[crop:-crop, crop:-crop])


def relative_average_spectral_error(preds: Tensor, target: Tensor, window_size: int = 8) -> Tensor:
    """Compute the relative average spectral error.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image import relative_average_spectral_error
        >>> g = torch.Generator().manual_seed(22)
        >>> preds, target = torch.rand(4, 3, 16, 16, generator=g), torch.rand(4, 3, 16, 16, generator=g)
        >>> float(relative_average_spectral_error(preds, target)) > 0
        True
    """
    if not isinstance(window_size, int) or window_size < 1:
        raise ValueError("Argument `window_size` is expected to be a positive integer.")
    preds = _as_jax_dtype(preds)
    target = _as_jax_dtype(target).to(preds.device)
    img_shape = target.shape[1:]
    rmse_map = torch.zeros(img_shape, dtype=target.dtype, device=target.device)
    target_sum = torch.zeros(img_shape, dtype=target.dtype, device=target.device)
    total_images = torch.zeros((), device=target.device)
    rmse_map, target_sum, total_images = _rase_update(preds, target, window_size, rmse_map, target_sum, total_images)
    return _rase_compute(rmse_map, target_sum, total_images, window_size)
