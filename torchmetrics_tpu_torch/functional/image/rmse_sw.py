"""Sliding-window RMSE.

Counterpart of ``torchmetrics_tpu/functional/image/rmse_sw.py``: a uniform filter
with symmetric padding (a full-float32 convolution) over the squared error.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.image.utils import _as_jax_dtype, _dtype_name, _uniform_filter
from torchmetrics_tpu_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor


def _rmse_sw_checks(preds, target, window_size: int) -> Tuple[Tensor, Tensor]:
    """Validate BxCxHxW inputs and window size."""
    preds = _as_jax_dtype(preds)
    target = _as_jax_dtype(target).to(preds.device)
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" But got {_dtype_name(preds.dtype)} and {_dtype_name(target.dtype)}."
        )
    _check_same_shape(preds, target)
    if preds.ndim != 4:
        raise ValueError(f"Expected `preds` and `target` to have BxCxHxW shape. But got {tuple(preds.shape)}.")
    if round(window_size / 2) >= target.shape[2] or round(window_size / 2) >= target.shape[3]:
        raise ValueError(
            f"Parameter `round(window_size / 2)` is expected to be smaller than"
            f" {min(target.shape[2], target.shape[3])} but got {round(window_size / 2)}."
        )
    return preds, target


def _rmse_sw_update(
    preds: Tensor,
    target: Tensor,
    window_size: int,
    rmse_val_sum: Optional[Tensor],
    rmse_map: Optional[Tensor],
    total_images: Optional[Tensor],
) -> Tuple[Optional[Tensor], Tensor, Tensor]:
    """Accumulate the per-batch RMSE map (and the windowed RMSE sum)."""
    preds, target = _rmse_sw_checks(preds, target, window_size)

    batch = torch.tensor(target.shape[0], dtype=torch.float32, device=target.device)
    total_images = batch if total_images is None else total_images + batch

    error = torch.square(target - preds)
    error = _uniform_filter(error, window_size)
    batch_rmse_map = torch.sqrt(error)
    crop = round(window_size / 2)

    batch_rmse_val = batch_rmse_map[:, :, crop:-crop, crop:-crop].sum(dim=0).mean()
    new_rmse_val_sum = batch_rmse_val if rmse_val_sum is None else rmse_val_sum + batch_rmse_val
    new_rmse_map = batch_rmse_map.sum(dim=0) if rmse_map is None else rmse_map + batch_rmse_map.sum(dim=0)
    return new_rmse_val_sum, new_rmse_map, total_images


def _rmse_sw_compute(
    rmse_val_sum: Optional[Tensor], rmse_map: Tensor, total_images: Tensor
) -> Tuple[Optional[Tensor], Tensor]:
    """Final mean over images for both the scalar RMSE and the RMSE map."""
    rmse = rmse_val_sum / total_images if rmse_val_sum is not None else None
    return rmse, rmse_map / total_images


def root_mean_squared_error_using_sliding_window(
    preds: Tensor, target: Tensor, window_size: int = 8, return_rmse_map: bool = False
) -> Union[Optional[Tensor], Tuple[Optional[Tensor], Tensor]]:
    """Compute RMSE over a sliding window.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image import root_mean_squared_error_using_sliding_window
        >>> g = torch.Generator().manual_seed(22)
        >>> preds, target = torch.rand(4, 3, 16, 16, generator=g), torch.rand(4, 3, 16, 16, generator=g)
        >>> float(root_mean_squared_error_using_sliding_window(preds, target)) > 0
        True
    """
    if not isinstance(window_size, int) or window_size < 1:
        raise ValueError("Argument `window_size` is expected to be a positive integer.")
    rmse_val_sum, rmse_map, total_images = _rmse_sw_update(
        preds, target, window_size, rmse_val_sum=None, rmse_map=None, total_images=None
    )
    rmse, rmse_map = _rmse_sw_compute(rmse_val_sum, rmse_map, total_images)
    if return_rmse_map:
        return rmse, rmse_map
    return rmse
