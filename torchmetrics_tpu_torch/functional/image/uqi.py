"""Universal image quality index.

Counterpart of ``torchmetrics_tpu/functional/image/uqi.py``: the five window moments
as one grouped convolution over the stacked (p, t, p^2, t^2, pt) planes, in full
float32, as the JAX package computes them.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from torchmetrics_tpu_torch.functional.image.utils import (
    _as_jax_dtype,
    _conv2d,
    _dtype_name,
    _gaussian_kernel_2d,
    _reflect_pad_2d,
    reduce,
)
from torchmetrics_tpu_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor


def _uqi_update(preds, target) -> Tuple[Tensor, Tensor]:
    """Validate BxCxHxW inputs."""
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
    return preds, target


def _uqi_compute(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """UQI over gaussian local windows."""
    if len(kernel_size) != 2 or len(sigma) != 2:
        raise ValueError(
            "Expected `kernel_size` and `sigma` to have the length of two."
            f" Got kernel_size: {len(kernel_size)} and sigma: {len(sigma)}."
        )
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")

    channel = preds.shape[1]
    dtype = preds.dtype
    kernel = _gaussian_kernel_2d(channel, kernel_size, sigma, dtype, preds.device)
    pad_h = (kernel_size[0] - 1) // 2
    pad_w = (kernel_size[1] - 1) // 2

    # the JAX package pads (pad_w, pad_h): the w-pads land on the H axis when they differ; kept
    preds = _reflect_pad_2d(preds, pad_w, pad_h)
    target = _reflect_pad_2d(target, pad_w, pad_h)

    input_list = torch.cat((preds, target, preds * preds, target * target, preds * target), dim=0)
    outputs = _conv2d(input_list, kernel, groups=channel)
    b = preds.shape[0]
    mu_pred, mu_target, e_pp, e_tt, e_pt = (outputs[i * b : (i + 1) * b] for i in range(5))

    mu_pred_sq = torch.square(mu_pred)
    mu_target_sq = torch.square(mu_target)
    mu_pred_target = mu_pred * mu_target

    sigma_pred_sq = torch.clamp(e_pp - mu_pred_sq, min=0.0)
    sigma_target_sq = torch.clamp(e_tt - mu_target_sq, min=0.0)
    sigma_pred_target = e_pt - mu_pred_target

    upper = 2 * sigma_pred_target
    lower = sigma_pred_sq + sigma_target_sq
    eps = torch.finfo(sigma_pred_sq.dtype).eps
    uqi_idx = ((2 * mu_pred_target) * upper) / ((mu_pred_sq + mu_target_sq) * lower + eps)
    uqi_idx = uqi_idx[..., pad_h:-pad_h, pad_w:-pad_w]
    return reduce(uqi_idx, reduction)


def universal_image_quality_index(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """Universal image quality index.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image import universal_image_quality_index
        >>> preds = torch.rand(16, 1, 16, 16, generator=torch.Generator().manual_seed(0))
        >>> target = preds * 0.75
        >>> float(universal_image_quality_index(preds, target)) > 0.9
        True
    """
    preds, target = _uqi_update(preds, target)
    return _uqi_compute(preds, target, kernel_size, sigma, reduction)
