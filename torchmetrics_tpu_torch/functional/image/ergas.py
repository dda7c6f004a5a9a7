"""ERGAS — relative dimensionless global error in synthesis.

Counterpart of ``torchmetrics_tpu/functional/image/ergas.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.image.utils import _as_jax_dtype, _dtype_name, reduce
from torchmetrics_tpu_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor


def _ergas_update(preds, target) -> Tuple[Tensor, Tensor]:
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


def _ergas_compute(
    preds: Tensor,
    target: Tensor,
    ratio: float = 4,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """ERGAS from per-band RMSE relative to per-band target means."""
    b, c, h, w = preds.shape
    preds = preds.reshape(b, c, h * w)
    target = target.reshape(b, c, h * w)

    diff = preds - target
    sum_squared_error = torch.sum(diff * diff, dim=2)
    rmse_per_band = torch.sqrt(sum_squared_error / (h * w))
    mean_target = torch.mean(target, dim=2)

    ergas_score = 100 / ratio * torch.sqrt(torch.sum(torch.square(rmse_per_band / mean_target), dim=1) / c)
    return reduce(ergas_score, reduction)


def error_relative_global_dimensionless_synthesis(
    preds: Tensor,
    target: Tensor,
    ratio: float = 4,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """Compute the ERGAS pan-sharpening quality metric.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image import error_relative_global_dimensionless_synthesis
        >>> preds = torch.rand(16, 1, 16, 16, generator=torch.Generator().manual_seed(42))
        >>> target = preds * 0.75
        >>> float(error_relative_global_dimensionless_synthesis(preds, target)) > 9
        True
    """
    preds, target = _ergas_update(preds, target)
    return _ergas_compute(preds, target, ratio, reduction)
