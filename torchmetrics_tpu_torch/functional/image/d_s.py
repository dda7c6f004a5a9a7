"""Spatial distortion index (D_s).

Counterpart of ``torchmetrics_tpu/functional/image/d_s.py``. The panchromatic image is
degraded by a uniform filter and resized to the multispectral image's size as
``jax.image.resize(..., method="bilinear")`` does (``utils._resize_bilinear``).
The per-band UQIs come from one UQI call with the bands folded into the batch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.image.uqi import _uqi_compute
from torchmetrics_tpu_torch.functional.image.utils import (
    _as_jax_dtype,
    _dtype_name,
    _resize_bilinear,
    _uniform_filter,
    reduce,
)

Tensor = torch.Tensor


def _spatial_distortion_index_update(
    preds, ms, pan, pan_lr=None
) -> Tuple[Tensor, Tensor, Tensor, Optional[Tensor]]:
    """Validate the pan-sharpening quadruple (fused, low-res ms, pan, optional low-res pan)."""
    preds = _as_jax_dtype(preds)
    ms = _as_jax_dtype(ms).to(preds.device)
    pan = _as_jax_dtype(pan).to(preds.device)
    pan_lr = _as_jax_dtype(pan_lr).to(preds.device) if pan_lr is not None else None

    if preds.ndim != 4:
        raise ValueError(f"Expected `preds` to have BxCxHxW shape. Got preds: {tuple(preds.shape)}.")
    for name, other in (("ms", ms), ("pan", pan)) + ((("pan_lr", pan_lr),) if pan_lr is not None else ()):
        if preds.dtype != other.dtype:
            raise TypeError(
                f"Expected `preds` and `{name}` to have the same data type."
                f" Got preds: {_dtype_name(preds.dtype)} and {name}: {_dtype_name(other.dtype)}."
            )
        if other.ndim != 4:
            raise ValueError(f"Expected `{name}` to have BxCxHxW shape. Got {name}: {tuple(other.shape)}.")
        if preds.shape[:2] != other.shape[:2]:
            raise ValueError(
                f"Expected `preds` and `{name}` to have the same batch and channel sizes."
                f" Got preds: {tuple(preds.shape)} and {name}: {tuple(other.shape)}."
            )

    preds_h, preds_w = preds.shape[-2:]
    ms_h, ms_w = ms.shape[-2:]
    pan_h, pan_w = pan.shape[-2:]
    if preds_h != pan_h:
        raise ValueError(f"Expected `preds` and `pan` to have the same height. Got preds: {preds_h} and pan: {pan_h}")
    if preds_w != pan_w:
        raise ValueError(f"Expected `preds` and `pan` to have the same width. Got preds: {preds_w} and pan: {pan_w}")
    if preds_h % ms_h != 0 or preds_w % ms_w != 0:
        raise ValueError(
            f"Expected height/width of `preds` to be multiple of height/width of `ms`."
            f" Got preds: {tuple(preds.shape[-2:])} and ms: {tuple(ms.shape[-2:])}."
        )
    if pan_lr is not None and tuple(pan_lr.shape[-2:]) != (ms_h, ms_w):
        raise ValueError(
            f"Expected `ms` and `pan_lr` to have the same height and width."
            f" Got ms: {(ms_h, ms_w)} and pan_lr: {tuple(pan_lr.shape[-2:])}."
        )
    return preds, ms, pan, pan_lr


def _band_uqi(x: Tensor, y: Tensor) -> Tensor:
    """The mean UQI of each band of ``x`` against the same band of ``y``: ``[C]``."""
    b, c, h, w = x.shape
    planes = _uqi_compute(x.transpose(0, 1).reshape(c * b, 1, h, w), y.transpose(0, 1).reshape(c * b, 1, h, w),
                          reduction="none")
    return planes.reshape(c, -1).mean(dim=1)


def _spatial_distortion_index_compute(
    preds: Tensor,
    ms: Tensor,
    pan: Tensor,
    pan_lr: Optional[Tensor] = None,
    norm_order: int = 1,
    window_size: int = 7,
    reduction: str = "elementwise_mean",
) -> Tensor:
    """D_s from per-band UQI against the (degraded) panchromatic image."""
    ms_h, ms_w = ms.shape[-2:]
    if window_size >= ms_h or window_size >= ms_w:
        raise ValueError(
            f"Expected `window_size` to be smaller than dimension of `ms`. Got window_size: {window_size}."
        )

    if pan_lr is None:
        pan_degraded = _resize_bilinear(_uniform_filter(pan, window_size=window_size), ms_h, ms_w)
    else:
        pan_degraded = pan_lr

    m1 = _band_uqi(ms, pan_degraded)
    m2 = _band_uqi(preds, pan)
    diff = torch.abs(m1 - m2) ** norm_order
    return reduce(diff, reduction) ** (1 / norm_order)


def spatial_distortion_index(
    preds: Tensor,
    ms: Tensor,
    pan: Tensor,
    pan_lr: Optional[Tensor] = None,
    norm_order: int = 1,
    window_size: int = 7,
    reduction: str = "elementwise_mean",
) -> Tensor:
    """Compute the spatial distortion index (D_s) for pan-sharpening quality.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image import spatial_distortion_index
        >>> g = torch.Generator().manual_seed(42)
        >>> preds = torch.rand(16, 3, 32, 32, generator=g)
        >>> ms, pan = torch.rand(16, 3, 16, 16, generator=g), torch.rand(16, 3, 32, 32, generator=g)
        >>> float(spatial_distortion_index(preds, ms, pan)) < 0.2
        True
    """
    if not isinstance(norm_order, int) or norm_order <= 0:
        raise ValueError(f"Expected `norm_order` to be a positive integer. Got norm_order: {norm_order}.")
    if not isinstance(window_size, int) or window_size <= 0:
        raise ValueError(f"Expected `window_size` to be a positive integer. Got window_size: {window_size}.")
    preds, ms, pan, pan_lr = _spatial_distortion_index_update(preds, ms, pan, pan_lr)
    return _spatial_distortion_index_compute(preds, ms, pan, pan_lr, norm_order, window_size, reduction)
