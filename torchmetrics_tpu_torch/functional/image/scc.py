"""Spatial correlation coefficient.

Counterpart of ``torchmetrics_tpu/functional/image/scc.py``. The channels are folded
into the batch, so every channel's maps come from one call of each step: the Laplacian
high-pass as a true (flipped) convolution after a symmetric pad (``utils._pad``), and
the five local moments as one mean-window convolution over the stacked planes. Both go
through ``utils._conv2d``: on the card a depthwise convolution, no cuDNN, no TF32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from torchmetrics_tpu_torch.functional.image.utils import _as_jax_dtype, _conv2d, _pad
from torchmetrics_tpu_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor

_LAPLACIAN = ((-1.0, -1.0, -1.0), (-1.0, 8.0, -1.0), (-1.0, -1.0, -1.0))


def _scc_update(preds, target, hp_filter, window_size: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Validate inputs, promote grayscale to NCHW, and shape the high-pass filter."""
    preds = _as_jax_dtype(preds)
    target = _as_jax_dtype(target).to(device=preds.device, dtype=preds.dtype)
    _check_same_shape(preds, target)
    if preds.ndim not in (3, 4):
        raise ValueError(
            "Expected `preds` and `target` to have batch of colored images with BxCxHxW shape"
            "  or batch of grayscale images of BxHxW shape."
            f" Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    if preds.ndim == 3:
        preds = preds[:, None]
        target = target[:, None]
    if not window_size > 0:
        raise ValueError(f"Expected `window_size` to be a positive integer. Got {window_size}.")
    if window_size > preds.shape[2] or window_size > preds.shape[3]:
        raise ValueError(
            f"Expected `window_size` to be less than or equal to the size of the image."
            f" Got window_size: {window_size} and image size: {preds.shape[2]}x{preds.shape[3]}."
        )
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)
    hp_filter = torch.as_tensor(hp_filter, dtype=preds.dtype, device=preds.device)[None, None, :]
    return preds, target, hp_filter


def _signal_convolve_2d(x: Tensor, kernel: Tensor) -> Tensor:
    """True signal convolution (flipped kernel) with symmetric padding."""
    left = int(math.floor((kernel.shape[3] - 1) / 2))
    right = int(math.ceil((kernel.shape[3] - 1) / 2))
    top = int(math.floor((kernel.shape[2] - 1) / 2))
    bottom = int(math.ceil((kernel.shape[2] - 1) / 2))
    padded = _pad(x, ((top, bottom), (left, right)), "symmetric")
    return _conv2d(padded, torch.flip(kernel, dims=(2, 3)))


def _hp_2d_laplacian(x: Tensor, kernel: Tensor) -> Tensor:
    """Laplace high-pass filtering (doubled, as in the reference)."""
    return _signal_convolve_2d(x, kernel) * 2.0


def _local_variance_covariance(preds: Tensor, target: Tensor, window: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Local first and second moments by a mean window over zero-padded planes."""
    left = int(math.ceil((window.shape[3] - 1) / 2))
    right = int(math.floor((window.shape[3] - 1) / 2))
    pads = (left, right, left, right)
    preds = F.pad(preds, pads)
    target = F.pad(target, pads)
    planes = preds.shape[0]
    moments = _conv2d(torch.cat((preds, target, preds**2, target**2, target * preds)), window)
    preds_mean, target_mean, preds_sq, target_sq, target_preds = (
        moments[i * planes : (i + 1) * planes] for i in range(5)
    )
    preds_var = preds_sq - preds_mean**2
    target_var = target_sq - target_mean**2
    target_preds_cov = target_preds - target_mean * preds_mean
    return preds_var, target_var, target_preds_cov


def _scc_per_channel_compute(preds: Tensor, target: Tensor, hp_filter: Tensor, window_size: int) -> Tensor:
    """SCC map of single-channel planes ``[N, 1, H, W]``."""
    window = torch.full(
        (1, 1, window_size, window_size), 1.0 / window_size**2, dtype=preds.dtype, device=preds.device
    )

    preds_hp = _hp_2d_laplacian(preds, hp_filter)
    target_hp = _hp_2d_laplacian(target, hp_filter)

    preds_var, target_var, target_preds_cov = _local_variance_covariance(preds_hp, target_hp, window)
    preds_var = torch.clamp(preds_var, min=0)
    target_var = torch.clamp(target_var, min=0)

    den = torch.sqrt(target_var) * torch.sqrt(preds_var)
    zero_den = den == 0
    return torch.where(zero_den, 0.0, target_preds_cov / torch.where(zero_den, 1.0, den))


def _scc_map(preds: Tensor, target: Tensor, hp_filter: Tensor, window_size: int) -> Tensor:
    """The SCC map ``[B, C, H', W']`` of every channel, the channels folded into the batch."""
    b, c, h, w = preds.shape
    out = _scc_per_channel_compute(
        preds.reshape(b * c, 1, h, w), target.reshape(b * c, 1, h, w), hp_filter, window_size
    )
    return out.reshape(b, c, *out.shape[2:])


def spatial_correlation_coefficient(
    preds: Tensor,
    target: Tensor,
    hp_filter: Optional[Tensor] = None,
    window_size: int = 8,
    reduction: Optional[str] = "mean",
) -> Tensor:
    """Compute the spatial correlation coefficient.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image import spatial_correlation_coefficient
        >>> x = torch.rand(2, 3, 16, 16, generator=torch.Generator().manual_seed(42))
        >>> round(float(spatial_correlation_coefficient(x, x)), 3)
        1.0
    """
    if hp_filter is None:
        hp_filter = _LAPLACIAN
    if reduction not in ("mean", "none", None):
        raise ValueError(f"Expected reduction to be 'mean', 'none' or None, but got {reduction}")

    preds, target, hp_filter = _scc_update(preds, target, hp_filter, window_size)
    scc_map = _scc_map(preds, target, hp_filter, window_size)
    if reduction is None or reduction == "none":
        return scc_map.mean(dim=(1, 2, 3))
    return scc_map.mean()
