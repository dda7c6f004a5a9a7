"""PSNR with blocked effect (PSNR-B).

Counterpart of ``torchmetrics_tpu/functional/image/psnrb.py``: grayscale images, in
float32. The block-boundary index sets depend only on the image's shape.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from torchmetrics_tpu_torch.functional.image.utils import _as_jax_dtype

Tensor = torch.Tensor


def _compute_bef(x: Tensor, block_size: int = 8) -> Tensor:
    """Blocking-effect factor: squared differences across vs within block boundaries."""
    _, channels, height, width = x.shape
    if channels > 1:
        raise ValueError(f"`psnrb` metric expects grayscale images, but got images with {channels} channels.")

    h = list(range(width - 1))
    h_b = list(range(block_size - 1, width - 1, block_size))
    h_bc = sorted(set(h).symmetric_difference(h_b))

    v = list(range(height - 1))
    v_b = list(range(block_size - 1, height - 1, block_size))
    v_bc = sorted(set(v).symmetric_difference(v_b))

    h_b, h_bc, v_b, v_bc = (torch.tensor(i, dtype=torch.int64, device=x.device) for i in (h_b, h_bc, v_b, v_bc))

    d_b = torch.square(x[:, :, :, h_b] - x[:, :, :, h_b + 1]).sum()
    d_bc = torch.square(x[:, :, :, h_bc] - x[:, :, :, h_bc + 1]).sum()
    d_b = d_b + torch.square(x[:, :, v_b, :] - x[:, :, v_b + 1, :]).sum()
    d_bc = d_bc + torch.square(x[:, :, v_bc, :] - x[:, :, v_bc + 1, :]).sum()

    n_hb = height * (width / block_size) - 1
    n_hbc = (height * (width - 1)) - n_hb
    n_vb = width * (height / block_size) - 1
    n_vbc = (width * (height - 1)) - n_vb
    d_b = d_b / (n_hb + n_vb)
    d_bc = d_bc / (n_hbc + n_vbc)
    t = math.log2(block_size) / math.log2(min(height, width))
    return torch.where(d_b > d_bc, t * (d_b - d_bc), 0.0)


def _psnrb_compute(
    sum_squared_error: Tensor,
    bef: Tensor,
    num_obs: Tensor,
    data_range: Tensor,
) -> Tensor:
    """PSNR-B from accumulated squared error and blocking-effect factor."""
    sum_squared_error = sum_squared_error / num_obs + bef
    return torch.where(
        data_range > 2,
        10 * torch.log10(data_range**2 / sum_squared_error),
        10 * torch.log10(1.0 / sum_squared_error),
    )


def _psnrb_update(preds: Tensor, target: Tensor, block_size: int = 8) -> Tuple[Tensor, Tensor, Tensor]:
    """Squared error, blocking effect, and observation count for the batch."""
    diff = preds - target
    sum_squared_error = torch.sum(diff * diff)
    num_obs = torch.tensor(target.numel(), dtype=torch.int32, device=target.device)
    bef = _compute_bef(preds, block_size=block_size)
    return sum_squared_error, bef, num_obs


def peak_signal_noise_ratio_with_blocked_effect(
    preds: Tensor,
    target: Tensor,
    block_size: int = 8,
) -> Tensor:
    """Compute PSNR with blocked effect for grayscale images.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image import peak_signal_noise_ratio_with_blocked_effect
        >>> g = torch.Generator().manual_seed(42)
        >>> preds, target = torch.rand(1, 1, 28, 28, generator=g), torch.rand(1, 1, 28, 28, generator=g)
        >>> float(peak_signal_noise_ratio_with_blocked_effect(preds, target)) > 0
        True
    """
    preds = _as_jax_dtype(preds).to(torch.float32)
    target = _as_jax_dtype(target).to(device=preds.device, dtype=torch.float32)
    data_range = target.max() - target.min()
    sum_squared_error, bef, num_obs = _psnrb_update(preds, target, block_size=block_size)
    return _psnrb_compute(sum_squared_error, bef, num_obs, data_range)
