"""Pixel-based visual information fidelity (VIF-p).

Counterpart of ``torchmetrics_tpu/functional/image/vif.py``: the four-scale pyramid of
2-D Gaussian windows, each scale after the first filtered and decimated by
``[:, :, ::2, ::2]``, every mask of the reference a ``torch.where``. The channels are
folded into the batch; the convolutions go through ``utils._conv2d`` (on the card a
depthwise convolution: no cuDNN, no TF32).
"""

from __future__ import annotations

import torch

from torchmetrics_tpu_torch.functional.image.utils import _as_jax_dtype, _conv2d

Tensor = torch.Tensor


def _vif_filter(win_size: int, sigma: float, dtype: torch.dtype, device) -> Tensor:
    """2D gaussian window of size ``win_size``, normalised over both axes at once."""
    coords = torch.arange(win_size, dtype=dtype, device=device) - (win_size - 1) / 2
    g = torch.square(coords)
    g = torch.exp(-(g[None, :] + g[:, None]) / (2.0 * sigma**2))
    return g / torch.sum(g)


def _vif_per_channel(preds: Tensor, target: Tensor, sigma_n_sq: float) -> Tensor:
    """VIF of each plane of ``[N, H, W]`` single-channel images: ``[N]``."""
    dtype = preds.dtype
    preds = preds[:, None]  # (N, 1, H, W)
    target = target[:, None]
    eps = torch.tensor(1e-10, dtype=dtype, device=preds.device)
    sigma_n_sq = torch.tensor(sigma_n_sq, dtype=dtype, device=preds.device)

    preds_vif = torch.zeros((1,), dtype=dtype, device=preds.device)
    target_vif = torch.zeros((1,), dtype=dtype, device=preds.device)
    for scale in range(4):
        n = int(2.0 ** (4 - scale) + 1)
        kernel = _vif_filter(n, n / 5, dtype, preds.device)[None, None, :]

        if scale > 0:
            target = _conv2d(target, kernel)[:, :, ::2, ::2]
            preds = _conv2d(preds, kernel)[:, :, ::2, ::2]

        planes = preds.shape[0]
        moments = _conv2d(torch.cat((target, preds, target**2, preds**2, target * preds)), kernel)
        mu_target, mu_preds, target_sq, preds_sq, target_preds = (
            moments[i * planes : (i + 1) * planes] for i in range(5)
        )
        mu_target_sq = mu_target**2
        mu_preds_sq = mu_preds**2
        mu_target_preds = mu_target * mu_preds

        sigma_target_sq = torch.clamp(target_sq - mu_target_sq, min=0.0)
        sigma_preds_sq = torch.clamp(preds_sq - mu_preds_sq, min=0.0)
        sigma_target_preds = target_preds - mu_target_preds

        g = sigma_target_preds / (sigma_target_sq + eps)
        sigma_v_sq = sigma_preds_sq - g * sigma_target_preds

        mask = sigma_target_sq < eps
        g = torch.where(mask, 0.0, g)
        sigma_v_sq = torch.where(mask, sigma_preds_sq, sigma_v_sq)
        sigma_target_sq = torch.where(mask, 0.0, sigma_target_sq)

        mask = sigma_preds_sq < eps
        g = torch.where(mask, 0.0, g)
        sigma_v_sq = torch.where(mask, 0.0, sigma_v_sq)

        mask = g < 0
        sigma_v_sq = torch.where(mask, sigma_preds_sq, sigma_v_sq)
        g = torch.where(mask, 0.0, g)
        sigma_v_sq = torch.clamp(sigma_v_sq, min=eps)

        preds_vif_scale = torch.log10(1.0 + (g**2.0) * sigma_target_sq / (sigma_v_sq + sigma_n_sq))
        preds_vif = preds_vif + torch.sum(preds_vif_scale, dim=(1, 2, 3))
        target_vif = target_vif + torch.sum(torch.log10(1.0 + sigma_target_sq / sigma_n_sq), dim=(1, 2, 3))
    return preds_vif / target_vif


def _vif_per_image_channel(preds: Tensor, target: Tensor, sigma_n_sq: float) -> Tensor:
    """VIF of every (image, channel) of ``[B, C, H, W]`` inputs: ``[B, C]``."""
    b, c = preds.shape[:2]
    return _vif_per_channel(preds.reshape(b * c, *preds.shape[2:]), target.reshape(b * c, *target.shape[2:]),
                            sigma_n_sq).reshape(b, c)


def visual_information_fidelity(preds: Tensor, target: Tensor, sigma_n_sq: float = 2.0) -> Tensor:
    """Compute pixel-based visual information fidelity.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image import visual_information_fidelity
        >>> g = torch.Generator().manual_seed(42)
        >>> preds, target = torch.rand(2, 1, 41, 41, generator=g), torch.rand(2, 1, 41, 41, generator=g)
        >>> float(visual_information_fidelity(preds, target)) > 0
        True
    """
    preds = _as_jax_dtype(preds)
    target = _as_jax_dtype(target).to(device=preds.device, dtype=preds.dtype)
    if preds.shape[-1] < 41 or preds.shape[-2] < 41:
        raise ValueError(
            f"Invalid size of preds. Expected at least 41x41, but got {preds.shape[-1]}x{preds.shape[-2]}!"
        )
    if target.shape[-1] < 41 or target.shape[-2] < 41:
        raise ValueError(
            f"Invalid size of target. Expected at least 41x41, but got {target.shape[-1]}x{target.shape[-2]}!"
        )
    return torch.mean(_vif_per_image_channel(preds, target, sigma_n_sq))
