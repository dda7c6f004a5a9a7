"""Signal-to-noise ratio family: SNR, SI-SNR and C-SI-SNR.

Counterpart of ``torchmetrics_tpu/functional/audio/snr.py``. C-SI-SNR takes complex
STFT tensors (through ``torch.view_as_real``) or real ``(..., F, T, 2)`` tensors.
"""

from __future__ import annotations

import torch

from torchmetrics_tpu_torch.functional.audio.sdr import scale_invariant_signal_distortion_ratio
from torchmetrics_tpu_torch.functional.image.utils import _as_jax_dtype
from torchmetrics_tpu_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor


def signal_noise_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    r"""Calculate the signal-to-noise ratio in dB per sample.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.audio import signal_noise_ratio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> signal_noise_ratio(preds, target).round(decimals=4)
        tensor(16.1805)
    """
    preds = _as_jax_dtype(preds)
    target = _as_jax_dtype(target).to(preds.device)
    _check_same_shape(preds, target)
    eps = torch.finfo(preds.dtype).eps

    if zero_mean:
        target = target - torch.mean(target, dim=-1, keepdim=True)
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)

    noise = target - preds
    snr_value = (torch.sum(torch.square(target), dim=-1) + eps) / (torch.sum(torch.square(noise), dim=-1) + eps)
    return 10 * torch.log10(snr_value)


def scale_invariant_signal_noise_ratio(preds: Tensor, target: Tensor) -> Tensor:
    """Calculate the scale-invariant signal-to-noise ratio in dB per sample.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.audio import scale_invariant_signal_noise_ratio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> scale_invariant_signal_noise_ratio(preds, target).round(decimals=4)
        tensor(15.0918)
    """
    return scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=True)


def _real_pair(x) -> Tensor:
    """A complex tensor as its ``(..., 2)`` real view; a real one as it is."""
    x = torch.as_tensor(x)
    if x.is_complex():
        return torch.view_as_real(x.to(torch.complex64) if x.dtype == torch.complex128 else x)
    return _as_jax_dtype(x)


def complex_scale_invariant_signal_noise_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """Calculate the complex scale-invariant signal-to-noise ratio.

    Accepts complex STFT tensors of shape ``(..., frequency, time)`` or real tensors of
    shape ``(..., frequency, time, 2)``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.audio import complex_scale_invariant_signal_noise_ratio
        >>> g = torch.Generator().manual_seed(42)
        >>> preds, target = torch.randn(1, 257, 100, 2, generator=g), torch.randn(1, 257, 100, 2, generator=g)
        >>> float(complex_scale_invariant_signal_noise_ratio(preds, target)[0]) < 0
        True
    """
    preds = _real_pair(preds)
    target = _real_pair(target).to(preds.device)

    if (preds.ndim < 3 or preds.shape[-1] != 2) or (target.ndim < 3 or target.shape[-1] != 2):
        raise RuntimeError(
            "Predictions and targets are expected to have the shape (..., frequency, time, 2),"
            f" but got {tuple(preds.shape)} and {tuple(target.shape)}."
        )

    preds = preds.reshape(*preds.shape[:-3], -1)
    target = target.reshape(*target.shape[:-3], -1)
    return scale_invariant_signal_distortion_ratio(preds=preds, target=target, zero_mean=zero_mean)
