"""Spectral distortion index (D_lambda).

Counterpart of ``torchmetrics_tpu/functional/image/d_lambda.py``. The pairwise band
UQI matrix comes from one UQI call over every band pair stacked along the batch,
where the JAX package loops over the pairs; each entry is still the mean of its
pair's UQI map.
"""

from __future__ import annotations

from typing import Tuple

import torch

from torchmetrics_tpu_torch.functional.image.uqi import _uqi_compute
from torchmetrics_tpu_torch.functional.image.utils import _as_jax_dtype, _dtype_name, reduce

Tensor = torch.Tensor


def _spectral_distortion_index_update(preds, target) -> Tuple[Tensor, Tensor]:
    """Validate matching BxCxHxW multispectral stacks."""
    preds = _as_jax_dtype(preds)
    target = _as_jax_dtype(target).to(preds.device)
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `ms` and `fused` to have the same data type."
            f" Got ms: {_dtype_name(preds.dtype)} and fused: {_dtype_name(target.dtype)}."
        )
    if preds.ndim != 4:
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW shape."
            f" Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    if preds.shape[:2] != target.shape[:2]:
        raise ValueError(
            "Expected `preds` and `target` to have same batch and channel sizes."
            f"Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    return preds, target


def _pairwise_band_uqi(x: Tensor) -> Tensor:
    """Symmetric matrix of the mean cross-band UQI of every band pair (zero diagonal)."""
    b, length, h, w = x.shape
    m = torch.zeros((length, length), dtype=x.dtype, device=x.device)
    pairs = torch.triu_indices(length, length, offset=1, device=x.device)
    if pairs.shape[1] == 0:
        return m
    first = x[:, pairs[0]].transpose(0, 1).reshape(-1, 1, h, w)
    second = x[:, pairs[1]].transpose(0, 1).reshape(-1, 1, h, w)
    scores = _uqi_compute(first, second, reduction="none").reshape(pairs.shape[1], -1).mean(dim=1)
    m = m.index_put((pairs[0], pairs[1]), scores)
    return m + m.T


def _spectral_distortion_index_compute(
    preds: Tensor,
    target: Tensor,
    p: int = 1,
    reduction: str = "elementwise_mean",
) -> Tensor:
    """D_lambda from the difference of the cross-band UQI matrices."""
    length = preds.shape[1]
    m1 = _pairwise_band_uqi(target)
    m2 = _pairwise_band_uqi(preds)

    diff = torch.pow(torch.abs(m1 - m2), p)
    if length == 1:
        output = torch.pow(diff, 1.0 / p)
    else:
        output = torch.pow(1.0 / (length * (length - 1)) * torch.sum(diff), 1.0 / p)
    return reduce(output, reduction)


def spectral_distortion_index(
    preds: Tensor,
    target: Tensor,
    p: int = 1,
    reduction: str = "elementwise_mean",
) -> Tensor:
    """Compute the spectral distortion index (D_lambda) for pan-sharpening quality.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image import spectral_distortion_index
        >>> g = torch.Generator().manual_seed(42)
        >>> preds, target = torch.rand(16, 3, 16, 16, generator=g), torch.rand(16, 3, 16, 16, generator=g)
        >>> float(spectral_distortion_index(preds, target)) < 0.2
        True
    """
    preds, target = _spectral_distortion_index_update(preds, target)
    if not isinstance(p, int) or p <= 0:
        raise ValueError(f"Expected `p` to be a positive integer. Got p: {p}.")
    return _spectral_distortion_index_compute(preds, target, p, reduction)
