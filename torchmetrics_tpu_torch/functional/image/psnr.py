"""Peak signal-to-noise ratio.

Counterpart of ``torchmetrics_tpu/functional/image/psnr.py``. The inputs are promoted
to float32 and the observation count is int32, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.image.utils import _as_jax_dtype, reduce
from torchmetrics_tpu_torch.utils.checks import _check_same_shape
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


def _psnr_compute(
    sum_squared_error: Tensor,
    num_obs: Tensor,
    data_range: Tensor,
    base: float = 10.0,
    reduction: Optional[str] = "elementwise_mean",
) -> Tensor:
    """PSNR from accumulated squared error / observation count."""
    psnr_base_e = 2 * torch.log(data_range) - torch.log(sum_squared_error / num_obs)
    psnr_vals = psnr_base_e * (10 / torch.log(torch.tensor(base, dtype=torch.float32, device=psnr_base_e.device)))
    return reduce(psnr_vals, reduction)


def _psnr_update(
    preds: Tensor,
    target: Tensor,
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> Tuple[Tensor, Tensor]:
    """Sum of squared error and observation count, optionally over a dim subset."""
    diff = preds - target
    if dim is None:
        sum_squared_error = torch.sum(diff * diff)
        num_obs = torch.tensor(target.numel(), dtype=torch.int32, device=target.device)
        return sum_squared_error, num_obs

    dim_list = [dim] if isinstance(dim, int) else list(dim)
    # an empty dim tuple reduces nothing, as in jnp.sum(axis=())
    sum_squared_error = torch.sum(diff * diff, dim=dim_list) if dim_list else diff * diff
    if not dim_list:
        num_obs = torch.tensor(target.numel(), dtype=torch.int32, device=target.device)
    else:
        count = 1
        for d in dim_list:
            count *= target.shape[d]
        num_obs = torch.full(sum_squared_error.shape, count, dtype=torch.int32, device=target.device)
    return sum_squared_error, num_obs


def _as_float32(x) -> Tensor:
    """The JAX package's ``promote_types(dtype, float32)`` without x64: float32 always."""
    return _as_jax_dtype(x).to(torch.float32)


def peak_signal_noise_ratio(
    preds: Tensor,
    target: Tensor,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    base: float = 10.0,
    reduction: Optional[str] = "elementwise_mean",
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> Tensor:
    """Compute the peak signal-to-noise ratio.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image import peak_signal_noise_ratio
        >>> preds = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
        >>> target = torch.tensor([[3.0, 2.0], [1.0, 0.0]])
        >>> peak_signal_noise_ratio(preds, target).round(decimals=4)
        tensor(2.5527)
    """
    if dim is None and reduction != "elementwise_mean":
        rank_zero_warn(f"The `reduction={reduction}` will not have any effect when `dim` is None.")

    preds = _as_float32(preds)
    target = _as_float32(target).to(preds.device)
    _check_same_shape(preds, target)

    if data_range is None:
        if dim is not None:
            raise ValueError("The `data_range` must be given when `dim` is not None.")
        data_range_t = target.max() - target.min()
    elif isinstance(data_range, tuple):
        preds = torch.clamp(preds, data_range[0], data_range[1])
        target = torch.clamp(target, data_range[0], data_range[1])
        data_range_t = torch.tensor(float(data_range[1] - data_range[0]), device=preds.device)
    else:
        data_range_t = torch.tensor(float(data_range), device=preds.device)
    sum_squared_error, num_obs = _psnr_update(preds, target, dim=dim)
    return _psnr_compute(sum_squared_error, num_obs, data_range_t, base=base, reduction=reduction)
