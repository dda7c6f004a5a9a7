"""Structural similarity (SSIM) and multi-scale SSIM.

Counterpart of ``torchmetrics_tpu/functional/image/ssim.py``. The 2D window moments
(E[p], E[t], E[p^2], E[t^2], E[pt]) go through the hand-written SSIM moments kernel
(``ops.kernels.ssim_moments``) for tensors on the card and through its plain version
for tensors on the CPU, at every plane size: the 2D window is always the outer
product of two 1D factors. The kernel is differentiable, so SSIM serves as a loss.
3D SSIM stays a grouped convolution, as the JAX package computes it. Inputs that are
not floating point are taken as float32; the moments come back in the input's float
dtype, as in the JAX package's kernel branch.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple, Union

import torch

from torchmetrics_tpu_torch.functional.image.utils import (
    _as_jax_dtype,
    _avg_pool2d,
    _avg_pool3d,
    _conv3d,
    _gaussian,
    _gaussian_kernel_3d,
    _reflect_pad_2d,
    _reflect_pad_3d,
    reduce,
)
from torchmetrics_tpu_torch.ops import kernels
from torchmetrics_tpu_torch.utils.checks import _check_same_shape

Tensor = torch.Tensor


def _ssim_check_inputs(preds, target) -> Tuple[Tensor, Tensor]:
    """Validate shapes: BxCxHxW (2d) or BxCxDxHxW (3d) volumes."""
    preds = _as_jax_dtype(preds)
    if not preds.is_floating_point():
        preds = preds.to(torch.float32)
    target = _as_jax_dtype(target).to(device=preds.device, dtype=preds.dtype)
    _check_same_shape(preds, target)
    if preds.ndim not in (4, 5):
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW or BxCxDxHxW shape."
            f" Got preds: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    return preds, target


def _ssim_update(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Per-image SSIM (optionally with the full map or the contrast term)."""
    is_3d = preds.ndim == 5

    if not isinstance(kernel_size, Sequence):
        kernel_size = 3 * [kernel_size] if is_3d else 2 * [kernel_size]
    if not isinstance(sigma, Sequence):
        sigma = 3 * [sigma] if is_3d else 2 * [sigma]

    if len(kernel_size) != preds.ndim - 2:
        raise ValueError(
            f"`kernel_size` has dimension {len(kernel_size)}, but expected to be two less"
            f" that target dimensionality, which is: {preds.ndim}"
        )
    if len(sigma) != preds.ndim - 2:
        raise ValueError(
            f"`sigma` has dimension {len(sigma)}, but expected to be two less that target"
            f" dimensionality, which is: {preds.ndim}"
        )
    if return_full_image and return_contrast_sensitivity:
        raise ValueError("Arguments `return_full_image` and `return_contrast_sensitivity` are mutually exclusive.")
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")

    if data_range is None:
        data_range_v = torch.maximum(preds.max() - preds.min(), target.max() - target.min())
    elif isinstance(data_range, tuple):
        preds = torch.clamp(preds, data_range[0], data_range[1])
        target = torch.clamp(target, data_range[0], data_range[1])
        data_range_v = torch.as_tensor(data_range[1] - data_range[0], dtype=preds.dtype, device=preds.device)
    else:
        data_range_v = torch.as_tensor(data_range, dtype=preds.dtype, device=preds.device)

    c1 = torch.square(k1 * data_range_v)
    c2 = torch.square(k2 * data_range_v)

    channel = preds.shape[1]
    dtype = preds.dtype
    # the crop/pad size always derives from the gaussian support, even in uniform mode
    gauss_kernel_size = [int(3.5 * s + 0.5) * 2 + 1 for s in sigma]
    pad_h = (gauss_kernel_size[0] - 1) // 2
    pad_w = (gauss_kernel_size[1] - 1) // 2

    if is_3d:
        pad_d = (gauss_kernel_size[2] - 1) // 2
        # the JAX package passes (pad_h, pad_w, pad_d) into (pad_d, pad_h, pad_w): kept
        preds = _reflect_pad_3d(preds, pad_h, pad_w, pad_d)
        target = _reflect_pad_3d(target, pad_h, pad_w, pad_d)
    else:
        preds = _reflect_pad_2d(preds, pad_h, pad_w)
        target = _reflect_pad_2d(target, pad_h, pad_w)

    b = preds.shape[0]
    if not is_3d:
        # the separable moments kernel: the p^2, t^2, pt planes never reach device memory
        if gaussian_kernel:
            wh = _gaussian(gauss_kernel_size[0], sigma[0], torch.float32, preds.device)
            ww = _gaussian(gauss_kernel_size[1], sigma[1], torch.float32, preds.device)
        else:
            wh = torch.full((kernel_size[0],), 1.0 / kernel_size[0], dtype=torch.float32, device=preds.device)
            ww = torch.full((kernel_size[1],), 1.0 / kernel_size[1], dtype=torch.float32, device=preds.device)
        planes = kernels.ssim_moments(
            preds.reshape(-1, *preds.shape[2:]), target.reshape(-1, *target.shape[2:]), wh, ww
        )  # [B*C, 5, Ho, Wo]
        moments = planes.reshape(b, channel, 5, *planes.shape[2:]).to(dtype)
        mu_pred, mu_target, e_pp, e_tt, e_pt = (moments[:, :, i] for i in range(5))
    else:
        if gaussian_kernel:
            kernel = _gaussian_kernel_3d(channel, gauss_kernel_size, sigma, dtype, preds.device)
        else:
            kernel = torch.full(
                (channel, 1, *kernel_size), 1.0 / math.prod(kernel_size), dtype=dtype, device=preds.device
            )
        # (5B, C, ...) stack: one grouped conv produces all five moments
        input_list = torch.cat((preds, target, preds * preds, target * target, preds * target), dim=0)
        outputs = _conv3d(input_list, kernel, groups=channel)
        mu_pred, mu_target, e_pp, e_tt, e_pt = (outputs[i * b : (i + 1) * b] for i in range(5))

    mu_pred_sq = torch.square(mu_pred)
    mu_target_sq = torch.square(mu_target)
    mu_pred_target = mu_pred * mu_target

    sigma_pred_sq = torch.clamp(e_pp - mu_pred_sq, min=0.0)
    sigma_target_sq = torch.clamp(e_tt - mu_target_sq, min=0.0)
    sigma_pred_target = e_pt - mu_pred_target

    upper = 2 * sigma_pred_target + c2
    lower = sigma_pred_sq + sigma_target_sq + c2

    ssim_full = ((2 * mu_pred_target + c1) * upper) / ((mu_pred_sq + mu_target_sq + c1) * lower)

    if is_3d:
        ssim_idx = ssim_full[..., pad_h:-pad_h, pad_w:-pad_w, pad_d:-pad_d]
    else:
        ssim_idx = ssim_full[..., pad_h:-pad_h, pad_w:-pad_w]

    if return_contrast_sensitivity:
        cs = upper / lower
        if is_3d:
            cs = cs[..., pad_h:-pad_h, pad_w:-pad_w, pad_d:-pad_d]
        else:
            cs = cs[..., pad_h:-pad_h, pad_w:-pad_w]
        return ssim_idx.reshape(b, -1).mean(-1), cs.reshape(b, -1).mean(-1)

    if return_full_image:
        return ssim_idx.reshape(b, -1).mean(-1), ssim_full

    return ssim_idx.reshape(b, -1).mean(-1)


def _ssim_compute(similarities: Tensor, reduction: Optional[str] = "elementwise_mean") -> Tensor:
    """Apply the requested reduction to per-image similarities."""
    return reduce(similarities, reduction)


def structural_similarity_index_measure(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    return_full_image: bool = False,
    return_contrast_sensitivity: bool = False,
) -> Union[Tensor, Tuple[Tensor, Tensor]]:
    """Compute the structural similarity index measure.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image import structural_similarity_index_measure
        >>> preds = torch.rand(3, 3, 64, 64, generator=torch.Generator().manual_seed(0))
        >>> target = preds * 0.75
        >>> float(structural_similarity_index_measure(preds, target)) > 0.9
        True
    """
    preds, target = _ssim_check_inputs(preds, target)
    similarity_pack = _ssim_update(
        preds,
        target,
        gaussian_kernel,
        sigma,
        kernel_size,
        data_range,
        k1,
        k2,
        return_full_image,
        return_contrast_sensitivity,
    )
    if isinstance(similarity_pack, tuple):
        similarity, image = similarity_pack
        return _ssim_compute(similarity, reduction), image
    return _ssim_compute(similarity_pack, reduction)


def _get_normalized_sim_and_cs(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    normalize: Optional[str] = None,
) -> Tuple[Tensor, Tensor]:
    sim, cs = _ssim_update(
        preds,
        target,
        gaussian_kernel,
        sigma,
        kernel_size,
        data_range,
        k1,
        k2,
        return_contrast_sensitivity=True,
    )
    if normalize == "relu":
        sim = torch.relu(sim)
        cs = torch.relu(cs)
    return sim, cs


def _multiscale_ssim_update(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = None,
) -> Tensor:
    """Per-image MS-SSIM over the scale pyramid (one moments launch per scale in 2D)."""
    is_3d = preds.ndim == 5
    if not isinstance(kernel_size, Sequence):
        kernel_size = 3 * [kernel_size] if is_3d else 2 * [kernel_size]
    if not isinstance(sigma, Sequence):
        sigma = 3 * [sigma] if is_3d else 2 * [sigma]

    if preds.shape[-1] < 2 ** len(betas) or preds.shape[-2] < 2 ** len(betas):
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)}, the image height and width dimensions must be"
            f" larger than or equal to {2 ** len(betas)}."
        )
    _betas_div = max(1, (len(betas) - 1)) ** 2
    if preds.shape[-2] // _betas_div <= kernel_size[0] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {kernel_size[0]},"
            f" the image height must be larger than {(kernel_size[0] - 1) * _betas_div}."
        )
    if preds.shape[-1] // _betas_div <= kernel_size[1] - 1:
        raise ValueError(
            f"For a given number of `betas` parameters {len(betas)} and kernel size {kernel_size[1]},"
            f" the image width must be larger than {(kernel_size[1] - 1) * _betas_div}."
        )

    mcs_list: List[Tensor] = []
    sim = None
    for scale in range(len(betas)):
        sim, cs = _get_normalized_sim_and_cs(
            preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2, normalize=normalize
        )
        mcs_list.append(cs)
        if scale == len(betas) - 1:
            break  # the JAX package pools once more and discards the result
        if len(kernel_size) == 2:
            preds = _avg_pool2d(preds)
            target = _avg_pool2d(target)
        elif len(kernel_size) == 3:
            preds = _avg_pool3d(preds)
            target = _avg_pool3d(target)
        else:
            raise ValueError("length of kernel_size is neither 2 nor 3")

    mcs_list[-1] = sim
    mcs_stack = torch.stack(mcs_list)

    if normalize == "simple":
        mcs_stack = (mcs_stack + 1) / 2

    betas_arr = torch.tensor(betas, dtype=mcs_stack.dtype, device=mcs_stack.device)[:, None]
    mcs_weighted = mcs_stack**betas_arr
    return torch.prod(mcs_weighted, dim=0)


def _multiscale_ssim_compute(mcs_per_image: Tensor, reduction: Optional[str] = "elementwise_mean") -> Tensor:
    """Apply the requested reduction to per-image MS-SSIM."""
    return reduce(mcs_per_image, reduction)


def multiscale_structural_similarity_index_measure(
    preds: Tensor,
    target: Tensor,
    gaussian_kernel: bool = True,
    sigma: Union[float, Sequence[float]] = 1.5,
    kernel_size: Union[int, Sequence[int]] = 11,
    reduction: Optional[str] = "elementwise_mean",
    data_range: Optional[Union[float, Tuple[float, float]]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Tuple[float, ...] = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333),
    normalize: Optional[str] = "relu",
) -> Tensor:
    """Compute multi-scale SSIM.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.image import multiscale_structural_similarity_index_measure
        >>> preds = torch.rand(3, 3, 64, 64, generator=torch.Generator().manual_seed(0))
        >>> target = preds * 0.75
        >>> betas = (0.2856, 0.3001, 0.2363)
        >>> float(multiscale_structural_similarity_index_measure(preds, target, betas=betas)) > 0.8
        True
    """
    if not isinstance(betas, tuple):
        raise ValueError("Argument `betas` is expected to be of a type tuple")
    if isinstance(betas, tuple) and not all(isinstance(beta, float) for beta in betas):
        raise ValueError("Argument `betas` is expected to be a tuple of floats")
    if normalize and normalize not in ("relu", "simple"):
        raise ValueError("Argument `normalize` to be expected either `None`, `relu` or `simple`")

    preds, target = _ssim_check_inputs(preds, target)
    mcs_per_image = _multiscale_ssim_update(
        preds, target, gaussian_kernel, sigma, kernel_size, data_range, k1, k2, betas, normalize
    )
    return _multiscale_ssim_compute(mcs_per_image, reduction)
