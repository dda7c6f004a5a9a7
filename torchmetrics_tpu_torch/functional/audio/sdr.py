"""Signal-to-distortion ratio family: SDR, SI-SDR and SA-SDR.

Counterpart of ``torchmetrics_tpu/functional/audio/sdr.py``. SDR's optimal distortion
filter solves a symmetric Toeplitz system built from FFT auto- and cross-correlations:
``torch.fft`` correlations, the Toeplitz matrix gathered from its first row, and one
batched ``torch.linalg.solve``. The solve runs in float32, as the JAX package's does
(the upstream reference solves in float64), so the two agree to a float tolerance. On
the card, where a caller has turned TF32 on for float32 products, the solve runs in
float64 and rounds once, so the flag does not move the score; no flag is written.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.image.utils import _as_jax_dtype
from torchmetrics_tpu_torch.utils.checks import _check_same_shape
from torchmetrics_tpu_torch.utils.compute import _cuda_matmul_precision

Tensor = torch.Tensor


def _symmetric_toeplitz(vector: Tensor) -> Tensor:
    """Symmetric Toeplitz matrix from its first row; shape [..., L] -> [..., L, L]."""
    i = torch.arange(vector.shape[-1], device=vector.device)
    return vector[..., (i[:, None] - i[None, :]).abs()]


def _compute_autocorr_crosscorr(target: Tensor, preds: Tensor, corr_len: int) -> Tuple[Tensor, Tensor]:
    """FFT-based autocorrelation of ``target`` and cross-correlation with ``preds``."""
    n_fft = 2 ** math.ceil(math.log2(preds.shape[-1] + target.shape[-1] - 1))

    t_fft = torch.fft.rfft(target, n=n_fft, dim=-1)
    r_0 = torch.fft.irfft(t_fft.real**2 + t_fft.imag**2, n=n_fft)[..., :corr_len]

    p_fft = torch.fft.rfft(preds, n=n_fft, dim=-1)
    b = torch.fft.irfft(torch.conj(t_fft) * p_fft, n=n_fft, dim=-1)[..., :corr_len]
    return r_0, b


def _solve_full_float32(a: Tensor, b: Tensor) -> Tensor:
    """``solve(a, b)`` in full float32: in float64 on the card where a caller has turned
    TF32 (or lower) on for float32 products, rounded once; as it is otherwise.

    On the CPU each matrix is solved on its own: after ``torch.set_num_threads``, a
    batched LAPACK solve of matrices this large fails in some PyTorch CPU builds (MKL's
    ``slaswp`` rejects its arguments and the call never returns)."""
    if a.is_cuda:
        if _cuda_matmul_precision() != "ieee":
            return torch.linalg.solve(a.to(torch.float64), b.to(torch.float64)).to(a.dtype)
        return torch.linalg.solve(a, b)
    batch = a.shape[:-2]
    a, b = a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:])
    return torch.stack([torch.linalg.solve(m, v) for m, v in zip(a, b)]).reshape(*batch, *b.shape[-2:])


def signal_distortion_ratio(
    preds: Tensor,
    target: Tensor,
    use_cg_iter: Optional[int] = None,
    filter_length: int = 512,
    zero_mean: bool = False,
    load_diag: Optional[float] = None,
) -> Tensor:
    r"""Calculate the signal-to-distortion ratio (BSS-eval SDR) per sample.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.audio import signal_distortion_ratio
        >>> g = torch.Generator().manual_seed(1)
        >>> preds, target = torch.randn(8000, generator=g), torch.randn(8000, generator=g)
        >>> float(signal_distortion_ratio(preds, target)) < 0
        True
    """
    preds = _as_jax_dtype(preds)
    target = _as_jax_dtype(target).to(preds.device)
    _check_same_shape(preds, target)

    if use_cg_iter is not None:
        from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

        rank_zero_warn(
            "The `use_cg_iter` option is not supported by the TPU implementation; the "
            "direct Toeplitz solve is used instead."
        )

    if zero_mean:
        preds = preds - preds.mean(dim=-1, keepdim=True)
        target = target - target.mean(dim=-1, keepdim=True)

    target = target / torch.clamp(torch.linalg.vector_norm(target, dim=-1, keepdim=True), min=1e-6)
    preds = preds / torch.clamp(torch.linalg.vector_norm(preds, dim=-1, keepdim=True), min=1e-6)

    r_0, b = _compute_autocorr_crosscorr(target, preds, corr_len=filter_length)
    if load_diag is not None:
        r_0 = torch.cat((r_0[..., :1] + load_diag, r_0[..., 1:]), dim=-1)

    r = _symmetric_toeplitz(r_0)
    sol = _solve_full_float32(r, b[..., None])[..., 0]

    coh = (b * sol).sum(dim=-1)
    ratio = coh / (1 - coh)
    return 10.0 * torch.log10(ratio)


def scale_invariant_signal_distortion_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """Calculate the scale-invariant signal-to-distortion ratio per sample.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.audio import scale_invariant_signal_distortion_ratio
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> scale_invariant_signal_distortion_ratio(preds, target).round(decimals=4)
        tensor(18.4030)
    """
    preds = _as_jax_dtype(preds)
    target = _as_jax_dtype(target).to(preds.device)
    _check_same_shape(preds, target)
    eps = torch.finfo(preds.dtype).eps

    if zero_mean:
        target = target - torch.mean(target, dim=-1, keepdim=True)
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)

    alpha = (torch.sum(preds * target, dim=-1, keepdim=True) + eps) / (
        torch.sum(torch.square(target), dim=-1, keepdim=True) + eps
    )
    target_scaled = alpha * target
    noise = target_scaled - preds
    val = (torch.sum(torch.square(target_scaled), dim=-1) + eps) / (torch.sum(torch.square(noise), dim=-1) + eps)
    return 10 * torch.log10(val)


def source_aggregated_signal_distortion_ratio(
    preds: Tensor,
    target: Tensor,
    scale_invariant: bool = True,
    zero_mean: bool = False,
) -> Tensor:
    """Calculate the source-aggregated SDR over all speakers of each sample.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.audio import source_aggregated_signal_distortion_ratio
        >>> g = torch.Generator().manual_seed(42)
        >>> preds, target = torch.randn(4, 2, 8000, generator=g), torch.randn(4, 2, 8000, generator=g)
        >>> source_aggregated_signal_distortion_ratio(preds, target).shape
        torch.Size([4])
    """
    preds = _as_jax_dtype(preds)
    target = _as_jax_dtype(target).to(preds.device)
    _check_same_shape(preds, target)
    if preds.ndim < 2:
        raise RuntimeError(
            f"The preds and target should have the shape (..., spk, time), but {tuple(preds.shape)} found"
        )

    eps = torch.finfo(preds.dtype).eps

    if zero_mean:
        target = target - torch.mean(target, dim=-1, keepdim=True)
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)

    if scale_invariant:
        alpha = ((preds * target).sum(dim=(-1, -2), keepdim=True) + eps) / (
            torch.square(target).sum(dim=(-1, -2), keepdim=True) + eps
        )
        target = alpha * target

    distortion = target - preds
    val = (torch.square(target).sum(dim=(-1, -2)) + eps) / (torch.square(distortion).sum(dim=(-1, -2)) + eps)
    return 10 * torch.log10(val)
