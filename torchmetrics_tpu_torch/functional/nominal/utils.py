"""Shared helpers for nominal (categorical association) metrics.

Counterpart of ``torchmetrics_tpu/functional/nominal/utils.py``. ``"drop"`` filters
the rows with a NaN where the data is (JAX filters on the host); the kept rows are
float32, as JAX returns them. Tables of counts take JAX's float32 arithmetic: the
expected frequencies are the outer product of the float32 margins (exact below 2^24,
so each product rounds once, as JAX's int32 product does when cast to float32).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

Tensor = torch.Tensor


def _nominal_input_validation(nan_strategy: str, nan_replace_value: Optional[float]) -> None:
    if nan_strategy not in ["replace", "drop"]:
        raise ValueError(
            f"Argument `nan_strategy` is expected to be one of `['replace', 'drop']`, but got {nan_strategy}"
        )
    if nan_strategy == "replace" and not isinstance(nan_replace_value, (float, int)):
        raise ValueError(
            "Argument `nan_replace` is expected to be of a type `int` or `float` when `nan_strategy = 'replace`, "
            f"but got {nan_replace_value}"
        )


def _handle_nan_in_data(
    preds: Tensor,
    target: Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tuple[Tensor, Tensor]:
    """Replace NaNs with a value, or drop rows containing any NaN."""
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target, device=preds.device)
    if nan_strategy == "replace":
        return torch.nan_to_num(preds, nan=nan_replace_value), torch.nan_to_num(target, nan=nan_replace_value)
    if nan_strategy == "drop":
        keep = ~(torch.isnan(preds) | torch.isnan(target))
        return preds[keep].to(torch.float32), target[keep].to(torch.float32)
    raise ValueError(f"Argument `nan_strategy` is expected to be one of `['replace', 'drop']`, but got {nan_strategy}")


def _compute_expected_freqs(confmat: Tensor) -> Tensor:
    """Outer product of marginals over the total count."""
    margin_rows = confmat.sum(dim=1).to(torch.float32)
    margin_cols = confmat.sum(dim=0).to(torch.float32)
    return torch.outer(margin_rows, margin_cols) / confmat.sum().to(torch.float32)


def _compute_chi_squared(confmat: Tensor, bias_correction: bool) -> Tensor:
    """Chi-square statistic of a contingency table (with optional Yates correction)."""
    expected_freqs = _compute_expected_freqs(confmat)
    df = expected_freqs.numel() - sum(expected_freqs.shape) + expected_freqs.ndim - 1
    if df == 0:
        return torch.tensor(0.0, device=confmat.device)
    if df == 1 and bias_correction:
        diff = expected_freqs - confmat
        direction = torch.sign(diff)
        confmat = confmat + direction * torch.clamp(torch.abs(diff), max=0.5)
    return torch.sum(torch.square(confmat - expected_freqs) / expected_freqs)


def _drop_empty_rows_and_cols(confmat: Tensor) -> Tensor:
    """Drop all-zero rows and columns."""
    confmat = confmat[confmat.sum(dim=1) != 0]
    return confmat[:, confmat.sum(dim=0) != 0]


def _compute_phi_squared_corrected(phi_squared: Tensor, num_rows: int, num_cols: int, confmat_sum: Tensor) -> Tensor:
    """Bias-corrected phi²."""
    return torch.clamp(phi_squared - ((num_rows - 1) * (num_cols - 1)) / (confmat_sum - 1), min=0.0)


def _compute_rows_and_cols_corrected(num_rows: int, num_cols: int, confmat_sum: Tensor) -> Tuple[Tensor, Tensor]:
    """Bias-corrected effective row/column counts."""
    rows_corrected = num_rows - (num_rows - 1) ** 2 / (confmat_sum - 1)
    cols_corrected = num_cols - (num_cols - 1) ** 2 / (confmat_sum - 1)
    return rows_corrected, cols_corrected


def _compute_bias_corrected_values(
    phi_squared: Tensor, num_rows: int, num_cols: int, confmat_sum: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """Bias-corrected phi² plus effective row/column counts."""
    phi_squared_corrected = _compute_phi_squared_corrected(phi_squared, num_rows, num_cols, confmat_sum)
    rows_corrected, cols_corrected = _compute_rows_and_cols_corrected(num_rows, num_cols, confmat_sum)
    return phi_squared_corrected, rows_corrected, cols_corrected


def _float32_sqrt(value: float) -> float:
    """``sqrt`` of a Python number in float32, as ``jnp.sqrt`` takes one."""
    return float(torch.sqrt(torch.tensor(value, dtype=torch.float32)))


def _unable_to_use_bias_correction_warning(metric_name: str) -> None:
    rank_zero_warn(
        f"Unable to compute {metric_name} using bias correction. Please consider to set `bias_correction=False`."
    )


