"""Categorical association statistics: Cramer's V, Pearson's C, Tschuprow's T, Theil's U,
Fleiss' kappa.

Counterpart of ``torchmetrics_tpu/functional/nominal/association.py``. Every
contingency table is one launch of the confusion-matrix kernel, through the
classification family's ``_multiclass_confusion_matrix_update``, as in JAX. The
functional path first maps the joint values of both series to 0..C-1 with
``torch.unique`` where the data is (JAX maps on the host). A ``*_matrix`` function
takes one table (one launch) per pair of columns: each unordered pair once, every
ordered pair for Theil's U.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.classification.confusion_matrix import (
    _multiclass_confusion_matrix_update,
)
from torchmetrics_tpu_torch.functional.nominal.utils import (
    _compute_bias_corrected_values,
    _compute_chi_squared,
    _drop_empty_rows_and_cols,
    _float32_sqrt,
    _handle_nan_in_data,
    _nominal_input_validation,
    _unable_to_use_bias_correction_warning,
)

Tensor = torch.Tensor


def _nominal_pair_preamble(preds, target, nan_strategy, nan_replace_value) -> Tuple[Tensor, Tensor]:
    """Shared input pipeline: argmax 2D inputs, handle NaNs."""
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target, device=preds.device)
    preds = preds.argmax(1) if preds.ndim == 2 else preds
    target = target.argmax(1) if target.ndim == 2 else target
    return _handle_nan_in_data(preds, target, nan_strategy, nan_replace_value)


def _nominal_confmat_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    """Fixed-num_classes nominal update (the module path's summable state)."""
    preds, target = _nominal_pair_preamble(preds, target, nan_strategy, nan_replace_value)
    preds = preds.to(torch.int32)
    target = target.to(torch.int32)
    valid = torch.ones_like(preds, dtype=torch.bool)
    return _multiclass_confusion_matrix_update(preds, target, valid, num_classes)


def _prepare_nominal_confmat(preds, target, nan_strategy, nan_replace_value) -> Tensor:
    """Functional-path update: densify category values to 0..C-1 first (C counts the
    unique values of both series after NaN handling)."""
    preds, target = _nominal_pair_preamble(preds, target, nan_strategy, nan_replace_value)
    classes, inverse = torch.unique(torch.cat([preds.reshape(-1), target.reshape(-1)]), return_inverse=True)
    n = preds.numel()
    p = inverse[:n].to(torch.int32)
    t = inverse[n:].to(torch.int32)
    valid = torch.ones_like(p, dtype=torch.bool)
    return _multiclass_confusion_matrix_update(p, t, valid, classes.numel())


def _cramers_v_compute(confmat: Tensor, bias_correction: bool) -> Tensor:
    """Cramer's V from a contingency table."""
    confmat = _drop_empty_rows_and_cols(confmat)
    cm_sum = confmat.sum()
    chi_squared = _compute_chi_squared(confmat, bias_correction)
    phi_squared = chi_squared / cm_sum
    num_rows, num_cols = confmat.shape

    if bias_correction:
        phi_squared_corrected, rows_corrected, cols_corrected = _compute_bias_corrected_values(
            phi_squared, num_rows, num_cols, cm_sum
        )
        if float(torch.minimum(rows_corrected, cols_corrected)) == 1:
            _unable_to_use_bias_correction_warning(metric_name="Cramer's V")
            return torch.tensor(float("nan"), device=confmat.device)
        cramers_v_value = torch.sqrt(phi_squared_corrected / torch.minimum(rows_corrected - 1, cols_corrected - 1))
    else:
        cramers_v_value = torch.sqrt(phi_squared / min(num_rows - 1, num_cols - 1))
    return torch.clamp(cramers_v_value, 0.0, 1.0)


def cramers_v(
    preds: Tensor,
    target: Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    r"""Compute Cramer's V statistic of association between two categorical series.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.nominal import cramers_v
        >>> preds = torch.tensor([0, 1, 2, 3, 0, 1, 2, 3, 0, 1, 2, 3])
        >>> target = torch.tensor([0, 1, 2, 3, 1, 2, 3, 0, 0, 1, 2, 3])
        >>> cramers_v(preds, target, bias_correction=False).round(decimals=4)
        tensor(0.6383)
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    confmat = _prepare_nominal_confmat(preds, target, nan_strategy, nan_replace_value)
    return _cramers_v_compute(confmat, bias_correction)


def _pearsons_contingency_coefficient_compute(confmat: Tensor) -> Tensor:
    """Pearson's contingency coefficient from a contingency table."""
    confmat = _drop_empty_rows_and_cols(confmat)
    cm_sum = confmat.sum()
    chi_squared = _compute_chi_squared(confmat, bias_correction=False)
    phi_squared = chi_squared / cm_sum
    return torch.clamp(torch.sqrt(phi_squared / (1 + phi_squared)), 0.0, 1.0)


def pearsons_contingency_coefficient(
    preds: Tensor,
    target: Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    r"""Compute Pearson's contingency coefficient between two categorical series.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.nominal import pearsons_contingency_coefficient
        >>> preds = torch.tensor([0, 1, 2, 3, 0, 1, 2, 3, 0, 1, 2, 3])
        >>> target = torch.tensor([0, 1, 2, 3, 1, 2, 3, 0, 0, 1, 2, 3])
        >>> pearsons_contingency_coefficient(preds, target).round(decimals=4)
        tensor(0.7416)
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    confmat = _prepare_nominal_confmat(preds, target, nan_strategy, nan_replace_value)
    return _pearsons_contingency_coefficient_compute(confmat)


def _tschuprows_t_compute(confmat: Tensor, bias_correction: bool) -> Tensor:
    """Tschuprow's T from a contingency table."""
    confmat = _drop_empty_rows_and_cols(confmat)
    cm_sum = confmat.sum()
    chi_squared = _compute_chi_squared(confmat, bias_correction)
    phi_squared = chi_squared / cm_sum
    num_rows, num_cols = confmat.shape

    if bias_correction:
        phi_squared_corrected, rows_corrected, cols_corrected = _compute_bias_corrected_values(
            phi_squared, num_rows, num_cols, cm_sum
        )
        if float(torch.minimum(rows_corrected, cols_corrected)) == 1:
            _unable_to_use_bias_correction_warning(metric_name="Tschuprow's T")
            return torch.tensor(float("nan"), device=confmat.device)
        tschuprows_t_value = torch.sqrt(
            phi_squared_corrected / torch.sqrt((rows_corrected - 1) * (cols_corrected - 1))
        )
    else:
        tschuprows_t_value = torch.sqrt(phi_squared / _float32_sqrt(float((num_rows - 1) * (num_cols - 1))))
    return torch.clamp(tschuprows_t_value, 0.0, 1.0)


def tschuprows_t(
    preds: Tensor,
    target: Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    r"""Compute Tschuprow's T statistic between two categorical series.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.nominal import tschuprows_t
        >>> preds = torch.tensor([0, 1, 2, 3, 0, 1, 2, 3, 0, 1, 2, 3])
        >>> target = torch.tensor([0, 1, 2, 3, 1, 2, 3, 0, 0, 1, 2, 3])
        >>> tschuprows_t(preds, target, bias_correction=False).round(decimals=4)
        tensor(0.6383)
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    confmat = _prepare_nominal_confmat(preds, target, nan_strategy, nan_replace_value)
    return _tschuprows_t_compute(confmat, bias_correction)


def _conditional_entropy_compute(confmat: Tensor) -> Tensor:
    """H(X|Y) from a contingency table."""
    confmat = _drop_empty_rows_and_cols(confmat)
    total_occurrences = confmat.sum()
    p_xy_m = confmat / total_occurrences
    p_y = confmat.sum(dim=1) / total_occurrences
    p_y_m = p_y[:, None].expand(p_xy_m.shape)
    vals = p_xy_m * torch.log(p_y_m / p_xy_m)
    return torch.nansum(vals)


def _theils_u_compute(confmat: Tensor) -> Tensor:
    """Theil's U from a contingency table."""
    confmat = _drop_empty_rows_and_cols(confmat)
    s_xy = _conditional_entropy_compute(confmat)

    total_occurrences = confmat.sum()
    p_x = confmat.sum(dim=0) / total_occurrences
    s_x = -torch.sum(p_x * torch.log(p_x))
    if float(s_x) == 0:
        return torch.tensor(0.0, device=confmat.device)
    return (s_x - s_xy) / s_x


def theils_u(
    preds: Tensor,
    target: Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    r"""Compute Theil's U (uncertainty coefficient) between two categorical series.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.nominal import theils_u
        >>> preds = torch.tensor([0, 1, 2, 3, 0, 1, 2, 3, 0, 1, 2, 3])
        >>> target = torch.tensor([0, 1, 2, 3, 1, 2, 3, 0, 0, 1, 2, 3])
        >>> theils_u(preds, target).round(decimals=4)
        tensor(0.5409)
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    confmat = _prepare_nominal_confmat(preds, target, nan_strategy, nan_replace_value)
    return _theils_u_compute(confmat)


def _fleiss_kappa_update(ratings: Tensor, mode: str = "counts") -> Tensor:
    """Validate and convert ratings to a per-sample category-count matrix."""
    ratings = torch.as_tensor(ratings)
    if mode == "probs":
        if ratings.ndim != 3 or not ratings.is_floating_point():
            raise ValueError(
                "If argument ``mode`` is 'probs', ratings must have 3 dimensions with the format"
                " [n_samples, n_categories, n_raters] and be floating point."
            )
        n_categories = ratings.shape[1]
        rater_choices = ratings.argmax(dim=1)  # (n_samples, n_raters)
        counts = torch.zeros((ratings.shape[0], n_categories), dtype=torch.int32, device=ratings.device)
        ratings = counts.scatter_add_(1, rater_choices, torch.ones_like(rater_choices, dtype=torch.int32))
    elif mode == "counts" and (ratings.ndim != 2 or ratings.is_floating_point()):
        raise ValueError(
            "If argument ``mode`` is `counts`, ratings must have 2 dimensions with the format"
            " [n_samples, n_categories] and be none floating point."
        )
    return ratings


def _fleiss_kappa_compute(counts: Tensor) -> Tensor:
    """Fleiss' kappa from the per-sample category counts."""
    counts = counts.to(torch.float32)
    total = counts.shape[0]
    num_raters = counts.sum(dim=1).max()
    p_i = counts.sum(dim=0) / (total * num_raters)
    p_j = (torch.square(counts).sum(dim=1) - num_raters) / (num_raters * (num_raters - 1))
    p_bar = p_j.mean()
    pe_bar = torch.square(p_i).sum()
    return (p_bar - pe_bar) / (1 - pe_bar + 1e-5)


def fleiss_kappa(ratings: Tensor, mode: str = "counts") -> Tensor:
    r"""Compute Fleiss' kappa, the inter-rater agreement over chance.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.nominal import fleiss_kappa
        >>> ratings = torch.tensor([[3, 0, 0], [0, 3, 0], [1, 1, 1], [0, 0, 3]])
        >>> fleiss_kappa(ratings).round(decimals=4)
        tensor(0.6250)
    """
    if mode not in ["counts", "probs"]:
        raise ValueError("Argument ``mode`` must be one of 'counts' or 'probs'.")
    counts = _fleiss_kappa_update(ratings, mode)
    return _fleiss_kappa_compute(counts)


def _pairwise_matrix(matrix: Tensor, compute_one: Callable[[Tensor, Tensor], Tensor], symmetric: bool = True) -> Tensor:
    """Matrix of a nominal statistic over all column pairs of ``matrix``."""
    matrix = torch.as_tensor(matrix)
    num_variables = matrix.shape[1]
    out = torch.ones((num_variables, num_variables), dtype=torch.float32)
    for i in range(num_variables):
        for j in range((i + 1) if symmetric else 0, num_variables):
            if i == j:
                continue
            value = float(compute_one(matrix[:, i], matrix[:, j]))
            if symmetric:
                out[i, j] = out[j, i] = value
            else:
                out[i, j] = value
    return out.to(matrix.device)


def cramers_v_matrix(
    matrix: Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    r"""Compute Cramer's V statistic between all pairs of columns in a data matrix.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.nominal import cramers_v_matrix
        >>> matrix = torch.randint(0, 4, (200, 5), generator=torch.Generator().manual_seed(42))
        >>> cramers_v_matrix(matrix).shape
        torch.Size([5, 5])
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    return _pairwise_matrix(
        matrix, lambda x, y: cramers_v(x, y, bias_correction, nan_strategy, nan_replace_value)
    )


def pearsons_contingency_coefficient_matrix(
    matrix: Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    r"""Compute Pearson's contingency coefficient between all pairs of columns.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.nominal import pearsons_contingency_coefficient_matrix
        >>> matrix = torch.randint(0, 4, (200, 5), generator=torch.Generator().manual_seed(42))
        >>> pearsons_contingency_coefficient_matrix(matrix).shape
        torch.Size([5, 5])
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    return _pairwise_matrix(
        matrix, lambda x, y: pearsons_contingency_coefficient(x, y, nan_strategy, nan_replace_value)
    )


def tschuprows_t_matrix(
    matrix: Tensor,
    bias_correction: bool = True,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    r"""Compute Tschuprow's T statistic between all pairs of columns.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.nominal import tschuprows_t_matrix
        >>> matrix = torch.randint(0, 4, (200, 5), generator=torch.Generator().manual_seed(42))
        >>> tschuprows_t_matrix(matrix).shape
        torch.Size([5, 5])
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    return _pairwise_matrix(
        matrix, lambda x, y: tschuprows_t(x, y, bias_correction, nan_strategy, nan_replace_value)
    )


def theils_u_matrix(
    matrix: Tensor,
    nan_strategy: str = "replace",
    nan_replace_value: Optional[float] = 0.0,
) -> Tensor:
    r"""Compute Theil's U statistic between all pairs of columns (asymmetric).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.nominal import theils_u_matrix
        >>> matrix = torch.randint(0, 4, (200, 5), generator=torch.Generator().manual_seed(42))
        >>> theils_u_matrix(matrix).shape
        torch.Size([5, 5])
    """
    _nominal_input_validation(nan_strategy, nan_replace_value)
    return _pairwise_matrix(
        matrix, lambda x, y: theils_u(x, y, nan_strategy, nan_replace_value), symmetric=False
    )
