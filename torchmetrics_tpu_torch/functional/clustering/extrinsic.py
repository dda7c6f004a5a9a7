"""Extrinsic (label-vs-label) clustering metrics.

Counterpart of ``torchmetrics_tpu/functional/clustering/extrinsic.py``. All reduce
through the float64 contingency table of ``utils.calculate_contingency_matrix`` (one
bincount-kernel launch a table), on the labels' device. Each score takes JAX's
arithmetic step by step: float64 where JAX computes on the host in numpy (the mutual
information, the expected mutual information, the pair counts), rounded to float32
where JAX rounds, float32 where JAX combines float32 values.

JAX sums the expected mutual information by a Python loop over every (i, j) cell of
the table, ``min(a_i, b_j) - max(1, a_i + b_j - N) + 1`` hypergeometric terms a cell.
Here every (i, j, n_ij) term of a block of rows is made and summed in one float64
pass, with the same bounds and the same order of operations per term; each
``gammaln`` of an integer is read from one ``torch.lgamma`` table of 0..N+1, and the
terms are summed in another order.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from torchmetrics_tpu_torch.functional.clustering.utils import (
    _scalar,
    _validate_average_method_arg,
    calculate_contingency_matrix,
    calculate_entropy,
    calculate_generalized_mean,
    calculate_pair_cluster_confusion_matrix,
    check_cluster_labels,
)

Tensor = torch.Tensor

# the (i, j, n_ij) terms of the expected mutual information summed in one pass at most
# (a row of the table adds at most N + P terms, so a block may hold one row more)
EMI_BLOCK_TERMS = 1 << 23
_FLOAT32_EPS = float(torch.finfo(torch.float32).eps)


def _labels(preds, target) -> Tuple[Tensor, Tensor]:
    preds = torch.as_tensor(preds)
    return preds, torch.as_tensor(target, device=preds.device)


def _mutual_info_score_update(preds: Tensor, target: Tensor) -> Tensor:
    """Contingency matrix for an MI-family metric."""
    preds, target = _labels(preds, target)
    check_cluster_labels(preds, target)
    return calculate_contingency_matrix(preds, target)


def _mutual_info_score_compute(contingency: Tensor) -> Tensor:
    """MI from the nonzero contingency entries."""
    n = contingency.sum()
    u = contingency.sum(dim=1)
    v = contingency.sum(dim=0)
    if u.numel() == 1 or v.numel() == 1:
        return _scalar(0.0, contingency)

    nzu, nzv = torch.nonzero(contingency, as_tuple=True)
    vals = contingency[nzu, nzv]
    log_outer = torch.log(u[nzu]) + torch.log(v[nzv])
    mutual_info = vals / n * (torch.log(n) + torch.log(vals) - log_outer)
    return mutual_info.sum().to(torch.float32)


def mutual_info_score(preds: Tensor, target: Tensor) -> Tensor:
    """Compute mutual information between two clusterings.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.clustering import mutual_info_score
        >>> target = torch.tensor([0, 3, 2, 2, 1])
        >>> preds = torch.tensor([1, 3, 2, 0, 1])
        >>> mutual_info_score(preds, target).round(decimals=4)
        tensor(1.0549)
    """
    return _mutual_info_score_compute(_mutual_info_score_update(preds, target))


def normalized_mutual_info_score(preds: Tensor, target: Tensor, average_method: str = "arithmetic") -> Tensor:
    """Compute normalized mutual information between two clusterings.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.clustering import normalized_mutual_info_score
        >>> target = torch.tensor([0, 3, 2, 2, 1])
        >>> preds = torch.tensor([1, 3, 2, 0, 1])
        >>> normalized_mutual_info_score(preds, target, "arithmetic").round(decimals=4)
        tensor(0.7919)
    """
    preds, target = _labels(preds, target)
    check_cluster_labels(preds, target)
    _validate_average_method_arg(average_method)
    mutual_info = mutual_info_score(preds, target)
    if abs(float(mutual_info)) < _FLOAT32_EPS:
        return mutual_info
    normalizer = calculate_generalized_mean(
        torch.stack([calculate_entropy(preds), calculate_entropy(target)]), average_method
    )
    return mutual_info / normalizer


def expected_mutual_info_score(contingency: Tensor, n_samples: int) -> Tensor:
    """Expected MI under the permutation model: every hypergeometric term of every cell,
    a block of rows at a time, summed in float64."""
    contingency = torch.as_tensor(contingency)
    a = contingency.sum(dim=1).to(torch.int64)
    b = contingency.sum(dim=0).to(torch.int64)
    if a.numel() == 1 or b.numel() == 1:
        return _scalar(0.0, contingency)

    n = int(n_samples)
    num_rows, num_cols = a.numel(), b.numel()
    # each cell's first n_ij and its count of terms, JAX's `start` and `end - start`
    start = torch.clamp(a[:, None] - n + b[None, :], min=1)
    lengths = (torch.minimum(a[:, None], b[None, :]) + 1 - start).clamp_(min=0)
    row_terms = lengths.sum(dim=1).tolist()

    # every gammaln argument is an integer in [1, N + 1] and every log one in [1, N]:
    # tables of them, indexed per term, as JAX indexes its `log_nnij` and `gln_nnij`
    ints = torch.arange(n + 2, dtype=torch.float64, device=contingency.device)
    gammaln = torch.lgamma(ints)
    log_nnij = math.log(n) + torch.log(ints)
    gln_nnij = gammaln[1:] + math.lgamma(n + 1)
    log_a, log_b = torch.log(a.to(torch.float64)), torch.log(b.to(torch.float64))
    gln_a, gln_b = gammaln[a + 1], gammaln[b + 1]
    gln_na, gln_nb = gammaln[n - a + 1], gammaln[n - b + 1]

    # per cell (row-major, as JAX's loop): the sum of its four row and column gammaln terms,
    # taken in JAX's order, and the row's and column's sizes and logs
    cell_gln = (gln_a[:, None] + gln_b[None, :] + gln_na[:, None] + gln_nb[None, :]).reshape(-1)
    cell_a = a[:, None].expand(num_rows, num_cols).reshape(-1)
    cell_b = b[None, :].expand(num_rows, num_cols).reshape(-1)
    cell_log_a = log_a[:, None].expand(num_rows, num_cols).reshape(-1)
    cell_log_b = log_b[None, :].expand(num_rows, num_cols).reshape(-1)
    start, lengths = start.reshape(-1), lengths.reshape(-1)

    def take(values: Tensor, index: Tensor) -> Tensor:
        return values.index_select(0, index)

    emi = torch.zeros((), dtype=torch.float64, device=contingency.device)
    row = 0
    while row < num_rows:
        end, total = row, 0
        while end < num_rows and (end == row or total + row_terms[end] <= EMI_BLOCK_TERMS):
            total += row_terms[end]
            end += 1
        if total:
            first_cell, cells = row * num_cols, (end - row) * num_cols
            cell_lengths = lengths[first_cell:first_cell + cells]
            cell = first_cell + torch.repeat_interleave(
                torch.arange(cells, device=contingency.device), cell_lengths, output_size=total
            )
            first_term = torch.cumsum(cell_lengths, 0) - cell_lengths
            offset = torch.arange(total, device=contingency.device) - take(first_term, cell - first_cell)
            nij = take(start, cell) + offset
            ai, bj = take(cell_a, cell), take(cell_b, cell)
            term1 = nij.to(torch.float64) / n
            term2 = take(log_nnij, nij) - take(cell_log_a, cell) - take(cell_log_b, cell)
            gln = (
                take(cell_gln, cell)
                - take(gln_nnij, nij)
                - take(gammaln, ai - nij + 1)
                - take(gammaln, bj - nij + 1)
                - take(gammaln, n - ai - bj + nij + 1)
            )
            emi = emi + (term1 * term2 * torch.exp(gln)).sum()
        row = end
    return emi.to(torch.float32)


def adjusted_mutual_info_score(preds: Tensor, target: Tensor, average_method: str = "arithmetic") -> Tensor:
    """Compute adjusted mutual information between two clusterings.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.clustering import adjusted_mutual_info_score
        >>> preds = torch.tensor([2, 1, 0, 1, 0])
        >>> target = torch.tensor([0, 2, 1, 1, 0])
        >>> adjusted_mutual_info_score(preds, target, "arithmetic").round(decimals=4)
        tensor(-0.2500)
    """
    preds, target = _labels(preds, target)
    _validate_average_method_arg(average_method)
    contingency = _mutual_info_score_update(preds, target)
    mutual_info = _mutual_info_score_compute(contingency)
    expected_mi = expected_mutual_info_score(contingency, target.numel())
    normalizer = calculate_generalized_mean(
        torch.stack([calculate_entropy(preds), calculate_entropy(target)]), average_method
    )
    denominator = float(normalizer - expected_mi)
    if denominator < 0:
        denominator = min(denominator, -_FLOAT32_EPS)
    else:
        denominator = max(denominator, _FLOAT32_EPS)
    return (mutual_info - expected_mi) / denominator


def _rand_score_compute(contingency: Tensor) -> Tensor:
    """Rand index from the pair confusion matrix."""
    pair_matrix = calculate_pair_cluster_confusion_matrix(contingency=contingency)
    numerator = pair_matrix.diagonal().sum()
    denominator = pair_matrix.sum()
    if bool(numerator == denominator) or bool(denominator == 0):
        return _scalar(1.0, contingency)
    return (numerator / denominator).to(torch.float32)


def rand_score(preds: Tensor, target: Tensor) -> Tensor:
    """Compute the Rand score between two clusterings.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.clustering import rand_score
        >>> rand_score(torch.tensor([0, 0, 1, 2]), torch.tensor([0, 0, 1, 1])).round(decimals=4)
        tensor(0.8333)
    """
    return _rand_score_compute(_mutual_info_score_update(preds, target))


def _adjusted_rand_score_compute(contingency: Tensor) -> Tensor:
    """ARI from the pair confusion matrix."""
    (tn, fp), (fn, tp) = calculate_pair_cluster_confusion_matrix(contingency=contingency)
    if bool(fn == 0) and bool(fp == 0):
        return _scalar(1.0, contingency)
    return (2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn) + (tp + fp) * (fp + tn))).to(torch.float32)


def adjusted_rand_score(preds: Tensor, target: Tensor) -> Tensor:
    """Compute the adjusted Rand score between two clusterings.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.clustering import adjusted_rand_score
        >>> adjusted_rand_score(torch.tensor([0, 0, 1, 2]), torch.tensor([0, 0, 1, 1])).round(decimals=4)
        tensor(0.5714)
    """
    return _adjusted_rand_score_compute(_mutual_info_score_update(preds, target))


def _fowlkes_mallows_index_compute(contingency: Tensor, n: int) -> Tensor:
    """FMI from contingency pair counts."""
    tk = float((contingency**2).sum() - n)
    if abs(tk) < 1e-12:
        return _scalar(0.0, contingency)
    pk = float((contingency.sum(dim=0) ** 2).sum() - n)
    qk = float((contingency.sum(dim=1) ** 2).sum() - n)
    return _scalar(math.sqrt(tk / pk) * math.sqrt(tk / qk), contingency)


def fowlkes_mallows_index(preds: Tensor, target: Tensor) -> Tensor:
    """Compute the Fowlkes-Mallows index between two clusterings.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.clustering import fowlkes_mallows_index
        >>> preds = torch.tensor([2, 2, 0, 1, 0])
        >>> target = torch.tensor([2, 2, 1, 1, 0])
        >>> fowlkes_mallows_index(preds, target).round(decimals=4)
        tensor(0.5000)
    """
    preds, target = _labels(preds, target)
    contingency = _mutual_info_score_update(preds, target)
    return _fowlkes_mallows_index_compute(contingency, preds.numel())


def _homogeneity_score_compute(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Homogeneity plus MI/entropy intermediates."""
    preds, target = _labels(preds, target)
    check_cluster_labels(preds, target)
    if target.numel() == 0:
        zero = _scalar(0.0, target)
        return zero, zero, zero, zero
    entropy_target = calculate_entropy(target)
    entropy_preds = calculate_entropy(preds)
    mutual_info = mutual_info_score(preds, target)
    homogeneity = mutual_info / entropy_target if float(entropy_target) else torch.ones_like(entropy_target)
    return homogeneity, mutual_info, entropy_preds, entropy_target


def _completeness_score_compute(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """Completeness plus homogeneity."""
    homogeneity, mutual_info, entropy_preds, _ = _homogeneity_score_compute(preds, target)
    completeness = mutual_info / entropy_preds if float(entropy_preds) else torch.ones_like(entropy_preds)
    return completeness, homogeneity


def homogeneity_score(preds: Tensor, target: Tensor) -> Tensor:
    """Compute the homogeneity score between two clusterings.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.clustering import homogeneity_score
        >>> homogeneity_score(torch.tensor([0, 0, 1, 2]), torch.tensor([0, 0, 1, 1]))
        tensor(1.)
    """
    homogeneity, _, _, _ = _homogeneity_score_compute(preds, target)
    return homogeneity


def completeness_score(preds: Tensor, target: Tensor) -> Tensor:
    """Compute the completeness score between two clusterings.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.clustering import completeness_score
        >>> completeness_score(torch.tensor([0, 0, 1, 1]), torch.tensor([1, 1, 0, 0]))
        tensor(1.)
    """
    completeness, _ = _completeness_score_compute(preds, target)
    return completeness


def v_measure_score(preds: Tensor, target: Tensor, beta: float = 1.0) -> Tensor:
    """Compute the V-measure score between two clusterings.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.clustering import v_measure_score
        >>> v_measure_score(torch.tensor([0, 0, 1, 2]), torch.tensor([0, 0, 1, 1])).round(decimals=4)
        tensor(0.8000)
    """
    completeness, homogeneity = _completeness_score_compute(preds, target)
    if float(homogeneity + completeness) == 0.0:
        return torch.ones_like(homogeneity)
    return (1 + beta) * homogeneity * completeness / (beta * homogeneity + completeness)
