"""Multilabel ranking metrics: coverage error, ranking average precision, ranking loss.

Counterpart of ``torchmetrics_tpu/functional/classification/ranking.py``: O(N·L²)
broadcast compares and ``einsum``s, no sort; ``ignore_index`` positions are masked out of
both counts and ranks. The states are float32 sums. A row with no relevant label counts
coverage 0, LRAP 1 and loss 0, as the JAX package's ``where`` gives.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import (
    _multilabel_precision_recall_curve_format,
    _multilabel_precision_recall_curve_tensor_validation,
)
from torchmetrics_tpu_torch.utils.data import safe_divide

Tensor = torch.Tensor


def _multilabel_ranking_tensor_validation(
    preds: Tensor, target: Tensor, num_labels: int, ignore_index: Optional[int] = None
) -> None:
    _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)


def _rows(preds: Tensor) -> Tensor:
    return torch.full((), preds.shape[0], dtype=torch.float32, device=preds.device)


def _multilabel_coverage_error_update(preds: Tensor, target: Tensor, valid: Tensor) -> Tuple[Tensor, Tensor]:
    """Σ per-sample coverage, n: coverage = #labels scored ≥ the lowest relevant score."""
    rel = (target == 1) & valid
    # lowest relevant score per sample (+inf when none is relevant: coverage 0)
    min_rel = torch.where(rel, preds, torch.full_like(preds, float("inf"))).amin(dim=-1)
    coverage = ((preds >= min_rel[:, None]) & valid).sum(dim=-1, dtype=torch.int32).to(torch.float32)
    coverage = torch.where(rel.any(dim=-1), coverage, torch.zeros_like(coverage))
    return coverage.sum(), _rows(preds)


def multilabel_coverage_error(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """How far down the ranking one must go to cover all relevant labels (sklearn
    ``coverage_error`` semantics)."""
    if validate_args:
        _multilabel_ranking_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, valid, _ = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, None, ignore_index
    )
    measure, total = _multilabel_coverage_error_update(preds, target, valid)
    return safe_divide(measure, total)


def _multilabel_ranking_average_precision_update(
    preds: Tensor, target: Tensor, valid: Tensor
) -> Tuple[Tensor, Tensor]:
    """Σ per-sample LRAP, n."""
    rel = ((target == 1) & valid).to(torch.float32)  # [N, L]
    # ge[n, l, k] = preds[n, k] >= preds[n, l] and k valid
    ge = (preds[:, :, None] <= preds[:, None, :]) & valid[:, None, :]
    # rank of label l = #{k: score_k >= score_l}
    rank = ge.sum(dim=-1, dtype=torch.int32).to(torch.float32)  # [N, L]
    # relevant-rank of label l = #{k relevant: score_k >= score_l}
    rel_rank = torch.einsum("nlk,nk->nl", ge.to(torch.float32), rel)
    per_label = safe_divide(rel_rank, rank) * rel
    n_rel = rel.sum(dim=-1)
    score = safe_divide(per_label.sum(dim=-1), n_rel)
    score = torch.where(n_rel > 0, score, torch.ones_like(score))
    return score.sum(), _rows(preds)


def multilabel_ranking_average_precision(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Label-ranking average precision (sklearn ``label_ranking_average_precision_score``)."""
    if validate_args:
        _multilabel_ranking_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, valid, _ = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, None, ignore_index
    )
    measure, total = _multilabel_ranking_average_precision_update(preds, target, valid)
    return safe_divide(measure, total)


def _multilabel_ranking_loss_update(preds: Tensor, target: Tensor, valid: Tensor) -> Tuple[Tensor, Tensor]:
    """Σ per-sample ranking loss, n: the share of mis-ordered (relevant, irrelevant) pairs."""
    rel = ((target == 1) & valid).to(torch.float32)
    irr = ((target == 0) & valid).to(torch.float32)
    # pair (l relevant, k irrelevant) is mis-ordered when score_l <= score_k
    mis = (preds[:, :, None] <= preds[:, None, :]).to(torch.float32)  # [N, l, k]
    bad = torch.einsum("nl,nlk,nk->n", rel, mis, irr)
    n_rel = rel.sum(dim=-1)
    n_irr = irr.sum(dim=-1)
    denom = n_rel * n_irr
    has = denom > 0
    loss = torch.where(has, bad / torch.where(has, denom, torch.ones_like(denom)), torch.zeros_like(bad))
    return loss.sum(), _rows(preds)


def multilabel_ranking_loss(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tensor:
    """Label-ranking loss (sklearn ``label_ranking_loss`` semantics)."""
    if validate_args:
        _multilabel_ranking_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, valid, _ = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, None, ignore_index
    )
    measure, total = _multilabel_ranking_loss_update(preds, target, valid)
    return safe_divide(measure, total)
