"""Final reductions turning tp/fp/tn/fn counts into metric values.

Counterpart of ``torchmetrics_tpu/functional/classification/_stat_reduce.py``, cut to
the accuracy and F-beta reductions of this slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from torchmetrics_tpu_torch.utils.data import safe_divide

Tensor = torch.Tensor


def _micro_sum(x: Tensor, multidim_average: str) -> Tensor:
    """Collapse counts for micro averaging (global states may already be 0-d)."""
    return x.sum() if multidim_average == "global" else x.sum(dim=-1)


def _adjust_weights_safe_divide(
    score: Tensor,
    average: Optional[str],
    multilabel: bool,
    tp: Tensor,
    fp: Tensor,
    fn: Tensor,
    top_k: int = 1,
) -> Tensor:
    """Macro/weighted averaging over the class axis; macro skips classes without support."""
    if average is None or average == "none":
        return score
    if average == "weighted":
        weights = (tp + fn).to(score.dtype)
    else:
        weights = torch.ones_like(score)
        if not multilabel:
            empty = (tp + fp + fn == 0) if top_k == 1 else (tp + fn == 0)
            weights = torch.where(empty, torch.zeros_like(weights), weights)
    return safe_divide(weights * score, weights.sum(dim=-1, keepdim=True)).sum(dim=-1)


def _accuracy_reduce(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
    top_k: int = 1,
) -> Tensor:
    if average == "binary":
        return safe_divide(tp + tn, tp + tn + fp + fn)
    if average == "micro":
        tp = _micro_sum(tp, multidim_average)
        fn = _micro_sum(fn, multidim_average)
        if multilabel:
            fp = _micro_sum(fp, multidim_average)
            tn = _micro_sum(tn, multidim_average)
            return safe_divide(tp + tn, tp + tn + fp + fn)
        return safe_divide(tp, tp + fn)
    score = safe_divide(tp + tn, tp + tn + fp + fn) if multilabel else safe_divide(tp, tp + fn)
    return _adjust_weights_safe_divide(score, average, multilabel, tp, fp, fn, top_k)


def _fbeta_reduce(
    tp: Tensor,
    fp: Tensor,
    tn: Tensor,
    fn: Tensor,
    beta: float,
    average: Optional[str],
    multidim_average: str = "global",
    multilabel: bool = False,
    zero_division: float = 0.0,
) -> Tensor:
    beta2 = beta**2
    if average == "binary":
        return safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp, zero_division)
    if average == "micro":
        tp = _micro_sum(tp, multidim_average)
        fn = _micro_sum(fn, multidim_average)
        fp = _micro_sum(fp, multidim_average)
        return safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp, zero_division)
    fbeta_score = safe_divide((1 + beta2) * tp, (1 + beta2) * tp + beta2 * fn + fp, zero_division)
    return _adjust_weights_safe_divide(fbeta_score, average, multilabel, tp, fp, fn)
