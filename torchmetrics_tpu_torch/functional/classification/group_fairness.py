"""Group fairness: per-group stat rates, demographic parity, equal opportunity.

Counterpart of ``torchmetrics_tpu/functional/classification/group_fairness.py``. The
per-group tp/fp/tn/fn counts are one int32 histogram on the bincount kernel: each valid
sample adds one to bin ``group * 4 + cell`` (cell 0..3 = tp, fp, tn, fn) and every other
sample to a spare bin past the ``4 * G`` counted ones. The JAX package contracts a
float32 one-hot instead; the counts agree wherever its float32 sums are exact (below
2^24 samples in one call). The ratio metrics' keys name the extreme groups, so their
final dicts are assembled on the host, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
    _is_traced,
)
from torchmetrics_tpu_torch.ops import kernels
from torchmetrics_tpu_torch.utils.data import safe_divide

Tensor = torch.Tensor


def _groups_validation(groups: Tensor, num_groups: int) -> None:
    if _is_traced(groups):
        return
    if groups.max() > num_groups - 1 or groups.min() < 0:
        raise ValueError(f"The largest number in the groups tensor is {int(groups.max())}, which is larger than the specified number of groups {num_groups}.")


def _groups_format(groups: Tensor) -> Tensor:
    return torch.as_tensor(groups).reshape(-1).to(torch.int32)


def _group_cell_ids(preds: Tensor, target: Tensor, groups: Tensor, valid: Tensor, num_groups: int) -> Tensor:
    """int32 [N] bins: ``group * 4 + cell`` (cell 0..3 = tp, fp, tn, fn) for a counted
    sample, the spare bin ``4 * G`` for an ignored one or one whose group lies outside
    ``[0, G)`` (its all-zero one-hot row counts nowhere in the JAX package)."""
    p = preds.reshape(-1) == 1
    t = (target.reshape(-1) == 1).to(torch.int32)
    cell = torch.where(p, 1 - t, 2 + t)
    counted = valid.reshape(-1) & (groups >= 0) & (groups < num_groups)
    return torch.where(counted, groups * 4 + cell, torch.full_like(cell, 4 * num_groups))


def _binary_groups_stat_scores_update(
    preds: Tensor,
    target: Tensor,
    groups: Tensor,
    valid: Tensor,
    num_groups: int,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-group (tp, fp, tn, fn), each int32 [G]: one bincount of ``4 * G + 1`` bins."""
    spare = 4 * num_groups
    ids = _group_cell_ids(preds, target, groups, valid, num_groups)
    counts = kernels.bincount(ids, None, spare + 1)[:spare].view(num_groups, 4)
    return counts[:, 0], counts[:, 1], counts[:, 2], counts[:, 3]


def _groups_stat_rates(tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> Tensor:
    """[G, 4] rates: each group's (tp, fp, tn, fn) over the group's support."""
    stats = torch.stack([tp, fp, tn, fn], dim=-1).to(torch.float32)
    support = stats.sum(dim=-1, keepdim=True)
    return safe_divide(stats, support)


def binary_groups_stat_rates(
    preds: Tensor,
    target: Tensor,
    groups: Tensor,
    num_groups: int,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, Tensor]:
    """Per-group tp/fp/tn/fn rates for binary classification."""
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, "global", ignore_index)
        _binary_stat_scores_tensor_validation(preds, target, "global", ignore_index)
        _groups_validation(groups, num_groups)
    groups = _groups_format(groups)
    preds, target, valid = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    tp, fp, tn, fn = _binary_groups_stat_scores_update(preds, target, groups, valid, num_groups)
    rates = _groups_stat_rates(tp, fp, tn, fn)
    return {f"group_{g}": rates[g] for g in range(num_groups)}


def _compute_binary_demographic_parity(tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> Dict[str, Tensor]:
    """min/max positivity-rate ratio; the key names the extreme groups."""
    pos_rates = safe_divide(tp + fp, tp + fp + tn + fn)
    min_g = int(torch.argmin(pos_rates))
    max_g = int(torch.argmax(pos_rates))
    return {f"DP_{min_g}_{max_g}": safe_divide(pos_rates[min_g], pos_rates[max_g])}


def demographic_parity(
    preds: Tensor,
    groups: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, Tensor]:
    """Demographic parity: ratio of the lowest to the highest group positivity rate."""
    groups = _groups_format(groups)
    num_groups = int(groups.max()) + 1
    target = torch.zeros_like(groups)
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, "global", ignore_index)
        _groups_validation(groups, num_groups)
    preds, target, valid = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    tp, fp, tn, fn = _binary_groups_stat_scores_update(preds, target, groups, valid, num_groups)
    return _compute_binary_demographic_parity(tp, fp, tn, fn)


def _compute_binary_equal_opportunity(tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> Dict[str, Tensor]:
    """min/max true-positive-rate ratio; the key names the extreme groups."""
    tpr = safe_divide(tp, tp + fn)
    min_g = int(torch.argmin(tpr))
    max_g = int(torch.argmax(tpr))
    return {f"EO_{min_g}_{max_g}": safe_divide(tpr[min_g], tpr[max_g])}


def equal_opportunity(
    preds: Tensor,
    target: Tensor,
    groups: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, Tensor]:
    """Equal opportunity: ratio of the lowest to the highest group true-positive rate."""
    groups = _groups_format(groups)
    num_groups = int(groups.max()) + 1
    if validate_args:
        _binary_stat_scores_arg_validation(threshold, "global", ignore_index)
        _binary_stat_scores_tensor_validation(preds, target, "global", ignore_index)
        _groups_validation(groups, num_groups)
    preds, target, valid = _binary_stat_scores_format(preds, target, threshold, ignore_index)
    tp, fp, tn, fn = _binary_groups_stat_scores_update(preds, target, groups, valid, num_groups)
    return _compute_binary_equal_opportunity(tp, fp, tn, fn)


def binary_fairness(
    preds: Tensor,
    target: Tensor,
    groups: Tensor,
    task: str = "all",
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Dict[str, Tensor]:
    """Demographic parity and/or equal opportunity, per ``task``.

    ``task``: ``'demographic_parity' | 'equal_opportunity' | 'all'``.
    """
    if task not in ("demographic_parity", "equal_opportunity", "all"):
        raise ValueError(
            f"Expected argument `task` to either be 'demographic_parity', 'equal_opportunity' or 'all' but got {task}."
        )
    if task == "demographic_parity":
        return demographic_parity(preds, groups, threshold, ignore_index, validate_args)
    if task == "equal_opportunity":
        return equal_opportunity(preds, target, groups, threshold, ignore_index, validate_args)
    return {
        **demographic_parity(preds, groups, threshold, ignore_index, validate_args),
        **equal_opportunity(preds, target, groups, threshold, ignore_index, validate_args),
    }
