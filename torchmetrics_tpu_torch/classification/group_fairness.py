"""Group-fairness module classes (``BinaryGroupStatRates``, ``BinaryFairness``).

Counterpart of ``torchmetrics_tpu/classification/group_fairness.py``: int32 per-group
``tp``/``fp``/``tn``/``fn`` states of ``[G]``, counted by one bincount kernel launch an
update.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.functional.classification.group_fairness import (
    _binary_groups_stat_scores_update,
    _compute_binary_demographic_parity,
    _compute_binary_equal_opportunity,
    _groups_format,
    _groups_stat_rates,
    _groups_validation,
)
from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _binary_stat_scores_arg_validation,
    _binary_stat_scores_format,
    _binary_stat_scores_tensor_validation,
)

Tensor = torch.Tensor


class _AbstractGroupStatScores(Metric):
    """Per-group tp/fp/tn/fn states ([G] each, summed across ranks)."""

    tp: Tensor
    fp: Tensor
    tn: Tensor
    fn: Tensor

    def _create_states(self, num_groups: int) -> None:
        for name in ("tp", "fp", "tn", "fn"):
            self.add_state(name, torch.zeros(num_groups, dtype=torch.int32), dist_reduce_fx="sum")

    def _update_states(self, preds: Tensor, target: Tensor, groups: Tensor, valid: Tensor) -> None:
        tp, fp, tn, fn = _binary_groups_stat_scores_update(preds, target, groups, valid, self.num_groups)
        self.tp = self.tp + tp
        self.fp = self.fp + fp
        self.tn = self.tn + tn
        self.fn = self.fn + fn


class BinaryGroupStatRates(_AbstractGroupStatScores):
    """Per-group true/false positive/negative rates for binary classification."""

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False

    def __init__(
        self,
        num_groups: int,
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if validate_args:
            _binary_stat_scores_arg_validation(threshold, "global", ignore_index)
            if not isinstance(num_groups, int) or num_groups < 2:
                raise ValueError(f"Expected argument `num_groups` to be an int larger than 1, but got {num_groups}")
        self.num_groups = num_groups
        self.threshold = threshold
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_states(num_groups)

    def update(self, preds: Tensor, target: Tensor, groups: Tensor) -> None:
        """Accumulate per-group counts; ``groups`` holds the group index per sample."""
        if self.validate_args:
            _binary_stat_scores_tensor_validation(preds, target, "global", self.ignore_index)
            _groups_validation(groups, self.num_groups)
        groups = _groups_format(groups)
        preds, target, valid = _binary_stat_scores_format(preds, target, self.threshold, self.ignore_index)
        self._update_states(preds, target, groups, valid)

    def compute(self) -> Dict[str, Tensor]:
        """Per-group [tp, fp, tn, fn] rates."""
        rates = _groups_stat_rates(self.tp, self.fp, self.tn, self.fn)
        return {f"group_{g}": rates[g] for g in range(self.num_groups)}


class BinaryFairness(_AbstractGroupStatScores):
    """Demographic parity / equal opportunity ratios between groups."""

    is_differentiable = False
    higher_is_better = None
    full_state_update: bool = False

    def __init__(
        self,
        num_groups: int,
        task: str = "all",
        threshold: float = 0.5,
        ignore_index: Optional[int] = None,
        validate_args: bool = True,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        if task not in ("demographic_parity", "equal_opportunity", "all"):
            raise ValueError(
                f"Expected argument `task` to either be 'demographic_parity', 'equal_opportunity' or 'all'"
                f" but got {task}."
            )
        if validate_args:
            _binary_stat_scores_arg_validation(threshold, "global", ignore_index)
            if not isinstance(num_groups, int) or num_groups < 2:
                raise ValueError(f"Expected argument `num_groups` to be an int larger than 1, but got {num_groups}")
        self.num_groups = num_groups
        self.task = task
        self.threshold = threshold
        self.ignore_index = ignore_index
        self.validate_args = validate_args
        self._create_states(num_groups)

    def update(self, preds: Tensor, target: Tensor, groups: Tensor) -> None:
        """Accumulate per-group counts (``target`` ignored for pure demographic parity)."""
        if self.task == "demographic_parity":  # the target is accepted and ignored
            target = torch.zeros_like(_groups_format(groups))
        if self.validate_args:
            _binary_stat_scores_tensor_validation(preds, target, "global", self.ignore_index)
            _groups_validation(groups, self.num_groups)
        groups = _groups_format(groups)
        preds, target, valid = _binary_stat_scores_format(preds, target, self.threshold, self.ignore_index)
        self._update_states(preds, target, groups, valid)

    def compute(self) -> Dict[str, Tensor]:
        """Fairness ratios keyed by the extreme groups."""
        if self.task == "demographic_parity":
            return _compute_binary_demographic_parity(self.tp, self.fp, self.tn, self.fn)
        if self.task == "equal_opportunity":
            return _compute_binary_equal_opportunity(self.tp, self.fp, self.tn, self.fn)
        return {
            **_compute_binary_demographic_parity(self.tp, self.fp, self.tn, self.fn),
            **_compute_binary_equal_opportunity(self.tp, self.fp, self.tn, self.fn),
        }
