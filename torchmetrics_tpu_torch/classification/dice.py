"""Dice module class.

Counterpart of ``torchmetrics_tpu/classification/dice.py``: float32 ``tp``/``fp``/``fn``
count states, or ``cat`` lists for samplewise averaging.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.functional.classification.dice import _dice_compute, _dice_update
from torchmetrics_tpu_torch.utils.data import dim_zero_cat, safe_divide

Tensor = torch.Tensor


class Dice(Metric):
    """Dice score: ``2·tp / (2·tp + fp + fn)``."""

    is_differentiable = False
    higher_is_better = True
    full_state_update: bool = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        zero_division: float = 0.0,
        num_classes: Optional[int] = None,
        threshold: float = 0.5,
        average: Optional[str] = "micro",
        mdmc_average: Optional[str] = "global",
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        multiclass: Optional[bool] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        allowed_average = ("micro", "macro", "weighted", "samples", "none", None)
        if average not in allowed_average:
            raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")
        if mdmc_average not in (None, "samplewise", "global"):
            raise ValueError(f"The `mdmc_average` has to be one of (None, 'samplewise', 'global'), got {mdmc_average}.")
        if average in ("macro", "weighted", "none", None) and (not num_classes or num_classes < 1):
            raise ValueError(f"When you set `average` as {average}, you have to provide the number of classes.")
        self.zero_division = zero_division
        self.num_classes = num_classes
        self.threshold = threshold
        self.average = average
        self.mdmc_average = mdmc_average
        self.ignore_index = ignore_index
        self.top_k = top_k
        self.multiclass = multiclass
        if num_classes is None:
            # class-count inference reads values back to the host: not capturable
            self._jit_update_flag = False
        self._samplewise = average == "samples" or mdmc_average == "samplewise"
        if self._samplewise:
            for name in ("tp", "fp", "fn"):
                self.add_state(name, [], dist_reduce_fx="cat")
        else:
            size = num_classes if num_classes else 1
            for name in ("tp", "fp", "fn"):
                self.add_state(name, torch.zeros(size, dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate tp/fp/fn counts."""
        tp, fp, fn = _dice_update(
            preds, target, self.threshold, self.ignore_index, self.top_k, self.num_classes,
            samplewise=self._samplewise, multiclass=self.multiclass,
        )
        if self._samplewise:
            self.tp.append(tp)
            self.fp.append(fp)
            self.fn.append(fn)
        else:
            if self.average == "micro" and self.num_classes is None:
                # micro sums over classes anyway: fold the class axis into the
                # 1-element state so unknown-C inputs accumulate correctly
                tp, fp, fn = tp.sum().reshape(1), fp.sum().reshape(1), fn.sum().reshape(1)
            self.tp = self.tp + tp
            self.fp = self.fp + fp
            self.fn = self.fn + fn

    def compute(self) -> Tensor:
        """Dice score under the configured averaging."""
        if self._samplewise:
            tp, fp, fn = dim_zero_cat(self.tp), dim_zero_cat(self.fp), dim_zero_cat(self.fn)
        else:
            tp, fp, fn = self.tp, self.fp, self.fn
        if self.average == "weighted":
            scores = safe_divide(2 * tp, 2 * tp + fp + fn, self.zero_division)
            weights = tp + fn
            return safe_divide((scores * weights).sum(dim=-1), weights.sum(dim=-1))
        res = _dice_compute(tp, fp, fn, self.average, self.zero_division)
        if self.mdmc_average == "samplewise" and self.average != "samples" and res.ndim >= 1:
            res = res.mean(dim=0)
        return res
