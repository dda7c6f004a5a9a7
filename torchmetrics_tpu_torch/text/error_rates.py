"""Edit-distance-based text metric modules: WER, CER, MER, WIL, WIP, EditDistance.

Counterpart of ``torchmetrics_tpu/text/error_rates.py``: the same states (float32
counters; ``EditDistance``'s int32 sums, or its ``cat`` list of int32 distances under
``reduction="none"``), each update's counters made on the host and added on the
metric's device.
"""

from __future__ import annotations

from typing import Any, List, Optional, Union

import torch

from torchmetrics_tpu_torch.functional.text.cer import _cer_compute, _cer_update
from torchmetrics_tpu_torch.functional.text.edit import _edit_distance_compute, _edit_distance_update
from torchmetrics_tpu_torch.functional.text.mer import _mer_compute, _mer_update
from torchmetrics_tpu_torch.functional.text.wer import _wer_compute, _wer_update
from torchmetrics_tpu_torch.functional.text.wil import _word_info_lost_compute, _word_info_lost_update
from torchmetrics_tpu_torch.functional.text.wip import _wip_compute, _wip_update
from torchmetrics_tpu_torch.text._base import _TextMetric
from torchmetrics_tpu_torch.utils.data import dim_zero_cat

Tensor = torch.Tensor


class WordErrorRate(_TextMetric):
    r"""Word error rate of transcriptions.

    Example:
        >>> from torchmetrics_tpu_torch.text import WordErrorRate
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> wer = WordErrorRate(device="cpu")
        >>> wer(preds, target)
        tensor(0.5000)
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    errors: Tensor
    total: Tensor

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        """Accumulate word-level edit operations and reference words."""
        errors, total = _wer_update(preds, target, self.device)
        self.errors = self.errors + errors
        self.total = self.total + total

    def compute(self) -> Tensor:
        """WER over accumulated state."""
        return _wer_compute(self.errors, self.total)


class CharErrorRate(_TextMetric):
    r"""Character error rate of transcriptions.

    Example:
        >>> from torchmetrics_tpu_torch.text import CharErrorRate
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> cer = CharErrorRate(device="cpu")
        >>> cer(preds, target).round(decimals=4)
        tensor(0.3415)
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    errors: Tensor
    total: Tensor

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        """Accumulate character-level edit operations and reference chars."""
        errors, total = _cer_update(preds, target, self.device)
        self.errors = self.errors + errors
        self.total = self.total + total

    def compute(self) -> Tensor:
        """CER over accumulated state."""
        return _cer_compute(self.errors, self.total)


class MatchErrorRate(_TextMetric):
    r"""Match error rate of transcriptions.

    Example:
        >>> from torchmetrics_tpu_torch.text import MatchErrorRate
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> mer = MatchErrorRate(device="cpu")
        >>> mer(preds, target).round(decimals=4)
        tensor(0.4444)
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    errors: Tensor
    total: Tensor

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        """Accumulate edit operations and max-length totals."""
        errors, total = _mer_update(preds, target, self.device)
        self.errors = self.errors + errors
        self.total = self.total + total

    def compute(self) -> Tensor:
        """MER over accumulated state."""
        return _mer_compute(self.errors, self.total)


class WordInfoLost(_TextMetric):
    r"""Word information lost of transcriptions.

    Example:
        >>> from torchmetrics_tpu_torch.text import WordInfoLost
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> wil = WordInfoLost(device="cpu")
        >>> wil(preds, target).round(decimals=4)
        tensor(0.6528)
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    errors: Tensor
    target_total: Tensor
    preds_total: Tensor

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("target_total", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("preds_total", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        """Accumulate hit counts and word totals."""
        errors, target_total, preds_total = _word_info_lost_update(preds, target, self.device)
        self.errors = self.errors + errors
        self.target_total = self.target_total + target_total
        self.preds_total = self.preds_total + preds_total

    def compute(self) -> Tensor:
        """WIL over accumulated state."""
        return _word_info_lost_compute(self.errors, self.target_total, self.preds_total)


class WordInfoPreserved(_TextMetric):
    r"""Word information preserved of transcriptions.

    Example:
        >>> from torchmetrics_tpu_torch.text import WordInfoPreserved
        >>> preds = ["this is the prediction", "there is an other sample"]
        >>> target = ["this is the reference", "there is another one"]
        >>> wip = WordInfoPreserved(device="cpu")
        >>> wip(preds, target).round(decimals=4)
        tensor(0.3472)
    """

    is_differentiable = False
    higher_is_better = False  # matches the reference metadata (its value, odd as it is)
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    errors: Tensor
    target_total: Tensor
    preds_total: Tensor

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("errors", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("target_total", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("preds_total", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        """Accumulate hit counts and word totals."""
        errors, target_total, preds_total = _wip_update(preds, target, self.device)
        self.errors = self.errors + errors
        self.target_total = self.target_total + target_total
        self.preds_total = self.preds_total + preds_total

    def compute(self) -> Tensor:
        """WIP over accumulated state."""
        return _wip_compute(self.errors, self.target_total, self.preds_total)


class EditDistance(_TextMetric):
    r"""Levenshtein edit distance between text sequences.

    Example:
        >>> from torchmetrics_tpu_torch.text import EditDistance
        >>> metric = EditDistance(device="cpu")
        >>> metric(["rain"], ["shine"])
        tensor(3.)
    """

    is_differentiable = False
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    def __init__(
        self, substitution_cost: int = 1, reduction: Optional[str] = "mean", **kwargs: Any
    ) -> None:
        super().__init__(**kwargs)
        if not (isinstance(substitution_cost, int) and substitution_cost >= 0):
            raise ValueError(
                f"Expected argument `substitution_cost` to be a positive integer, but got {substitution_cost}"
            )
        allowed_reduction = (None, "mean", "sum", "none")
        if reduction not in allowed_reduction:
            raise ValueError(f"Expected argument `reduction` to be one of {allowed_reduction}, but got {reduction}")
        self.substitution_cost = substitution_cost
        self.reduction = reduction

        if self.reduction == "none" or self.reduction is None:
            self.add_state("edit_scores_list", [], dist_reduce_fx="cat")
        else:
            self.add_state("edit_scores", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")
            self.add_state("num_elements", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Union[str, List[str]], target: Union[str, List[str]]) -> None:
        """Accumulate per-sample edit distances (or their sum)."""
        distance = _edit_distance_update(preds, target, self.substitution_cost, self.device)
        if self.reduction == "none" or self.reduction is None:
            self.edit_scores_list.append(distance)
        else:
            self.edit_scores = self.edit_scores + distance.sum(dtype=torch.int32)
            self.num_elements = self.num_elements + distance.numel()

    def compute(self) -> Tensor:
        """Edit distance over accumulated state."""
        if self.reduction == "none" or self.reduction is None:
            return _edit_distance_compute(dim_zero_cat(self.edit_scores_list), 1, self.reduction)
        return _edit_distance_compute(self.edit_scores, self.num_elements, self.reduction)
