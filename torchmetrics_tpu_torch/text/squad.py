"""SQuAD module.

Counterpart of ``torchmetrics_tpu/text/squad.py``: float32 ``f1_score`` and
``exact_match`` sums and an int32 ``total``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from torchmetrics_tpu_torch.functional.text.squad import (
    PREDS_TYPE,
    TARGETS_TYPE,
    _squad_compute,
    _squad_input_check,
    _squad_update,
)
from torchmetrics_tpu_torch.text._base import _TextMetric

Tensor = torch.Tensor


class SQuAD(_TextMetric):
    r"""SQuAD v1.1 exact-match / F1 metric.

    Example:
        >>> from torchmetrics_tpu_torch.text import SQuAD
        >>> preds = [{"prediction_text": "1976", "id": "56e10a3be3433e1400422b22"}]
        >>> target = [{"answers": {"answer_start": [97], "text": ["1976"]},
        ...            "id": "56e10a3be3433e1400422b22"}]
        >>> sq = SQuAD(device="cpu")
        >>> {k: float(v) for k, v in sq(preds, target).items()}
        {'exact_match': 100.0, 'f1': 100.0}
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 100.0

    f1_score: Tensor
    exact_match: Tensor
    total: Tensor

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.add_state("f1_score", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("exact_match", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("total", torch.zeros((), dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: PREDS_TYPE, target: TARGETS_TYPE) -> None:
        """Accumulate F1/EM sums and example counts."""
        preds_dict, target_dict = _squad_input_check(preds, target)
        f1, exact_match, total = _squad_update(preds_dict, target_dict, self.device)
        self.f1_score = self.f1_score + f1
        self.exact_match = self.exact_match + exact_match
        self.total = self.total + total

    def compute(self) -> Dict[str, Tensor]:
        """Percent EM/F1 over accumulated state."""
        return _squad_compute(self.f1_score, self.exact_match, self.total)
