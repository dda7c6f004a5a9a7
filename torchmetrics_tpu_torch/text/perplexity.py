"""Perplexity module.

Counterpart of ``torchmetrics_tpu/text/perplexity.py``. Its inputs are tensors, so
unlike its string-input siblings its update captures into a CUDA graph with
``jit_update=True``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.functional.text.perplexity import _perplexity_compute, _perplexity_update

Tensor = torch.Tensor


class Perplexity(Metric):
    r"""Perplexity of a language model's predictions.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.text import Perplexity
        >>> g = torch.Generator().manual_seed(22)
        >>> preds = torch.rand(2, 8, 5, generator=g)
        >>> target = torch.randint(0, 5, (2, 8), generator=g)
        >>> perp = Perplexity(ignore_index=-100, device="cpu")
        >>> float(perp(preds, target)) > 1
        True
    """

    is_differentiable = True
    higher_is_better = False
    full_state_update = False
    plot_lower_bound: float = 0.0

    total_log_probs: Tensor
    count: Tensor

    def __init__(self, ignore_index: Optional[int] = None, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError(f"Argument `ignore_index` expected to either be `None` or an `int` but got {ignore_index}")
        self.ignore_index = ignore_index
        self.add_state("total_log_probs", torch.zeros(()), dist_reduce_fx="sum")
        self.add_state("count", torch.zeros(()), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate token NLL sums and valid-token counts."""
        total_log_probs, count = _perplexity_update(preds, target, self.ignore_index)
        self.total_log_probs = self.total_log_probs + total_log_probs
        self.count = self.count + count

    def compute(self) -> Tensor:
        """Perplexity over accumulated state."""
        return _perplexity_compute(self.total_log_probs, self.count)

    def _compute_group_params(self):
        return (self.ignore_index,)
