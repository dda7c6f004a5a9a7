"""Levenshtein edit distance.

Counterpart of ``torchmetrics_tpu/functional/text/edit.py``. Distances and their sums
are int32, as JAX's are.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from torchmetrics_tpu_torch.functional.text.helper import _edit_distance_cost
from torchmetrics_tpu_torch.utils.checks import _resolve_device

Tensor = torch.Tensor


def _edit_distance_update(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    substitution_cost: int = 1,
    device: Union[str, torch.device] = "cpu",
) -> Tensor:
    """Per-sample edit distances."""
    if isinstance(preds, str):
        preds = [preds]
    if isinstance(target, str):
        target = [target]
    if not all(isinstance(x, str) for x in preds):
        raise ValueError(f"Expected all values in argument `preds` to be string type, but got {preds}")
    if not all(isinstance(x, str) for x in target):
        raise ValueError(f"Expected all values in argument `target` to be string type, but got {target}")
    if len(preds) != len(target):
        raise ValueError(
            f"Expected argument `preds` and `target` to have same length, but got {len(preds)} and {len(target)}"
        )
    distance = [
        _edit_distance_cost(list(p), list(t), substitution_cost=substitution_cost)
        for p, t in zip(preds, target)
    ]
    return torch.tensor(distance, dtype=torch.int32, device=device)


def _edit_distance_compute(
    edit_scores: Tensor,
    num_elements: Union[Tensor, int],
    reduction: Optional[str] = "mean",
) -> Tensor:
    """Reduce per-sample edit distances."""
    if edit_scores.numel() == 0:
        return torch.zeros((), dtype=torch.int32, device=edit_scores.device)
    if reduction == "mean":
        return edit_scores.sum(dtype=torch.int32) / num_elements
    if reduction == "sum":
        return edit_scores.sum(dtype=torch.int32)
    if reduction is None or reduction == "none":
        return edit_scores
    raise ValueError("Expected argument `reduction` to either be 'sum', 'mean', 'none' or None")


def edit_distance(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    substitution_cost: int = 1,
    reduction: Optional[str] = "mean",
    device: Union[str, torch.device] = "cuda",
) -> Tensor:
    """Compute the Levenshtein edit distance between text sequences, on ``device``.

    Example:
        >>> from torchmetrics_tpu_torch.functional.text import edit_distance
        >>> edit_distance(["rain"], ["shine"], device="cpu")
        tensor(3.)
    """
    distance = _edit_distance_update(preds, target, substitution_cost, _resolve_device(device))
    return _edit_distance_compute(distance, num_elements=distance.numel(), reduction=reduction)
