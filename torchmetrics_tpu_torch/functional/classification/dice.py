"""Dice score (the legacy classification metric).

Counterpart of ``torchmetrics_tpu/functional/classification/dice.py``: the input mode
(binary probabilities or labels, multiclass probabilities or labels, multilabel
probabilities) is inferred from shapes and dtypes as the legacy input engine did;
binary inputs count only the positive class; macro skips classes with no tp+fp+fn.
Counts are one-hot sums, kept in float32 as the JAX package keeps them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torchmetrics_tpu_torch.functional.classification.stat_scores import _is_traced, _maybe_apply_sigmoid
from torchmetrics_tpu_torch.utils.data import first_argmax, one_hot, safe_divide, select_topk

Tensor = torch.Tensor


def _dice_format_onehot(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    multiclass: Optional[bool] = None,
) -> Tuple[Tensor, Tensor, bool]:
    """Convert any legacy input mode to one-hot [N, C, X] pairs; returns (p, t, binary).

    ``multiclass=True`` counts binary-looking inputs as 2-class one-hots;
    ``multiclass=False`` sends same-shape inputs down the positives-only path. The
    largest label is read back to the host eagerly, as the JAX package reads it outside
    jit; while a CUDA graph capture records, it is not read, as under jit.
    """
    binary = False
    if preds.is_floating_point() and preds.ndim == target.ndim + 1:
        if multiclass is False:
            raise ValueError(
                "You can not use `multiclass=False` with `preds` carrying an extra class"
                " dimension over `target`."
            )
        # multiclass probabilities [N, C, ...]
        num_classes = num_classes or preds.shape[1]
        if top_k and top_k > 1:
            p_oh = select_topk(preds.reshape(preds.shape[0], preds.shape[1], -1), topk=top_k, dim=1)
        else:
            p_oh = one_hot(first_argmax(preds, dim=1), num_classes, dim=1)
            p_oh = p_oh.reshape(p_oh.shape[0], num_classes, -1)
        t_oh = one_hot(target, num_classes, dim=1).reshape(target.shape[0], num_classes, -1)
        return p_oh, t_oh, binary
    if preds.is_floating_point():
        # binary (or multilabel) probabilities, same shape as target
        preds = (_maybe_apply_sigmoid(preds) > threshold).to(torch.int32)
        binary = preds.ndim == 1 or (num_classes in (None, 1, 2) and preds.ndim <= 2 and preds.shape == target.shape)
    int_max = None if _is_traced(preds, target) else int(max(int(preds.max()), int(target.max())))
    if num_classes is None:
        num_classes = 2 if (binary or (int_max is not None and int_max <= 1)) else (int_max or 1) + 1
    take_binary_path = (
        num_classes <= 2 and preds.shape == target.shape and (int_max is None or int_max <= 1)
    )
    if multiclass is True:
        take_binary_path = False
        num_classes = max(num_classes, 2)
    elif multiclass is False:
        take_binary_path = preds.shape == target.shape
        if not take_binary_path:
            raise ValueError("`multiclass=False` requires `preds` and `target` of the same shape.")
    if take_binary_path:
        # binary labels: count only the positive class
        p = preds.reshape(preds.shape[0], 1, -1).to(torch.int32)
        t = target.reshape(target.shape[0], 1, -1).to(torch.int32)
        return p, t, True
    p_oh = one_hot(preds, num_classes, dim=1).reshape(preds.shape[0], num_classes, -1)
    t_oh = one_hot(target, num_classes, dim=1).reshape(target.shape[0], num_classes, -1)
    return p_oh, t_oh, False


def _dice_update(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    ignore_index: Optional[int] = None,
    top_k: Optional[int] = None,
    num_classes: Optional[int] = None,
    samplewise: bool = False,
    multiclass: Optional[bool] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """(tp, fp, fn): [C] (global) or [N, C] (samplewise) from one-hot pairs."""
    p_oh, t_oh, binary = _dice_format_onehot(preds, target, threshold, top_k, num_classes, multiclass)
    dims = (0, 2) if not samplewise else (2,)
    p = p_oh == 1
    t = t_oh == 1
    tp = (p & t).sum(dim=dims, dtype=torch.int32).to(torch.float32)
    fp = (p & (t_oh == 0)).sum(dim=dims, dtype=torch.int32).to(torch.float32)
    fn = ((p_oh == 0) & t).sum(dim=dims, dtype=torch.int32).to(torch.float32)
    if ignore_index is not None and not binary:
        keep = torch.arange(tp.shape[-1], device=tp.device) != ignore_index
        tp, fp, fn = (torch.where(keep, x, torch.zeros_like(x)) for x in (tp, fp, fn))
    return tp, fp, fn


def _dice_compute(
    tp: Tensor,
    fp: Tensor,
    fn: Tensor,
    average: Optional[str] = "micro",
    zero_division: float = 0.0,
) -> Tensor:
    numerator = 2 * tp
    denominator = 2 * tp + fp + fn
    if average == "micro":
        return safe_divide(numerator.sum(dim=-1), denominator.sum(dim=-1), zero_division)
    scores = safe_divide(numerator, denominator, zero_division)
    if average == "macro":
        present = (tp + fp + fn) > 0
        return safe_divide(
            torch.where(present, scores, torch.zeros_like(scores)).sum(dim=-1), present.sum(dim=-1, dtype=torch.int32)
        )
    if average == "samples":
        # samplewise [N, C] counts: per-sample micro, then the mean
        per_sample = safe_divide(numerator.sum(dim=-1), denominator.sum(dim=-1), zero_division)
        return per_sample.mean()
    return scores  # 'none'


def dice(
    preds: Tensor,
    target: Tensor,
    zero_division: float = 0.0,
    average: Optional[str] = "micro",
    mdmc_average: Optional[str] = "global",
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    top_k: Optional[int] = None,
    multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """Dice score: ``2·tp / (2·tp + fp + fn)``."""
    allowed_average = ("micro", "macro", "weighted", "samples", "none", None)
    if average not in allowed_average:
        raise ValueError(f"The `average` has to be one of {allowed_average}, got {average}.")
    samplewise = average == "samples" or mdmc_average == "samplewise"
    tp, fp, fn = _dice_update(
        preds, target, threshold, ignore_index, top_k, num_classes, samplewise=samplewise,
        multiclass=multiclass,
    )
    if average == "weighted":
        scores = safe_divide(2 * tp, 2 * tp + fp + fn, zero_division)
        weights = tp + fn
        return safe_divide((scores * weights).sum(dim=-1), weights.sum(dim=-1))
    res = _dice_compute(tp, fp, fn, average, zero_division)
    if mdmc_average == "samplewise" and average != "samples" and res.ndim >= 1:
        res = res.mean(dim=0)
    return res
