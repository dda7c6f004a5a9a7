"""Precision-recall curve core: binary, multiclass and multilabel, plus task dispatch.

Counterpart of ``torchmetrics_tpu/functional/classification/precision_recall_curve.py``;
the ROC and AUROC family derive from the state computed here.

- **Binned mode** (``thresholds`` given): the state is a static ``[T, 2, 2]`` (binary)
  or ``[T, C, 2, 2]`` (multiclass, multilabel) int32 confusion accumulator. The binary
  update's per-threshold counts come from the hand-written CUDA kernel for tensors on
  the card (``ops.kernels.binned_curve_counts``) at every T; the multiclass and
  multilabel updates are a plain ``einsum``, as they are plain XLA in the JAX package.
- **Unbinned mode** (``thresholds=None``): sort, cumsum and de-duplicated thresholds,
  with data-dependent shapes (the module classes keep list states for it).

The default threshold grid is bitwise the JAX package's ``jnp.linspace(0, 1, T)``
(``torch.linspace`` differs from it in the last bit for many T, and a threshold one
ulp off flips ``score >= thr`` at ties). A macro-averaged curve interpolates each
class's recall onto the sorted union of precisions with ``utils.data.interp``, which
brackets as ``jnp.interp`` does on a precision curve, which is not monotone.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.classification.stat_scores import (
    _is_traced,
    _maybe_apply_sigmoid,
    _unique_values,
)
from torchmetrics_tpu_torch.ops import kernels
from torchmetrics_tpu_torch.utils.data import interp, one_hot, safe_divide
from torchmetrics_tpu_torch.utils.enums import ClassificationTask

Tensor = torch.Tensor

CurveState = Union[Tensor, Tuple[Tensor, Tensor, Tensor]]


def _linspace_thresholds(num: int) -> Tensor:
    """``num`` float32 thresholds from 0 to 1, bitwise equal to ``jnp.linspace(0., 1., num)``.

    XLA computes ``i / (num-1)`` as ``i * fl32(1/(num-1))`` and then sets the last
    value to exactly 1.0; this repeats that arithmetic on the CPU.
    """
    step = float(np.float32(1.0) / np.float32(num - 1))
    return torch.cat([torch.arange(num - 1, dtype=torch.float32) * step, torch.ones(1)])


def _adjust_threshold_arg(
    thresholds: Union[int, Sequence[float], Tensor, None], device: Union[str, torch.device, None] = None
) -> Optional[Tensor]:
    """Convert the ``thresholds`` argument to a tensor on ``device`` (or None for unbinned)."""
    if thresholds is None:
        return None
    if isinstance(thresholds, int):
        thresholds = _linspace_thresholds(thresholds)
    elif isinstance(thresholds, (list, tuple)):
        thresholds = torch.tensor(thresholds, dtype=torch.float32)
    return torch.as_tensor(thresholds, device=device)


def _validate_thresholds_arg(thresholds) -> None:
    if thresholds is not None and not isinstance(thresholds, (int, list, tuple, Tensor)):
        raise ValueError(
            "Expected argument `thresholds` to either be an integer, list of floats or a tensor of floats,"
            f" but got {thresholds}"
        )
    if isinstance(thresholds, int) and thresholds < 2:
        raise ValueError(f"If argument `thresholds` is an integer, expected it to be larger than 1, but got {thresholds}")
    if isinstance(thresholds, (list, tuple)) and not all(isinstance(t, float) and 0 <= t <= 1 for t in thresholds):
        raise ValueError(
            f"If argument `thresholds` is a list, expected all elements to be floats in the [0,1] range, but got {thresholds}"
        )


def _maybe_softmax(preds: Tensor, dim: int = -1) -> Tensor:
    needs = (preds.min() < 0) | (preds.max() > 1)
    return torch.where(needs, torch.softmax(preds, dim=dim), preds)


def _stack_confmat(tns: Tensor, fps: Tensor, fns: Tensor, tps: Tensor) -> Tensor:
    """int32 ``[..., 2, 2]`` with layout ``[target, pred]``."""
    return torch.stack(
        [torch.stack([tns, fps], dim=-1), torch.stack([fns, tps], dim=-1)], dim=-2
    ).to(torch.int32)


# ----------------------------------------------------------------------- clf curve


def _binary_clf_curve(
    preds: Tensor,
    target: Tensor,
    sample_weights: Optional[Tensor] = None,
    pos_label: int = 1,
) -> Tuple[Tensor, Tensor, Tensor]:
    """fps/tps/thresholds at distinct prediction values (sklearn semantics)."""
    weight = torch.ones_like(preds, dtype=torch.float32) if sample_weights is None else sample_weights
    desc = torch.argsort(preds, stable=True).flip(0)
    preds = preds[desc]
    target = target[desc]
    weight = weight[desc]

    distinct = torch.nonzero(torch.diff(preds) != 0)[:, 0]
    threshold_idxs = torch.cat([distinct, torch.tensor([target.shape[0] - 1], device=preds.device)])

    target = (target == pos_label).to(torch.float32)
    tps = torch.cumsum(target * weight, dim=0)[threshold_idxs]
    fps = torch.cumsum((1 - target) * weight, dim=0)[threshold_idxs]
    return fps, tps, preds[threshold_idxs]


# --------------------------------------------------------------------------- binary


def _binary_precision_recall_curve_arg_validation(
    thresholds=None,
    ignore_index: Optional[int] = None,
) -> None:
    _validate_thresholds_arg(thresholds)
    if ignore_index is not None and not isinstance(ignore_index, int):
        raise ValueError(f"Expected argument `ignore_index` to either be `None` or an integer, but got {ignore_index}")


def _binary_precision_recall_curve_tensor_validation(
    preds: Tensor,
    target: Tensor,
    ignore_index: Optional[int] = None,
) -> None:
    if preds.shape != target.shape:
        raise ValueError(
            "The `preds` and `target` should have the same shape,"
            f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
        )
    if not preds.is_floating_point():
        raise ValueError("Expected argument `preds` to be a float tensor with probabilities/logits")
    if _is_traced(preds, target):
        return
    unique_values = _unique_values(target)
    allowed = {0, 1} if ignore_index is None else {0, 1, ignore_index}
    if not unique_values.issubset(allowed):
        raise RuntimeError(
            f"Detected the following values in `target`: {sorted(unique_values)} but expected only"
            f" the following values {sorted(allowed)}."
        )


def _binary_precision_recall_curve_format(
    preds: Tensor,
    target: Tensor,
    thresholds=None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor, Optional[Tensor]]:
    """Flatten, sigmoid-if-logits; returns (preds, target, valid, thresholds)."""
    preds = _maybe_apply_sigmoid(preds.reshape(-1))
    target = target.reshape(-1)
    valid = torch.ones_like(target, dtype=torch.bool) if ignore_index is None else target != ignore_index
    target = torch.where(valid, target, torch.zeros_like(target)).to(torch.int32)
    return preds, target, valid, _adjust_threshold_arg(thresholds, preds.device)


def _binary_precision_recall_curve_update(
    preds: Tensor,
    target: Tensor,
    valid: Tensor,
    thresholds: Optional[Tensor],
) -> CurveState:
    """Binned: int32 [T, 2, 2] confusion accumulator. Unbinned: the raw triple."""
    if thresholds is None:
        return preds, target, valid
    counts = kernels.binned_curve_counts(preds, target, valid, thresholds)
    tps, fps = counts[:, 0], counts[:, 1]
    pos = (valid & (target != 0)).sum(dtype=torch.int32)
    neg = (valid & (target == 0)).sum(dtype=torch.int32)
    return _stack_confmat(neg - fps, fps, pos - tps, tps)


def _binary_precision_recall_curve_compute(
    state: CurveState,
    thresholds: Optional[Tensor],
    pos_label: int = 1,
) -> Tuple[Tensor, Tensor, Tensor]:
    """(precision, recall, thresholds)."""
    if thresholds is not None and isinstance(state, Tensor):
        tps = state[:, 1, 1].to(torch.float32)
        fps = state[:, 0, 1].to(torch.float32)
        fns = state[:, 1, 0].to(torch.float32)
        precision = safe_divide(tps, tps + fps)
        recall = safe_divide(tps, tps + fns)
        precision = torch.cat([precision, torch.ones(1, dtype=precision.dtype, device=precision.device)])
        recall = torch.cat([recall, torch.zeros(1, dtype=recall.dtype, device=recall.device)])
        return precision, recall, thresholds
    preds, target, valid = state
    if _is_traced(preds, target, valid):
        return _binary_precision_recall_curve_static(preds, target, valid)
    preds, target = preds[valid], target[valid]
    fps, tps, thres = _binary_clf_curve(preds, target, pos_label=pos_label)
    precision = tps / (tps + fps)
    recall = tps / tps[-1]
    # stop once full recall is attained, reverse so recall is decreasing, close the
    # curve at (recall=0, precision=1)
    last_ind = int(torch.nonzero(tps == tps[-1])[0, 0])
    sl = slice(0, last_ind + 1)
    precision = torch.cat([precision[sl].flip(0), torch.ones(1, device=precision.device)])
    recall = torch.cat([recall[sl].flip(0), torch.zeros(1, device=recall.device)])
    return precision, recall, thres[sl].flip(0)


def _binary_precision_recall_curve_static(
    preds: Tensor, target: Tensor, valid: Tensor
) -> Tuple[Tensor, Tensor, Tensor]:
    """The unbinned curve with static shapes, for a compute that a CUDA graph records
    (JAX's jitted variant): one point per sample, no de-duplicated thresholds and no cut
    at full recall. An ignored sample weighs 0 and so makes a segment of zero width;
    with distinct scores this is the eager curve."""
    order = torch.argsort(preds, stable=True).flip(0)
    w = valid[order].to(torch.float32)
    t_s = target[order].to(torch.float32) * w
    tps = torch.cumsum(t_s, dim=0)
    fps = torch.cumsum(w, dim=0) - tps
    precision = safe_divide(tps, tps + fps)
    recall = safe_divide(tps, tps[-1])
    one = torch.ones(1, device=preds.device)
    return (torch.cat([precision.flip(0), one]), torch.cat([recall.flip(0), torch.zeros_like(one)]),
            preds[order].flip(0))


def binary_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Precision-recall pairs as the decision threshold varies."""
    if validate_args:
        _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)
        _binary_precision_recall_curve_tensor_validation(preds, target, ignore_index)
    preds, target, valid, thresholds = _binary_precision_recall_curve_format(
        preds, target, thresholds, ignore_index
    )
    state = _binary_precision_recall_curve_update(preds, target, valid, thresholds)
    return _binary_precision_recall_curve_compute(state, thresholds)


# ------------------------------------------------------------------------ multiclass


def _multiclass_precision_recall_curve_arg_validation(
    num_classes: int,
    thresholds=None,
    ignore_index: Optional[int] = None,
    average: Optional[str] = None,
) -> None:
    if not isinstance(num_classes, int) or num_classes < 2:
        raise ValueError(f"Expected argument `num_classes` to be an integer larger than 1, but got {num_classes}")
    if average not in (None, "micro", "macro"):
        raise ValueError(f"Expected argument `average` to be one of None, 'micro' or 'macro', but got {average}")
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)


def _multiclass_precision_recall_curve_tensor_validation(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    ignore_index: Optional[int] = None,
) -> None:
    if preds.ndim != target.ndim + 1:
        raise ValueError("Expected `preds` to have one more dimension than `target`")
    if not preds.is_floating_point():
        raise ValueError("Expected `preds` to be a float tensor with probabilities/logits")
    if preds.shape[1] != num_classes:
        raise ValueError(f"Expected `preds.shape[1]` to equal `num_classes` ({num_classes}), got {preds.shape[1]}")
    if preds.shape[0] != target.shape[0] or preds.shape[2:] != target.shape[1:]:
        raise ValueError("Expected shapes (N, C, ...) for `preds` and (N, ...) for `target`")
    if _is_traced(preds, target):
        return
    num_unique = len(torch.unique(target))
    check = num_classes if ignore_index is None else num_classes + 1
    if num_unique > check:
        raise RuntimeError(f"Detected more unique values in `target` than expected ({num_unique} > {check})")


def _multiclass_precision_recall_curve_format(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds=None,
    ignore_index: Optional[int] = None,
    average: Optional[str] = None,
) -> Tuple[Tensor, Tensor, Tensor, Optional[Tensor]]:
    """Returns (preds [N, C], target [N], valid [N], thresholds); flattened pairs for micro."""
    preds = _maybe_softmax(torch.movedim(preds, 1, -1).reshape(-1, num_classes), dim=-1)
    target = target.reshape(-1)
    valid = torch.ones_like(target, dtype=torch.bool) if ignore_index is None else target != ignore_index
    target = torch.where(valid, target, torch.zeros_like(target)).to(torch.int32)
    thresholds = _adjust_threshold_arg(thresholds, preds.device)
    if average == "micro":
        # the one-vs-rest decomposition flattened into ONE binary problem over (n, c) pairs
        target_oh = one_hot(target, num_classes)
        valid_b = valid[:, None].expand(preds.shape).reshape(-1)
        return preds.reshape(-1), target_oh.reshape(-1), valid_b, thresholds
    return preds, target, valid, thresholds


def _multiclass_precision_recall_curve_update(
    preds: Tensor,
    target: Tensor,
    valid: Tensor,
    num_classes: int,
    thresholds: Optional[Tensor],
) -> CurveState:
    """Binned: int32 [T, C, 2, 2] accumulator from two ``einsum`` contractions. Unbinned: the raw triple."""
    if thresholds is None:
        return preds, target, valid
    v = valid.to(torch.float32)[:, None]
    onehot = one_hot(target, num_classes, dtype=torch.float32)
    targ_oh = onehot * v  # [N, C]
    neg_oh = (1.0 - onehot) * v
    pge = (preds[:, :, None] >= thresholds[None, None, :]).to(torch.float32)  # [N, C, T]
    tps = torch.einsum("nct,nc->tc", pge, targ_oh)
    fps = torch.einsum("nct,nc->tc", pge, neg_oh)
    pos = targ_oh.sum(dim=0)  # [C]
    neg = neg_oh.sum(dim=0)
    return _stack_confmat(neg[None, :] - fps, fps, pos[None, :] - tps, tps)


def _pr_curve_macro_average(precision, recall, thres, num_classes: int):
    """Macro-average per-class PR curves: interpolate each class's recall onto the
    sorted union of precisions and average (binned: ``[C, T+1]`` tensors; unbinned:
    lists). ``interp`` brackets as ``jnp.interp`` does on these non-monotone curves."""
    if isinstance(precision, Tensor) and precision.ndim == 2:
        all_thres = torch.sort(thres.repeat(num_classes)).values
        mean_precision = torch.sort(precision.flatten()).values
        per_class = [interp(mean_precision, precision[i], recall[i]) for i in range(num_classes)]
    else:
        all_thres = torch.sort(torch.cat(thres)).values
        mean_precision = torch.sort(torch.cat(precision)).values
        per_class = [interp(mean_precision, p, r) for p, r in zip(precision, recall)]
    mean_recall = torch.stack(per_class).mean(dim=0)
    return mean_precision, mean_recall, all_thres


def _multiclass_precision_recall_curve_compute(
    state: CurveState,
    num_classes: int,
    thresholds: Optional[Tensor],
    average: Optional[str] = None,
):
    """(precision, recall, thresholds): tensors when binned, lists when unbinned."""
    if average == "micro":
        return _binary_precision_recall_curve_compute(state, thresholds)
    if thresholds is not None and isinstance(state, Tensor):
        tps = state[:, :, 1, 1].to(torch.float32)
        fps = state[:, :, 0, 1].to(torch.float32)
        fns = state[:, :, 1, 0].to(torch.float32)
        precision = safe_divide(tps, tps + fps)
        recall = safe_divide(tps, tps + fns)
        ones = torch.ones((1, num_classes), dtype=precision.dtype, device=precision.device)
        precision = torch.cat([precision, ones], dim=0).T
        recall = torch.cat([recall, torch.zeros_like(ones)], dim=0).T
        if average == "macro":
            return _pr_curve_macro_average(precision, recall, thresholds, num_classes)
        return precision, recall, thresholds
    preds, target, valid = state
    preds, target = preds[valid], target[valid]
    all_valid = torch.ones(target.shape[0], dtype=torch.bool, device=target.device)
    precisions, recalls, thresh = [], [], []
    for c in range(num_classes):
        p, r, t = _binary_precision_recall_curve_compute(
            (preds[:, c], (target == c).to(torch.int32), all_valid), None
        )
        precisions.append(p)
        recalls.append(r)
        thresh.append(t)
    if average == "macro":
        return _pr_curve_macro_average(precisions, recalls, thresh, num_classes)
    return precisions, recalls, thresh


def multiclass_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Per-class (one-vs-rest) precision-recall curves, or one micro-averaged curve."""
    if validate_args:
        _multiclass_precision_recall_curve_arg_validation(num_classes, thresholds, ignore_index, average)
        _multiclass_precision_recall_curve_tensor_validation(preds, target, num_classes, ignore_index)
    preds, target, valid, thresholds = _multiclass_precision_recall_curve_format(
        preds, target, num_classes, thresholds, ignore_index, average
    )
    if average == "micro":
        state = _binary_precision_recall_curve_update(preds, target, valid, thresholds)
        return _binary_precision_recall_curve_compute(state, thresholds)
    state = _multiclass_precision_recall_curve_update(preds, target, valid, num_classes, thresholds)
    return _multiclass_precision_recall_curve_compute(state, num_classes, thresholds, average)


# ------------------------------------------------------------------------ multilabel


def _multilabel_precision_recall_curve_arg_validation(
    num_labels: int,
    thresholds=None,
    ignore_index: Optional[int] = None,
) -> None:
    if not isinstance(num_labels, int) or num_labels < 2:
        raise ValueError(f"Expected argument `num_labels` to be an integer larger than 1, but got {num_labels}")
    _binary_precision_recall_curve_arg_validation(thresholds, ignore_index)


def _multilabel_precision_recall_curve_tensor_validation(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    ignore_index: Optional[int] = None,
) -> None:
    if preds.shape != target.shape:
        raise ValueError(
            "The `preds` and `target` should have the same shape,"
            f" got `preds` with shape={tuple(preds.shape)} and `target` with shape={tuple(target.shape)}."
        )
    if not preds.is_floating_point():
        raise ValueError("Expected `preds` to be a float tensor with probabilities/logits")
    if preds.ndim < 2 or preds.shape[1] != num_labels:
        raise ValueError("Expected `preds.shape[1]` to equal the number of labels")


def _multilabel_precision_recall_curve_format(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds=None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor, Optional[Tensor]]:
    """Returns (preds [N*X, L], target [N*X, L], valid [N*X, L], thresholds)."""
    preds = torch.movedim(preds.reshape(preds.shape[0], num_labels, -1), 1, -1).reshape(-1, num_labels)
    target = torch.movedim(target.reshape(target.shape[0], num_labels, -1), 1, -1).reshape(-1, num_labels)
    preds = _maybe_apply_sigmoid(preds)
    valid = torch.ones_like(target, dtype=torch.bool) if ignore_index is None else target != ignore_index
    target = torch.where(valid, target, torch.zeros_like(target)).to(torch.int32)
    return preds, target, valid, _adjust_threshold_arg(thresholds, preds.device)


def _multilabel_precision_recall_curve_update(
    preds: Tensor,
    target: Tensor,
    valid: Tensor,
    num_labels: int,
    thresholds: Optional[Tensor],
) -> CurveState:
    """Binned: int32 [T, L, 2, 2] accumulator from the [N, L, T] compare and two ``einsum``
    contractions (plain torch, as plain XLA in the JAX package). Unbinned: the raw triple."""
    if thresholds is None:
        return preds, target, valid
    v = valid.to(torch.float32)
    t1 = target.to(torch.float32) * v  # [N, L]
    t0 = (1.0 - target.to(torch.float32)) * v
    pge = (preds[:, :, None] >= thresholds[None, None, :]).to(torch.float32)  # [N, L, T]
    tps = torch.einsum("nlt,nl->tl", pge, t1)
    fps = torch.einsum("nlt,nl->tl", pge, t0)
    pos = t1.sum(dim=0)
    neg = t0.sum(dim=0)
    return _stack_confmat(neg[None, :] - fps, fps, pos[None, :] - tps, tps)


def _multilabel_precision_recall_curve_compute(
    state: CurveState,
    num_labels: int,
    thresholds: Optional[Tensor],
    ignore_index: Optional[int] = None,
):
    """(precision, recall, thresholds) per label: [L, T+1] tensors when binned, lists
    when unbinned."""
    if thresholds is not None and isinstance(state, Tensor):
        tps = state[:, :, 1, 1].to(torch.float32)
        fps = state[:, :, 0, 1].to(torch.float32)
        fns = state[:, :, 1, 0].to(torch.float32)
        precision = safe_divide(tps, tps + fps)
        recall = safe_divide(tps, tps + fns)
        ones = torch.ones((1, num_labels), dtype=precision.dtype, device=precision.device)
        precision = torch.cat([precision, ones], dim=0).T
        recall = torch.cat([recall, torch.zeros_like(ones)], dim=0).T
        return precision, recall, thresholds
    preds, target, valid = state
    precisions, recalls, thresh = [], [], []
    for label in range(num_labels):
        # each label's curve keeps its valid samples, or under a capture weighs the rest 0
        p, r, t = _binary_precision_recall_curve_compute((preds[:, label], target[:, label], valid[:, label]), None)
        precisions.append(p)
        recalls.append(r)
        thresh.append(t)
    return precisions, recalls, thresh


def multilabel_precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    num_labels: int,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Per-label precision-recall curves."""
    if validate_args:
        _multilabel_precision_recall_curve_arg_validation(num_labels, thresholds, ignore_index)
        _multilabel_precision_recall_curve_tensor_validation(preds, target, num_labels, ignore_index)
    preds, target, valid, thresholds = _multilabel_precision_recall_curve_format(
        preds, target, num_labels, thresholds, ignore_index
    )
    state = _multilabel_precision_recall_curve_update(preds, target, valid, num_labels, thresholds)
    return _multilabel_precision_recall_curve_compute(state, num_labels, thresholds, ignore_index)


# -------------------------------------------------------------------------- dispatch


def precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    task: str,
    thresholds: Union[int, Sequence[float], Tensor, None] = None,
    num_classes: Optional[int] = None,
    num_labels: Optional[int] = None,
    average: Optional[str] = None,
    ignore_index: Optional[int] = None,
    validate_args: bool = True,
):
    """Task-dispatching precision-recall curve."""
    task = ClassificationTask.from_str(task)
    if task == ClassificationTask.BINARY:
        return binary_precision_recall_curve(preds, target, thresholds, ignore_index, validate_args)
    if task == ClassificationTask.MULTICLASS:
        if not isinstance(num_classes, int):
            raise ValueError(f"`num_classes` is expected to be `int` but `{type(num_classes)} was passed.`")
        return multiclass_precision_recall_curve(
            preds, target, num_classes, thresholds, average, ignore_index, validate_args
        )
    if task == ClassificationTask.MULTILABEL:
        if not isinstance(num_labels, int):
            raise ValueError(f"`num_labels` is expected to be `int` but `{type(num_labels)} was passed.`")
        return multilabel_precision_recall_curve(preds, target, num_labels, thresholds, ignore_index, validate_args)
    raise ValueError(f"Not handled value: {task}")
