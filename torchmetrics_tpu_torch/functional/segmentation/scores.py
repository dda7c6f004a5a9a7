"""Segmentation scores: generalized dice and mean IoU.

Counterpart of ``torchmetrics_tpu/functional/segmentation/scores.py``.

Index input (``input_format="index"``): JAX one-hots both sides, so a label outside
``[0, C)`` (Cityscapes' 255, a negative value) is an all-zero row there, yet its pixel
still counts in the other side's class sum. Here each image's pixels are one
``(C + 1) x (C + 1)`` table of (target, pred) pairs, bin ``C`` standing for "out of
range", counted for the whole batch by one launch of the bincount kernel over the ids
``n * (C + 1)^2 + t' * (C + 1) + p'``. The intersection is the table's diagonal over
``[0, C)``, the target's class sums its rows over all columns, the prediction's its
columns over all rows. The counts are int32 and exact; they equal JAX's float32 sums
below 2^24 pixels an image. A batch whose ids would pass 2^31 is counted in parts.

One-hot input stays plain sums, as in JAX: dice's float32 products, IoU's booleans.
"""

from __future__ import annotations

from typing import Tuple

import torch

from torchmetrics_tpu_torch.ops import kernels
from torchmetrics_tpu_torch.utils.checks import _check_same_shape
from torchmetrics_tpu_torch.utils.data import safe_divide

Tensor = torch.Tensor

# the bincount kernel's bins are an int
_MAX_BINS = (1 << 31) - 1


def _drop_background(x: Tensor) -> Tensor:
    """Drop the background channel (index 0) when more than one class is present."""
    return x[:, 1:] if x.shape[1] > 1 else x


def _ignore_background(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    return _drop_background(preds), _drop_background(target)


def _index_class_sums(
    preds: Tensor, target: Tensor, num_classes: int, include_background: bool = True
) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-image (intersection, target sum, pred sum), each int32 [N, C] (class 0 dropped
    as ``_ignore_background`` drops it unless ``include_background``), of index maps
    ``preds`` and ``target`` [N, ...] (labels taken as JAX takes them: int32)."""
    c1 = num_classes + 1
    cells = c1 * c1
    if cells > _MAX_BINS:
        raise ValueError(f"Expected (num_classes + 1)^2 below 2^31 for the index input, got num_classes={num_classes}")
    n = preds.shape[0]
    p = preds.reshape(n, -1).to(torch.int32)
    t = target.reshape(n, -1).to(torch.int32)
    p = torch.where((p >= 0) & (p < num_classes), p, num_classes)
    t = torch.where((t >= 0) & (t < num_classes), t, num_classes)
    per_launch = max(1, _MAX_BINS // cells)
    tables = []
    for start in range(0, n, per_launch):
        images = min(per_launch, n - start)
        image = torch.arange(images, dtype=torch.int32, device=p.device)[:, None]
        ids = (image * cells + t[start:start + images] * c1) + p[start:start + images]
        tables.append(kernels.bincount(ids, None, images * cells).view(images, c1, c1))
    table = torch.cat(tables) if len(tables) != 1 else tables[0]
    sums = (
        torch.diagonal(table, dim1=1, dim2=2)[:, :num_classes],
        table.sum(dim=2, dtype=torch.int32)[:, :num_classes],
        table.sum(dim=1, dtype=torch.int32)[:, :num_classes],
    )
    return sums if include_background else tuple(_drop_background(x) for x in sums)


def _generalized_dice_validate_args(
    num_classes: int,
    include_background: bool,
    per_class: bool,
    weight_type: str,
    input_format: str,
) -> None:
    """Validate generalized-dice arguments."""
    if num_classes <= 0:
        raise ValueError(f"Expected argument `num_classes` must be a positive integer, but got {num_classes}.")
    if not isinstance(include_background, bool):
        raise ValueError(f"Expected argument `include_background` must be a boolean, but got {include_background}.")
    if not isinstance(per_class, bool):
        raise ValueError(f"Expected argument `per_class` must be a boolean, but got {per_class}.")
    if weight_type not in ["square", "simple", "linear"]:
        raise ValueError(
            f"Expected argument `weight_type` to be one of 'square', 'simple', 'linear', but got {weight_type}."
        )
    if input_format not in ["one-hot", "index"]:
        raise ValueError(f"Expected argument `input_format` to be one of 'one-hot', 'index', but got {input_format}.")


def _generalized_dice_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    include_background: bool,
    weight_type: str = "square",
    input_format: str = "one-hot",
) -> Tuple[Tensor, Tensor]:
    """Weighted per-class numerator/denominator for the batch."""
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target, device=preds.device)
    _check_same_shape(preds, target)
    if preds.ndim < 3:
        raise ValueError(f"Expected both `preds` and `target` to have at least 3 dimensions, but got {preds.ndim}.")

    if input_format == "index":
        sums = _index_class_sums(preds, target, num_classes, include_background)
        intersection, target_sum, pred_sum = (x.to(torch.float32) for x in sums)
    else:
        if not include_background:
            preds, target = _ignore_background(preds, target)
        reduce_axis = tuple(range(2, target.ndim))
        preds_f = preds.to(torch.float32)
        target_f = target.to(torch.float32)
        intersection = torch.sum(preds_f * target_f, dim=reduce_axis)
        target_sum = torch.sum(target_f, dim=reduce_axis)
        pred_sum = torch.sum(preds_f, dim=reduce_axis)
    cardinality = target_sum + pred_sum

    if weight_type == "simple":
        weights = 1.0 / target_sum
    elif weight_type == "linear":
        weights = torch.ones_like(target_sum)
    elif weight_type == "square":
        weights = 1.0 / torch.square(target_sum)
    else:
        raise ValueError(
            f"Expected argument `weight_type` to be one of 'simple', 'linear', 'square', but got {weight_type}."
        )

    # replace inf weights (empty classes) with the per-class max finite weight
    infs = torch.isinf(weights)
    finite = torch.where(infs, torch.zeros_like(weights), weights)
    w_max = torch.amax(finite, dim=0)  # per class over the batch
    weights = torch.where(infs, w_max.expand(weights.shape), weights)

    numerator = 2.0 * intersection * weights
    denominator = cardinality * weights
    return numerator, denominator


def _generalized_dice_compute(numerator: Tensor, denominator: Tensor, per_class: bool = True) -> Tensor:
    """Per-sample (optionally per-class) generalized dice score."""
    if not per_class:
        numerator = torch.sum(numerator, dim=1)
        denominator = torch.sum(denominator, dim=1)
    return safe_divide(numerator, denominator)


def generalized_dice_score(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    include_background: bool = True,
    per_class: bool = False,
    weight_type: str = "square",
    input_format: str = "one-hot",
) -> Tensor:
    """Compute the generalized dice score for semantic segmentation.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.segmentation import generalized_dice_score
        >>> preds = torch.tensor([[[0, 1], [2, 2]], [[1, 1], [0, 255]]])
        >>> target = torch.tensor([[[0, 1], [2, 1]], [[1, 1], [0, 0]]])
        >>> generalized_dice_score(preds, target, num_classes=3, input_format="index").round(decimals=4)
        tensor([0.7826, 0.8571])
    """
    _generalized_dice_validate_args(num_classes, include_background, per_class, weight_type, input_format)
    numerator, denominator = _generalized_dice_update(
        preds, target, num_classes, include_background, weight_type, input_format
    )
    return _generalized_dice_compute(numerator, denominator, per_class)


def _mean_iou_validate_args(
    num_classes: int,
    include_background: bool,
    per_class: bool,
    input_format: str = "one-hot",
) -> None:
    """Validate mean-IoU arguments."""
    if num_classes <= 0:
        raise ValueError(f"Expected argument `num_classes` must be a positive integer, but got {num_classes}.")
    if not isinstance(include_background, bool):
        raise ValueError(f"Expected argument `include_background` must be a boolean, but got {include_background}.")
    if not isinstance(per_class, bool):
        raise ValueError(f"Expected argument `per_class` must be a boolean, but got {per_class}.")
    if input_format not in ["one-hot", "index"]:
        raise ValueError(f"Expected argument `input_format` to be one of 'one-hot', 'index', but got {input_format}.")


def _mean_iou_update(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    include_background: bool = False,
    input_format: str = "one-hot",
) -> Tuple[Tensor, Tensor]:
    """Per-sample per-class intersection and union counts (int32)."""
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target, device=preds.device)
    _check_same_shape(preds, target)

    if input_format == "index":
        intersection, target_sum, pred_sum = _index_class_sums(preds, target, num_classes, include_background)
    else:
        if not include_background:
            preds, target = _ignore_background(preds, target)
        reduce_axis = tuple(range(2, preds.ndim))
        preds_b = preds.to(torch.bool)
        target_b = target.to(torch.bool)
        intersection = torch.sum(preds_b & target_b, dim=reduce_axis, dtype=torch.int32)
        target_sum = torch.sum(target_b, dim=reduce_axis, dtype=torch.int32)
        pred_sum = torch.sum(preds_b, dim=reduce_axis, dtype=torch.int32)
    union = target_sum + pred_sum - intersection
    return intersection, union


def _mean_iou_compute(intersection: Tensor, union: Tensor, per_class: bool = False) -> Tensor:
    """Per-sample IoU (optionally per class)."""
    val = safe_divide(intersection, union)
    return val if per_class else torch.mean(val, dim=1)


def mean_iou(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    include_background: bool = True,
    per_class: bool = False,
    input_format: str = "one-hot",
) -> Tensor:
    """Compute the mean intersection over union for semantic segmentation.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.segmentation import mean_iou
        >>> preds = torch.tensor([[[0, 1], [2, 2]], [[1, 1], [0, 255]]])
        >>> target = torch.tensor([[[0, 1], [2, 1]], [[1, 1], [0, 0]]])
        >>> mean_iou(preds, target, num_classes=3, input_format="index").round(decimals=4)
        tensor([0.6667, 0.5000])
    """
    _mean_iou_validate_args(num_classes, include_background, per_class, input_format)
    intersection, union = _mean_iou_update(preds, target, num_classes, include_background, input_format)
    return _mean_iou_compute(intersection, union, per_class=per_class)
