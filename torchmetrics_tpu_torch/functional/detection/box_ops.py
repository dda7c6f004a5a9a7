"""Bounding-box ops and the IoU-family functionals.

Counterpart of ``torchmetrics_tpu/functional/detection/box_ops.py``: the same batched
algebra over the N x M pair grid, in float32 and in JAX's order of operations, on the
device of the boxes given.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def _as_float_boxes(boxes) -> Tensor:
    """A float tensor of boxes (float32 unless already floating), as ``jnp.asarray`` keeps it."""
    boxes = torch.as_tensor(boxes)
    return boxes if boxes.is_floating_point() else boxes.to(torch.float32)


def box_convert(boxes: Tensor, in_fmt: str, out_fmt: str) -> Tensor:
    """Convert boxes between xyxy / xywh / cxcywh formats."""
    if in_fmt == out_fmt:
        return boxes
    if in_fmt == "xywh":
        x, y, w, h = boxes.unbind(-1)
        boxes = torch.stack([x, y, x + w, y + h], dim=-1)
    elif in_fmt == "cxcywh":
        cx, cy, w, h = boxes.unbind(-1)
        boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
    elif in_fmt != "xyxy":
        raise ValueError(f"Unsupported box format {in_fmt}")

    if out_fmt == "xyxy":
        return boxes
    if out_fmt == "xywh":
        x1, y1, x2, y2 = boxes.unbind(-1)
        return torch.stack([x1, y1, x2 - x1, y2 - y1], dim=-1)
    if out_fmt == "cxcywh":
        x1, y1, x2, y2 = boxes.unbind(-1)
        return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)
    raise ValueError(f"Unsupported box format {out_fmt}")


def box_area(boxes: Tensor) -> Tensor:
    """Areas of xyxy boxes."""
    boxes = torch.as_tensor(boxes)
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def _box_inter_union(boxes1: Tensor, boxes2: Tensor) -> Tuple[Tensor, Tensor]:
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter, union


def box_iou(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Pairwise IoU matrix of two xyxy box sets; shape (..., N, M) (leading dims batch)."""
    inter, union = _box_inter_union(_as_float_boxes(boxes1), _as_float_boxes(boxes2))
    return inter / union


def generalized_box_iou(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Pairwise generalized IoU: IoU minus the enclosure's non-union fraction."""
    boxes1 = _as_float_boxes(boxes1)
    boxes2 = _as_float_boxes(boxes2)
    inter, union = _box_inter_union(boxes1, boxes2)
    iou = inter / union
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    enclosure = wh[..., 0] * wh[..., 1]
    return iou - (enclosure - union) / enclosure


def _center_distances(boxes1: Tensor, boxes2: Tensor) -> Tuple[Tensor, Tensor]:
    """Squared center distance and squared enclosure diagonal, both (..., N, M)."""
    c1 = (boxes1[..., :, None, :2] + boxes1[..., :, None, 2:]) / 2
    c2 = (boxes2[..., None, :, :2] + boxes2[..., None, :, 2:]) / 2
    center_dist_sq = torch.square(c1 - c2).sum(dim=-1)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    diag_sq = torch.square(rb - lt).sum(dim=-1)
    return center_dist_sq, diag_sq


def distance_box_iou(boxes1: Tensor, boxes2: Tensor, eps: float = 1e-7) -> Tensor:
    """Pairwise distance-IoU: IoU minus the normalized center distance."""
    boxes1 = _as_float_boxes(boxes1)
    boxes2 = _as_float_boxes(boxes2)
    inter, union = _box_inter_union(boxes1, boxes2)
    iou = inter / union
    center_dist_sq, diag_sq = _center_distances(boxes1, boxes2)
    return iou - center_dist_sq / (diag_sq + eps)


def complete_box_iou(boxes1: Tensor, boxes2: Tensor, eps: float = 1e-7) -> Tensor:
    """Pairwise complete-IoU: distance-IoU with an aspect-ratio consistency term."""
    boxes1 = _as_float_boxes(boxes1)
    boxes2 = _as_float_boxes(boxes2)
    inter, union = _box_inter_union(boxes1, boxes2)
    iou = inter / union
    center_dist_sq, diag_sq = _center_distances(boxes1, boxes2)
    diou = iou - center_dist_sq / (diag_sq + eps)

    w1 = boxes1[..., 2] - boxes1[..., 0]
    h1 = boxes1[..., 3] - boxes1[..., 1]
    w2 = boxes2[..., 2] - boxes2[..., 0]
    h2 = boxes2[..., 3] - boxes2[..., 1]
    v = (4 / math.pi**2) * torch.square(torch.arctan(w2 / h2)[..., None, :] - torch.arctan(w1 / h1)[..., :, None])
    alpha = v / (1 - iou + v + eps)
    return diou - alpha * v


def _iou_family_update(
    preds: Tensor,
    target: Tensor,
    pairwise_fn,
    iou_threshold: Optional[float],
    replacement_val: float = 0,
) -> Tensor:
    """Shared validation + threshold masking for the four IoU variants."""
    preds = _as_float_boxes(preds)
    target = _as_float_boxes(target).to(preds.device)
    if preds.ndim != 2 or preds.shape[-1] != 4:
        raise ValueError(f"Expected preds to be of shape (N, 4) but got {tuple(preds.shape)}")
    if target.ndim != 2 or target.shape[-1] != 4:
        raise ValueError(f"Expected target to be of shape (N, 4) but got {tuple(target.shape)}")
    iou = pairwise_fn(preds, target)
    if iou_threshold is not None:
        iou = torch.where(iou < iou_threshold, torch.as_tensor(replacement_val, dtype=iou.dtype), iou)
    return iou


def _iou_family_compute(iou: Tensor, aggregate: bool = True) -> Tensor:
    if not aggregate:
        return iou
    return torch.diagonal(iou).mean() if iou.numel() > 0 else torch.zeros((), device=iou.device)


def intersection_over_union(
    preds: Tensor,
    target: Tensor,
    iou_threshold: Optional[float] = None,
    replacement_val: float = 0,
    aggregate: bool = True,
) -> Tensor:
    r"""Compute IoU between two sets of xyxy boxes.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.detection import intersection_over_union
        >>> preds = torch.tensor([[296.55, 93.96, 314.97, 152.79]])
        >>> target = torch.tensor([[300.00, 100.00, 315.00, 150.00]])
        >>> intersection_over_union(preds, target).round(decimals=4)
        tensor(0.6898)
    """
    iou = _iou_family_update(preds, target, box_iou, iou_threshold, replacement_val)
    return _iou_family_compute(iou, aggregate)


def generalized_intersection_over_union(
    preds: Tensor,
    target: Tensor,
    iou_threshold: Optional[float] = None,
    replacement_val: float = 0,
    aggregate: bool = True,
) -> Tensor:
    r"""Compute generalized IoU between two sets of xyxy boxes.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.detection import generalized_intersection_over_union
        >>> preds = torch.tensor([[296.55, 93.96, 314.97, 152.79]])
        >>> target = torch.tensor([[300.00, 100.00, 315.00, 150.00]])
        >>> generalized_intersection_over_union(preds, target).round(decimals=4)
        tensor(0.6895)
    """
    iou = _iou_family_update(preds, target, generalized_box_iou, iou_threshold, replacement_val)
    return _iou_family_compute(iou, aggregate)


def distance_intersection_over_union(
    preds: Tensor,
    target: Tensor,
    iou_threshold: Optional[float] = None,
    replacement_val: float = 0,
    aggregate: bool = True,
) -> Tensor:
    r"""Compute distance IoU between two sets of xyxy boxes.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.detection import distance_intersection_over_union
        >>> preds = torch.tensor([[296.55, 93.96, 314.97, 152.79]])
        >>> target = torch.tensor([[300.00, 100.00, 315.00, 150.00]])
        >>> distance_intersection_over_union(preds, target).round(decimals=4)
        tensor(0.6883)
    """
    iou = _iou_family_update(preds, target, distance_box_iou, iou_threshold, replacement_val)
    return _iou_family_compute(iou, aggregate)


def complete_intersection_over_union(
    preds: Tensor,
    target: Tensor,
    iou_threshold: Optional[float] = None,
    replacement_val: float = 0,
    aggregate: bool = True,
) -> Tensor:
    r"""Compute complete IoU between two sets of xyxy boxes.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.detection import complete_intersection_over_union
        >>> preds = torch.tensor([[296.55, 93.96, 314.97, 152.79]])
        >>> target = torch.tensor([[300.00, 100.00, 315.00, 150.00]])
        >>> complete_intersection_over_union(preds, target).round(decimals=4)
        tensor(0.6883)
    """
    iou = _iou_family_update(preds, target, complete_box_iou, iou_threshold, replacement_val)
    return _iou_family_compute(iou, aggregate)
