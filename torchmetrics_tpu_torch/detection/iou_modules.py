"""IoU-family detection metric modules.

Counterpart of ``torchmetrics_tpu/detection/iou_modules.py``. The list states hold one
(thresholded, label-masked) IoU matrix and one label vector per image, on the metric's
device, and sync across processes through the ragged gather, which keeps the per-image
boundaries. An update computes the whole batch's matrices in one padded pass (the same
float32 operations as JAX's per-image ones) and keeps each image's block.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.detection.helpers import _fix_empty_tensors, _input_validator
from torchmetrics_tpu_torch.functional.detection.box_ops import (
    box_convert,
    box_iou,
    complete_box_iou,
    distance_box_iou,
    generalized_box_iou,
)

Tensor = torch.Tensor


def _as_jax_array(x: Any, device: torch.device) -> Tensor:
    """``jnp.asarray`` of ``x`` on ``device``: 64-bit ints and floats become 32-bit."""
    x = torch.as_tensor(x, device=device)
    if x.dtype == torch.int64:
        return x.to(torch.int32)
    if x.dtype == torch.float64:
        return x.to(torch.float32)
    return x


def _padded(rows: List[Tensor], width: int, fill: float, device: torch.device, dtype: torch.dtype) -> Tensor:
    """Stack ``rows`` (each ``[n_i, *item]``) into ``[B, max n_i, *item]``, padding with ``fill``."""
    longest = max((r.shape[0] for r in rows), default=0)
    out = torch.full((len(rows), longest, *([width] if width else [])), fill, dtype=dtype, device=device)
    for i, r in enumerate(rows):
        out[i, : r.shape[0]] = r
    return out


class IntersectionOverUnion(Metric):
    r"""Intersection over union of detection boxes against ground-truth boxes.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import IntersectionOverUnion
        >>> preds = [{"boxes": torch.tensor([[296.55, 93.96, 314.97, 152.79]]),
        ...           "labels": torch.tensor([0])}]
        >>> target = [{"boxes": torch.tensor([[300.00, 100.00, 315.00, 150.00]]),
        ...            "labels": torch.tensor([0])}]
        >>> metric = IntersectionOverUnion(device="cpu")
        >>> metric(preds, target)["iou"].round(decimals=4)
        tensor(0.6898)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    _iou_type: str = "iou"
    _invalid_val: float = -1.0
    _pairwise_fn: Callable = staticmethod(box_iou)

    groundtruth_labels: List[Tensor]
    iou_matrix: List[Tensor]

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_threshold: Optional[float] = None,
        class_metrics: bool = False,
        respect_labels: bool = True,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("jit_update", False)
        super().__init__(**kwargs)
        allowed_box_formats = ("xyxy", "xywh", "cxcywh")
        if box_format not in allowed_box_formats:
            raise ValueError(f"Expected argument `box_format` to be one of {allowed_box_formats} but got {box_format}")
        self.box_format = box_format
        self.iou_threshold = iou_threshold
        if not isinstance(class_metrics, bool):
            raise ValueError("Expected argument `class_metrics` to be a boolean")
        self.class_metrics = class_metrics
        if not isinstance(respect_labels, bool):
            raise ValueError("Expected argument `respect_labels` to be a boolean")
        self.respect_labels = respect_labels

        self.add_state("groundtruth_labels", [], dist_reduce_fx=None)
        self.add_state("iou_matrix", [], dist_reduce_fx=None)

    def _sync_dist(self, dist_sync_fn: Optional[Callable] = None, process_group: Optional[Any] = None) -> None:
        if dist_sync_fn is not None or self.dist_sync_fn is not None:
            super()._sync_dist(dist_sync_fn, process_group)
            return
        from torchmetrics_tpu_torch.parallel.sync import allgather_ragged_arrays

        group = process_group or self.process_group
        sv = self._state_values
        sv["iou_matrix"] = allgather_ragged_arrays(list(sv["iou_matrix"]), ndim=2, process_group=group)
        sv["groundtruth_labels"] = allgather_ragged_arrays(
            [lab.reshape(-1) for lab in sv["groundtruth_labels"]], ndim=1, dtype=torch.int64, process_group=group
        )

    def update(self, preds: List[Dict[str, Tensor]], target: List[Dict[str, Tensor]]) -> None:
        """Compute and store the per-image (thresholded) IoU matrix."""
        _input_validator(preds, target, ignore_score=True)
        if not preds:
            return
        device = self.device
        det = [self._get_safe_item_values(p["boxes"]) for p in preds]
        gt = [self._get_safe_item_values(t["boxes"]) for t in target]
        gt_labels = [_as_jax_array(t["labels"], device) for t in target]
        det_labels = [_as_jax_array(p["labels"], device).reshape(-1) for p in preds]
        # one padded pass over the batch: each image's block is the JAX per-image matrix
        iou = self._pairwise_fn(
            _padded([d.reshape(-1, 4) for d in det], 4, 0.0, device, torch.float32),
            _padded([g.reshape(-1, 4) for g in gt], 4, 0.0, device, torch.float32),
        )
        invalid = torch.tensor(self._invalid_val, dtype=iou.dtype, device=device)
        if self.iou_threshold is not None:
            iou = torch.where(iou < self.iou_threshold, invalid, iou)
        if self.respect_labels:
            dl = _padded(det_labels, 0, -1, device, torch.int64)
            gl = _padded([g.reshape(-1) for g in gt_labels], 0, -1, device, torch.int64)
            iou = torch.where(dl[:, :, None] == gl[:, None, :], iou, invalid)
        for i, (d, g) in enumerate(zip(det, gt)):
            self.groundtruth_labels.append(gt_labels[i])
            self.iou_matrix.append(iou[i, : d.reshape(-1, 4).shape[0], : g.reshape(-1, 4).shape[0]])

    def _get_safe_item_values(self, boxes: Tensor) -> Tensor:
        boxes = _fix_empty_tensors(torch.as_tensor(boxes, dtype=torch.float32, device=self.device))
        if boxes.numel() > 0:
            boxes = box_convert(boxes, in_fmt=self.box_format, out_fmt="xyxy")
        return boxes

    def compute(self) -> Dict[str, Tensor]:
        """Mean (valid) IoU, optionally per class."""
        device = self.device
        mats = list(self.iou_matrix)  # [n_det, n_gt] each
        flat = torch.cat([m.reshape(-1) for m in mats]) if mats else torch.zeros(0, device=device)
        valid = flat != self._invalid_val
        count = valid.sum()
        total = torch.where(valid, flat.to(torch.float64), 0.0).sum()
        score = torch.where(count > 0, total / count.clamp(min=1), 0.0).to(torch.float32)
        results: Dict[str, Tensor] = {f"{self._iou_type}": score}

        if self.class_metrics:
            labels = [lab.reshape(-1).to(torch.int64) for lab in self.groundtruth_labels]
            all_labels = torch.cat(labels) if labels else torch.zeros(0, dtype=torch.int64, device=device)
            classes = torch.unique(all_labels)
            if classes.numel():
                # each matrix entry belongs to its column's ground-truth class
                cols = torch.cat([
                    lab[None, :].expand(m.shape[0], lab.shape[0]).reshape(-1) for m, lab in zip(mats, labels)
                ])
                index = torch.searchsorted(classes, cols[valid])
                sums = torch.zeros(classes.numel(), dtype=torch.float64, device=device)
                sums.index_add_(0, index, flat[valid].to(torch.float64))
                counts = torch.zeros(classes.numel(), dtype=torch.int64, device=device)
                counts.index_add_(0, index, torch.ones_like(index))
                per_class = torch.where(counts > 0, sums / counts.clamp(min=1), 0.0).to(torch.float32)
                for cl, value in zip(classes.tolist(), per_class.unbind()):
                    results[f"{self._iou_type}/cl_{cl}"] = value
        return results


class GeneralizedIntersectionOverUnion(IntersectionOverUnion):
    r"""Generalized IoU of detection boxes against ground-truth boxes.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import GeneralizedIntersectionOverUnion
        >>> preds = [{"boxes": torch.tensor([[296.55, 93.96, 314.97, 152.79]]),
        ...           "labels": torch.tensor([0])}]
        >>> target = [{"boxes": torch.tensor([[300.00, 100.00, 315.00, 150.00]]),
        ...            "labels": torch.tensor([0])}]
        >>> metric = GeneralizedIntersectionOverUnion(device="cpu")
        >>> metric(preds, target)["giou"].round(decimals=4)
        tensor(0.6895)
    """

    _iou_type: str = "giou"
    _invalid_val: float = -1.0
    _pairwise_fn = staticmethod(generalized_box_iou)


class DistanceIntersectionOverUnion(IntersectionOverUnion):
    r"""Distance IoU of detection boxes against ground-truth boxes.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import DistanceIntersectionOverUnion
        >>> preds = [{"boxes": torch.tensor([[296.55, 93.96, 314.97, 152.79]]),
        ...           "labels": torch.tensor([0])}]
        >>> target = [{"boxes": torch.tensor([[300.00, 100.00, 315.00, 150.00]]),
        ...            "labels": torch.tensor([0])}]
        >>> metric = DistanceIntersectionOverUnion(device="cpu")
        >>> metric(preds, target)["diou"].round(decimals=4)
        tensor(0.6883)
    """

    _iou_type: str = "diou"
    _invalid_val: float = -1.0
    _pairwise_fn = staticmethod(distance_box_iou)


class CompleteIntersectionOverUnion(IntersectionOverUnion):
    r"""Complete IoU of detection boxes against ground-truth boxes.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import CompleteIntersectionOverUnion
        >>> preds = [{"boxes": torch.tensor([[296.55, 93.96, 314.97, 152.79]]),
        ...           "labels": torch.tensor([0])}]
        >>> target = [{"boxes": torch.tensor([[300.00, 100.00, 315.00, 150.00]]),
        ...            "labels": torch.tensor([0])}]
        >>> metric = CompleteIntersectionOverUnion(device="cpu")
        >>> metric(preds, target)["ciou"].round(decimals=4)
        tensor(0.6883)
    """

    _iou_type: str = "ciou"
    _invalid_val: float = -2.0
    _pairwise_fn = staticmethod(complete_box_iou)
