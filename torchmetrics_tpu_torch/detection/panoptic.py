"""Panoptic quality metric modules.

Counterpart of ``torchmetrics_tpu/detection/panoptic.py``: per-category sums of IoU
(float32) and counts (int32), each update counted on the bincount kernel
(``functional/detection/panoptic.py``).
"""

from __future__ import annotations

from typing import Any, Collection, Optional, Set

import torch

from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.functional.detection.panoptic import (
    _Categories,
    _get_category_id_to_continuous_id,
    _get_void_color,
    _panoptic_quality_compute,
    _panoptic_quality_update,
    _parse_categories,
    _prepocess_inputs,
    _validate_inputs,
)

Tensor = torch.Tensor


class PanopticQuality(Metric):
    r"""Panoptic quality of (category, instance) panoptic maps.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import PanopticQuality
        >>> preds = torch.tensor([[[[6, 0], [0, 0], [6, 0], [6, 0]],
        ...                        [[0, 0], [0, 0], [6, 0], [0, 1]],
        ...                        [[0, 0], [0, 0], [6, 0], [0, 1]],
        ...                        [[0, 0], [7, 0], [6, 0], [1, 0]],
        ...                        [[0, 0], [7, 0], [7, 0], [7, 0]]]])
        >>> target = torch.tensor([[[[6, 0], [0, 1], [6, 0], [0, 1]],
        ...                         [[0, 1], [0, 1], [6, 0], [0, 1]],
        ...                         [[0, 1], [0, 1], [6, 0], [1, 0]],
        ...                         [[0, 1], [7, 0], [1, 0], [1, 0]],
        ...                         [[0, 1], [7, 0], [7, 0], [7, 0]]]])
        >>> panoptic_quality = PanopticQuality(things={0, 1}, stuffs={6, 7}, device="cpu")
        >>> panoptic_quality(preds, target).round(decimals=4)
        tensor(0.5463)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = False
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    iou_sum: Tensor
    true_positives: Tensor
    false_positives: Tensor
    false_negatives: Tensor

    def __init__(
        self,
        things: Collection[int],
        stuffs: Collection[int],
        allow_unknown_preds_category: bool = False,
        return_sq_and_rq: bool = False,
        return_per_class: bool = False,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("jit_update", False)
        super().__init__(**kwargs)
        things_set, stuffs_set = _parse_categories(things, stuffs)
        self.things = things_set
        self.stuffs = stuffs_set
        self.void_color = _get_void_color(things_set, stuffs_set)
        self.cat_id_to_continuous_id = _get_category_id_to_continuous_id(things_set, stuffs_set)
        self.allow_unknown_preds_category = allow_unknown_preds_category
        self.return_sq_and_rq = return_sq_and_rq
        self.return_per_class = return_per_class
        self._categories = _Categories(things_set, stuffs_set, self.device)

        num_categories = len(things_set) + len(stuffs_set)
        self.add_state("iou_sum", torch.zeros(num_categories), dist_reduce_fx="sum")
        self.add_state("true_positives", torch.zeros(num_categories, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("false_positives", torch.zeros(num_categories, dtype=torch.int32), dist_reduce_fx="sum")
        self.add_state("false_negatives", torch.zeros(num_categories, dtype=torch.int32), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        """Accumulate per-category PQ statistics for the batch."""
        preds = torch.as_tensor(preds, device=self.device)
        target = torch.as_tensor(target, device=self.device)
        _validate_inputs(preds, target)
        pred_cont, pred_inst = _prepocess_inputs(
            self.things, self.stuffs, preds, self.allow_unknown_preds_category, self._categories
        )
        target_cont, target_inst = _prepocess_inputs(self.things, self.stuffs, target, True, self._categories)
        iou_sum, true_positives, false_positives, false_negatives = _panoptic_quality_update(
            pred_cont, pred_inst, target_cont, target_inst, self.cat_id_to_continuous_id, self._modified_stuffs()
        )
        self.iou_sum = self.iou_sum + iou_sum
        self.true_positives = self.true_positives + true_positives
        self.false_positives = self.false_positives + false_positives
        self.false_negatives = self.false_negatives + false_negatives

    def _modified_stuffs(self) -> Optional[Set[int]]:
        return None

    def compute(self) -> Tensor:
        """Panoptic quality over accumulated statistics."""
        pq, sq, rq, pq_avg, sq_avg, rq_avg = _panoptic_quality_compute(
            self.iou_sum, self.true_positives, self.false_positives, self.false_negatives
        )
        if self.return_per_class:
            if self.return_sq_and_rq:
                return torch.stack((pq, sq, rq), dim=-1)
            return pq.reshape(1, -1)
        if self.return_sq_and_rq:
            return torch.stack((pq_avg, sq_avg, rq_avg), dim=0)
        return pq_avg


class ModifiedPanopticQuality(PanopticQuality):
    r"""Modified panoptic quality (stuff classes scored without segment matching).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import ModifiedPanopticQuality
        >>> preds = torch.tensor([[[0, 0], [0, 1], [6, 0], [7, 0], [0, 2], [1, 0]]])
        >>> target = torch.tensor([[[0, 1], [0, 0], [6, 0], [7, 0], [6, 0], [255, 0]]])
        >>> pq_modified = ModifiedPanopticQuality(
        ...     things={0, 1}, stuffs={6, 7}, allow_unknown_preds_category=True, device="cpu")
        >>> pq_modified(preds, target).round(decimals=4)
        tensor(0.7667)
    """

    def __init__(
        self,
        things: Collection[int],
        stuffs: Collection[int],
        allow_unknown_preds_category: bool = False,
        **kwargs: Any,
    ) -> None:
        super().__init__(
            things=things,
            stuffs=stuffs,
            allow_unknown_preds_category=allow_unknown_preds_category,
            **kwargs,
        )

    def _modified_stuffs(self) -> Optional[Set[int]]:
        return self.stuffs
