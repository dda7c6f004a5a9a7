"""Input validation helpers for detection metrics.

Counterpart of ``torchmetrics_tpu/detection/helpers.py``, with JAX's messages.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

Tensor = torch.Tensor


def _fix_empty_tensors(boxes: Tensor) -> Tensor:
    """Give empty box tensors the canonical (0, 4) shape."""
    boxes = torch.as_tensor(boxes)
    if boxes.numel() == 0 and boxes.ndim == 1:
        return boxes.reshape(0, 4)
    return boxes


def _length(item) -> int:
    """Leading length of an array-like, 0 when it is empty (JAX's ``shape[0] if size``)."""
    shape = tuple(item.shape if hasattr(item, "shape") else torch.as_tensor(item).shape)
    return shape[0] if math.prod(shape) else 0


def _input_validator(
    preds: Sequence[Dict[str, Tensor]],
    targets: Sequence[Dict[str, Tensor]],
    ignore_score: bool = False,
    iou_type: str = "bbox",
) -> None:
    """Validate the list-of-dicts detection input format."""
    if not isinstance(preds, Sequence):
        raise ValueError(f"Expected argument `preds` to be of type Sequence, but got {preds}")
    if not isinstance(targets, Sequence):
        raise ValueError(f"Expected argument `target` to be of type Sequence, but got {targets}")
    if len(preds) != len(targets):
        raise ValueError(
            f"Expected argument `preds` and `target` to have the same length, but got {len(preds)} and {len(targets)}"
        )

    item_key = "masks" if iou_type == "segm" else "boxes"
    for k in [item_key, "labels"] + ([] if ignore_score else ["scores"]):
        if any(k not in p for p in preds):
            raise ValueError(f"Expected all dicts in `preds` to contain the `{k}` key")
    for k in [item_key, "labels"]:
        if any(k not in p for p in targets):
            raise ValueError(f"Expected all dicts in `target` to contain the `{k}` key")

    for i, item in enumerate(targets):
        n_boxes = _length(item[item_key])
        n_labels = _length(item["labels"])
        if n_boxes != n_labels:
            raise ValueError(
                f"Input '{i}' of `target` has a different length of {item_key} ({n_boxes}) and labels ({n_labels})"
            )
    if not ignore_score:
        for i, item in enumerate(preds):
            n_boxes = _length(item[item_key])
            n_labels = _length(item["labels"])
            n_scores = _length(item["scores"])
            if n_boxes != n_labels or n_boxes != n_scores:
                raise ValueError(
                    f"Input '{i}' of `preds` has a different length of {item_key} ({n_boxes}), labels ({n_labels})"
                    f" and scores ({n_scores})"
                )
