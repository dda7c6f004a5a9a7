"""Panoptic quality (PQ) and modified PQ.

Counterpart of ``torchmetrics_tpu/functional/detection/panoptic.py``. JAX counts each
image's segments ("colors": category and instance) and their pairwise intersections
with ``np.unique`` on the host and matches them in a Python loop over dicts. Here an
update is one pass on the device:

- the preprocessing is JAX's: stuff instance ids are zeroed, and unknown categories
  become the void color (or raise, for predictions, unless allowed);
- each pixel's color becomes one int64 key (image, category, instance), and one
  ``torch.unique`` numbers the batch's segments, image by image (a segment is a color
  of one image, predicted or true);
- one launch of the bincount kernel counts every image's pred x target pair table
  ``[S, S]`` (``S`` the most segments of an image): the intersections, whose row and
  column sums are the segments' areas;
- JAX's rules then run on the table at once: a pair of one category, its target not
  void, matches where its IoU (void pixels left out of the union) passes 0.5; an
  unmatched segment is a false negative or positive unless void covers more than half
  of it; the modified metric scores stuff without matching. IoUs and void shares are
  float64, as Python's division gives them.

The true-positive, false-positive and false-negative counts equal JAX's exactly; the
IoU sums are float64 sums in another order, cast to float32 per batch as JAX casts.
"""

from __future__ import annotations

from typing import Collection, Dict, Optional, Set, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch.ops import kernels

Tensor = torch.Tensor

# the bincount kernel's bins are an int
_MAX_BINS = (1 << 31) - 1


def _parse_categories(things: Collection[int], stuffs: Collection[int]) -> Tuple[Set[int], Set[int]]:
    """Validate and normalize the category id sets."""
    things_parsed = set(things)
    if len(things_parsed) < len(things):
        raise ValueError("The provided `things` categories contained duplicates, which have been removed.")
    stuffs_parsed = set(stuffs)
    if len(stuffs_parsed) < len(stuffs):
        raise ValueError("The provided `stuffs` categories contained duplicates, which have been removed.")
    if not all(isinstance(val, int) for val in things_parsed):
        raise TypeError(f"Expected argument `things` to contain `int` categories, but got {things}")
    if not all(isinstance(val, int) for val in stuffs_parsed):
        raise TypeError(f"Expected argument `stuffs` to contain `int` categories, but got {stuffs}")
    if things_parsed & stuffs_parsed:
        raise ValueError(
            f"Expected arguments `things` and `stuffs` to have distinct keys, but got {things} and {stuffs}"
        )
    if not (things_parsed | stuffs_parsed):
        raise ValueError("At least one of `things` and `stuffs` must be non-empty.")
    return things_parsed, stuffs_parsed


def _validate_inputs(preds: Tensor, target: Tensor) -> None:
    """Require same-shape (..., 2) tensors with at least one spatial dim."""
    if tuple(preds.shape) != tuple(target.shape):
        raise ValueError(
            "Expected argument `preds` and `target` to have the same shape, but got"
            f" {tuple(preds.shape)} and {tuple(target.shape)}"
        )
    if preds.ndim < 3:
        raise ValueError(
            "Expected argument `preds` to have at least one spatial dimension (B, *spatial_dims, 2), "
            f"got {tuple(preds.shape)}"
        )
    if preds.shape[-1] != 2:
        raise ValueError(
            "Expected argument `preds` to have exactly 2 channels in the last dimension (category, instance), "
            f"got {tuple(preds.shape)} instead"
        )


def _get_void_color(things: Set[int], stuffs: Set[int]) -> Tuple[int, int]:
    """An unused (category, instance) pair used to mask out unknown/ignored points."""
    unused_category_id = 1 + max([0, *list(things), *list(stuffs)])
    return unused_category_id, 0


def _get_category_id_to_continuous_id(things: Set[int], stuffs: Set[int]) -> Dict[int, int]:
    """Dense re-indexing: things first, then stuffs."""
    thing_id_to_continuous_id = {thing_id: idx for idx, thing_id in enumerate(sorted(things))}
    stuff_id_to_continuous_id = {stuff_id: idx + len(things) for idx, stuff_id in enumerate(sorted(stuffs))}
    cat_id_to_continuous_id = {}
    cat_id_to_continuous_id.update(thing_id_to_continuous_id)
    cat_id_to_continuous_id.update(stuff_id_to_continuous_id)
    return cat_id_to_continuous_id


class _Categories:
    """The category tables of one (things, stuffs) pair, on one device: the sorted
    known ids, each one's continuous id, and which are stuff."""

    def __init__(self, things: Set[int], stuffs: Set[int], device: torch.device) -> None:
        cont = _get_category_id_to_continuous_id(things, stuffs)
        known = sorted(cont)
        self.num = len(known)  # continuous id of the void color
        self.known = torch.tensor(known, dtype=torch.int64, device=device)
        self.cont = torch.tensor([cont[k] for k in known], dtype=torch.int64, device=device)
        self.cont_is_stuff = torch.zeros(self.num + 1, dtype=torch.bool, device=device)
        self.cont_is_stuff[[cont[s] for s in stuffs]] = True

    def lookup(self, category: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """(continuous id, known, stuff) of each category id (void's id where unknown)."""
        at = torch.searchsorted(self.known, category.contiguous()).clamp(max=self.num - 1)
        known = self.known[at] == category
        cont = torch.where(known, self.cont[at], self.num)
        return cont, known, self.cont_is_stuff[cont] & known


def _prepocess_inputs(
    things: Set[int],
    stuffs: Set[int],
    inputs: Tensor,
    allow_unknown_category: bool,
    categories: Optional[_Categories] = None,
) -> Tuple[Tensor, Tensor]:
    """Flatten spatial dims, zero stuff instance ids, map unknown categories to void.

    Returns ([B, P] continuous category ids, void's where unknown; [B, P] int64 instance
    ids, 0 for stuff and void)."""
    inputs = torch.as_tensor(inputs)
    categories = categories or _Categories(things, stuffs, inputs.device)
    flat = inputs.reshape(inputs.shape[0], -1, 2).to(torch.int64)
    cont, known, stuff = categories.lookup(flat[..., 0])
    if not allow_unknown_category and not bool(known.all()):
        unknown = np.asarray(inputs.reshape(inputs.shape[0], -1, 2).cpu())[~np.asarray(known.cpu())]
        raise ValueError(f"Unknown categories found: {unknown}")
    instance = torch.where(stuff | ~known, 0, flat[..., 1])
    return cont, instance


def _panoptic_quality_update(
    pred_cont: Tensor,
    pred_inst: Tensor,
    target_cont: Tensor,
    target_inst: Tensor,
    cat_id_to_continuous_id: Dict[int, int],
    modified_metric_stuffs: Optional[Set[int]] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-category (iou_sum float32, tp, fp, fn int32) of a batch of preprocessed maps
    ([B, P] continuous category and instance ids of each side)."""
    device = pred_cont.device
    num_categories = len(cat_id_to_continuous_id)
    void = num_categories  # continuous id of the void color (instance 0)
    batch, pixels = pred_cont.shape
    scored_stuff = torch.zeros(num_categories + 1, dtype=torch.bool, device=device)
    if modified_metric_stuffs:
        scored_stuff[[cat_id_to_continuous_id[s] for s in modified_metric_stuffs]] = True

    # one key per (image, color); instance ids are taken as 32 bits unless they need more
    inst = torch.cat([pred_inst, target_inst], dim=1)
    if inst.numel():
        low, high = torch.stack(torch.aminmax(inst)).tolist()
        if low < -(1 << 31) or high >= 1 << 31:
            inst = torch.unique(inst, return_inverse=True)[1]
    image = torch.arange(batch, dtype=torch.int64, device=device)[:, None]
    colors = torch.cat([pred_cont, target_cont], dim=1)
    keys = ((image * (num_categories + 1) + colors) << 32) | (inst & 0xFFFFFFFF)
    seg_keys, seg = torch.unique(keys, return_inverse=True)
    seg_image = torch.div(seg_keys >> 32, num_categories + 1, rounding_mode="floor")
    seg_cat = (seg_keys >> 32) - seg_image * (num_categories + 1)
    seg_void = seg_cat == void  # void pixels all carry instance 0
    per_image = torch.bincount(seg_image, minlength=batch)
    first = torch.cumsum(per_image, 0) - per_image
    local = seg - first[:, None]  # each image's segments numbered from 0
    width = int(per_image.max()) if batch else 0
    cells = width * width
    if cells > _MAX_BINS:
        raise ValueError(
            f"An image of this batch has {width} segments; its pair table of {cells} cells passes the"
            " bincount kernel's 2^31 bins."
        )
    # the pred x target pair table of every image, counted by the bincount kernel
    per_launch = max(1, _MAX_BINS // max(cells, 1))
    tables = []
    for start in range(0, batch, per_launch):
        images = min(per_launch, batch - start)
        rows = torch.arange(images, dtype=torch.int64, device=device)[:, None] * cells
        ids = rows + local[start:start + images, :pixels] * width + local[start:start + images, pixels:]
        tables.append(kernels.bincount(ids, None, images * cells).view(images, width, width))
    table = (torch.cat(tables) if len(tables) != 1 else tables[0]).to(torch.int64)  # [B, S, S]

    slot = torch.arange(width, device=device)
    in_image = slot[None, :] < per_image[:, None]  # [B, S]
    seg_at = (first[:, None] + slot[None, :]).clamp(max=max(seg_keys.shape[0] - 1, 0))
    cat = torch.where(in_image, seg_cat[seg_at], -1)  # [B, S]
    is_void = in_image & seg_void[seg_at]
    pred_area = table.sum(dim=2)
    target_area = table.sum(dim=1)
    # the void segment of each image, if any: its column / row of the table
    void_slot = torch.where(is_void.any(dim=1), is_void.to(torch.int64).argmax(dim=1), -1)
    has_void = (void_slot >= 0)[:, None]
    at_void = void_slot.clamp(min=0)[:, None]
    pred_void = torch.where(has_void, table.gather(2, at_void[:, :, None].expand(batch, width, 1))[..., 0], 0)
    void_target = torch.where(has_void, table.gather(1, at_void[:, None, :].expand(batch, 1, width))[:, 0], 0)

    # pairs that intersect, of one category, with a target that is not void
    pair = (table > 0) & (cat[:, :, None] == cat[:, None, :]) & ~is_void[:, None, :] & in_image[:, :, None]
    union = (pred_area - pred_void)[:, :, None] + (target_area - void_target)[:, None, :] - table
    iou = table.to(torch.float64) / torch.where(pair, union, 1).to(torch.float64)
    stuff_pair = pair & scored_stuff[cat.clamp(min=0)][:, None, :]
    match = pair & ~stuff_pair & (iou > 0.5)
    credit = match | (stuff_pair & (iou > 0))
    pair_cat = cat[:, None, :].expand(batch, width, width)

    iou_sum = torch.zeros(num_categories + 1, dtype=torch.float64, device=device)
    iou_sum.index_add_(0, pair_cat[credit], iou[credit])
    true_positives = torch.bincount(pair_cat[match], minlength=num_categories + 1)

    seg_stuff = scored_stuff[cat.clamp(min=0)]
    target_seen = in_image & (target_area > 0) & ~is_void & ~seg_stuff
    pred_seen = in_image & (pred_area > 0) & ~is_void & ~seg_stuff
    fn = target_seen & ~match.any(dim=1) & (void_target.to(torch.float64) / target_area.clamp(min=1) <= 0.5)
    fp = pred_seen & ~match.any(dim=2) & (pred_void.to(torch.float64) / pred_area.clamp(min=1) <= 0.5)
    false_negatives = torch.bincount(cat[fn], minlength=num_categories + 1)
    false_positives = torch.bincount(cat[fp], minlength=num_categories + 1)
    # the modified metric counts each present stuff segment once as a "TP" denominator
    stuff_seen = in_image & (target_area > 0) & seg_stuff
    true_positives = true_positives + torch.bincount(cat[stuff_seen], minlength=num_categories + 1)
    return (
        iou_sum[:num_categories].to(torch.float32),
        true_positives[:num_categories].to(torch.int32),
        false_positives[:num_categories].to(torch.int32),
        false_negatives[:num_categories].to(torch.int32),
    )


def _panoptic_quality_compute(
    iou_sum: Tensor,
    true_positives: Tensor,
    false_positives: Tensor,
    false_negatives: Tensor,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Per-class and average panoptic/segmentation/recognition quality."""
    sq = torch.where(true_positives > 0, iou_sum / torch.clamp(true_positives, min=1), 0.0)
    denominator = true_positives + 0.5 * false_positives + 0.5 * false_negatives
    rq = torch.where(
        denominator > 0, true_positives / torch.where(denominator > 0, denominator, 1.0), 0.0
    )
    pq = sq * rq
    valid = denominator > 0
    count = torch.clamp(valid.sum(), min=1)
    pq_avg = torch.where(valid, pq, 0.0).sum() / count
    sq_avg = torch.where(valid, sq, 0.0).sum() / count
    rq_avg = torch.where(valid, rq, 0.0).sum() / count
    return pq, sq, rq, pq_avg, sq_avg, rq_avg


def _update_from_maps(
    preds: Tensor,
    target: Tensor,
    things: Set[int],
    stuffs: Set[int],
    allow_unknown_preds_category: bool,
    modified_metric_stuffs: Optional[Set[int]] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Validate, preprocess both maps and count one batch."""
    preds = torch.as_tensor(preds)
    target = torch.as_tensor(target, device=preds.device)
    _validate_inputs(preds, target)
    categories = _Categories(things, stuffs, preds.device)
    pred_cont, pred_inst = _prepocess_inputs(things, stuffs, preds, allow_unknown_preds_category, categories)
    target_cont, target_inst = _prepocess_inputs(things, stuffs, target, True, categories)
    return _panoptic_quality_update(
        pred_cont, pred_inst, target_cont, target_inst, _get_category_id_to_continuous_id(things, stuffs),
        modified_metric_stuffs,
    )


def panoptic_quality(
    preds: Tensor,
    target: Tensor,
    things: Collection[int],
    stuffs: Collection[int],
    allow_unknown_preds_category: bool = False,
    return_sq_and_rq: bool = False,
    return_per_class: bool = False,
) -> Tensor:
    r"""Compute panoptic quality of (category, instance) panoptic maps.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.detection import panoptic_quality
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
        >>> panoptic_quality(preds, target, things={0, 1}, stuffs={6, 7}).round(decimals=4)
        tensor(0.5463)
    """
    things_set, stuffs_set = _parse_categories(things, stuffs)
    iou_sum, tp, fp, fn = _update_from_maps(preds, target, things_set, stuffs_set, allow_unknown_preds_category)
    pq, sq, rq, pq_avg, sq_avg, rq_avg = _panoptic_quality_compute(iou_sum, tp, fp, fn)
    if return_per_class:
        if return_sq_and_rq:
            return torch.stack((pq, sq, rq), dim=-1)
        return pq.reshape(1, -1)
    if return_sq_and_rq:
        return torch.stack((pq_avg, sq_avg, rq_avg), dim=0)
    return pq_avg


def modified_panoptic_quality(
    preds: Tensor,
    target: Tensor,
    things: Collection[int],
    stuffs: Collection[int],
    allow_unknown_preds_category: bool = False,
) -> Tensor:
    r"""Compute modified panoptic quality (stuff classes scored without matching).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.detection import modified_panoptic_quality
        >>> preds = torch.tensor([[[0, 0], [0, 1], [6, 0], [7, 0], [0, 2], [1, 0]]])
        >>> target = torch.tensor([[[0, 1], [0, 0], [6, 0], [7, 0], [6, 0], [255, 0]]])
        >>> modified_panoptic_quality(preds, target, things={0, 1}, stuffs={6, 7},
        ...                           allow_unknown_preds_category=True).round(decimals=4)
        tensor(0.7667)
    """
    things_set, stuffs_set = _parse_categories(things, stuffs)
    iou_sum, tp, fp, fn = _update_from_maps(
        preds, target, things_set, stuffs_set, allow_unknown_preds_category, modified_metric_stuffs=stuffs_set
    )
    _, _, _, pq_avg, _, _ = _panoptic_quality_compute(iou_sum, tp, fp, fn)
    return pq_avg
