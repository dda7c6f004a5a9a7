"""Mean average precision (COCO-style), with the greedy matcher batched on the device.

Counterpart of ``torchmetrics_tpu/detection/mean_ap.py``: the same states (per-image
lists, or ``MaskedBuffer`` rows with bit-packed masks), arguments, messages, result
keys and values. JAX runs the COCO matcher on the host, a Python loop over class,
image, area range, IoU threshold and detection. Here ``compute`` is one batched pass:

- every (image, class) pair with a detection or a ground truth is a *group*. A group's
  detections are its class's detections in the image, sorted by score (stable, so ties
  keep their order) and cut to the last max-detection threshold; its ground truths
  keep theirs;
- the groups that have both are bucketed by their detection count (powers of two) and
  padded. A bucket's IoU matrices are computed in float32 in numpy's order of
  operations (areas, corners, clip, intersection, ``inter / (a_d + a_g - inter)``), so
  every IoU is numpy's bit for bit; masks are counted by a full-float32 product;
- the greedy matcher then runs as a loop over detection rank only: each step matches
  one rank of every group, for all four area ranges and all IoU thresholds at once.
  A step keeps JAX's arithmetic exactly: the candidates are ``iou * available`` (a
  product, so a NaN IoU stays a candidate), the pick is the first maximum in the order
  that puts the ignored ground truths last (the first NaN where there is one), and the
  threshold test is ``not (candidate <= threshold)`` in float32;
- accumulation sorts every kept detection once by (class, score, image, rank), takes
  each max-detection prefix as a mask, and forms the cumulative true and false
  positives per class segment exactly (integer counts, then float64 as numpy has
  them). The precision envelope is a segmented suffix maximum (a selection, so exact),
  and the recall-threshold lookup is an integer search: the first cumulative count
  whose float64 recall reaches the threshold.

The precision, recall and score surfaces, the matches and the IoUs therefore equal
JAX's exactly; the summary means are float64 sums in another order, cast to float32.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch.core.buffer import MaskedBuffer
from torchmetrics_tpu_torch.core.metric import Metric
from torchmetrics_tpu_torch.detection.helpers import _fix_empty_tensors, _input_validator
from torchmetrics_tpu_torch.functional.detection.box_ops import box_area, box_convert, box_iou
from torchmetrics_tpu_torch.utils.compute import _matmul_full_float32

Tensor = torch.Tensor

_BBOX_AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def _pack_mask_bits(masks: Tensor, packed_len: int) -> Tensor:
    """Bit-pack boolean masks: (n, H, W) -> (n, packed_len) uint8, big-endian bit order
    (``np.unpackbits``-compatible), on the masks' device."""
    if masks.shape[0] == 0:
        return torch.zeros((0, packed_len), dtype=torch.uint8, device=masks.device)
    flat = masks.reshape(masks.shape[0], -1).to(torch.int32)
    flat = torch.nn.functional.pad(flat, (0, packed_len * 8 - flat.shape[1]))
    groups = flat.reshape(flat.shape[0], packed_len, 8)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=masks.device)
    return torch.sum(groups * weights, dim=-1).to(torch.uint8)


def _unpack_mask_bits(rows: Tensor, mask_shape: Tuple[int, int]) -> Tensor:
    """Inverse of :func:`_pack_mask_bits`: (n, packed_len) -> (n, H, W) bool, on the rows' device."""
    n = rows.shape[0]
    if n == 0:
        return torch.zeros((0, *mask_shape), dtype=torch.bool, device=rows.device)
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=rows.device)
    bits = (rows.to(torch.uint8)[:, :, None] >> shifts) & 1
    return bits.reshape(n, -1)[:, : mask_shape[0] * mask_shape[1]].reshape(n, *mask_shape).to(torch.bool)


class _Samples:
    """Every image's detections and ground truths as flat tensors (layout-independent).

    ``det_image``/``gt_image`` give each row's image; within an image rows keep their
    input order. Masks are a callable ``(image) -> (det masks, gt masks)`` of that
    image, each ``[n, H*W]`` float32, for ``iou_type="segm"``.
    """

    def __init__(
        self,
        num_images: int,
        det_boxes: Tensor,
        det_scores: Tensor,
        det_labels: Tensor,
        det_image: Tensor,
        gt_boxes: Tensor,
        gt_labels: Tensor,
        gt_image: Tensor,
        masks: Optional[Any] = None,
    ) -> None:
        self.num_images = num_images
        self.det_boxes = det_boxes
        self.det_scores = det_scores
        self.det_labels = det_labels
        self.det_image = det_image
        self.gt_boxes = gt_boxes
        self.gt_labels = gt_labels
        self.gt_image = gt_image
        self.masks = masks

    def classes(self) -> List[int]:
        return torch.unique(torch.cat([self.det_labels, self.gt_labels])).tolist()

    def relabeled_to_single_class(self) -> "_Samples":
        """Micro averaging pools every class (reference ``mean_ap.py:552-555``)."""
        return _Samples(
            self.num_images, self.det_boxes, self.det_scores, torch.zeros_like(self.det_labels), self.det_image,
            self.gt_boxes, torch.zeros_like(self.gt_labels), self.gt_image, self.masks,
        )


def _flat(x: Tensor) -> Tensor:
    """``[n, ...]`` -> ``[n, prod(...)]`` float32 (an empty ``(0, 0, 0)`` too)."""
    return x.reshape(x.shape[0], int(np.prod(x.shape[1:]))).to(torch.float32)


def _starts(counts: Tensor) -> Tensor:
    """Exclusive prefix sums of ``counts``."""
    return torch.cumsum(counts, 0) - counts


def _segm_pair_ious(samples: _Samples, det_start: Tensor, gt_start: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Mask IoUs of every (detection, ground truth) pair of each image, in a flat table
    (image by image, ``[D_i, G_i]`` row-major), and each row's pixel area (float64).
    Returns (table, table offset per image, detection areas, ground-truth areas)."""
    device = samples.det_scores.device
    det_counts = torch.bincount(samples.det_image, minlength=samples.num_images).tolist()
    gt_counts = torch.bincount(samples.gt_image, minlength=samples.num_images).tolist()
    det_area = torch.zeros(samples.det_image.shape[0], dtype=torch.float64, device=device)
    gt_area = torch.zeros(samples.gt_image.shape[0], dtype=torch.float64, device=device)
    blocks, offsets, offset = [], [], 0
    ds, gs = det_start.tolist(), gt_start.tolist()
    for i in range(samples.num_images):
        offsets.append(offset)
        nd, ng = det_counts[i], gt_counts[i]
        if not nd and not ng:
            continue
        d, g = samples.masks(i)
        d_sum, g_sum = d.sum(dim=1), g.sum(dim=1)
        det_area[ds[i]: ds[i] + nd] = d_sum.to(torch.float64)
        gt_area[gs[i]: gs[i] + ng] = g_sum.to(torch.float64)
        if nd and ng:
            inter = _matmul_full_float32(d, g.T)
            union = d_sum[:, None] + g_sum[None, :] - inter
            blocks.append(torch.where(union > 0, inter / union, 0.0).reshape(-1))
            offset += nd * ng
    table = torch.cat(blocks) if blocks else torch.zeros(0, device=device)
    return table, torch.tensor(offsets, dtype=torch.int64, device=device), det_area, gt_area


class _Evaluation:
    """The batched COCO evaluation of one set of samples."""

    def __init__(self, metric: "MeanAveragePrecision", samples: _Samples) -> None:
        self.metric = metric
        self.samples = samples

    def run(self, keep_ious: bool) -> Tuple[Tensor, Tensor, Tensor, Dict]:
        """precision[T,R,K,A,M], recall[T,K,A,M], scores[T,R,K,A,M] (float64, -1 where
        unset) and the IoU dict keyed (image, class)."""
        m, s = self.metric, self.samples
        device = s.det_scores.device
        num_thrs, num_rec = len(m.iou_thresholds), len(m.rec_thresholds)
        num_areas, num_maxdet = len(_BBOX_AREA_RANGES), len(m.max_detection_thresholds)
        classes_t = torch.unique(torch.cat([s.det_labels, s.gt_labels]))
        class_list = classes_t.tolist()
        num_cls = len(class_list)
        precision = -torch.ones((num_thrs, num_rec, num_cls, num_areas, num_maxdet), dtype=torch.float64, device=device)
        recall = -torch.ones((num_thrs, num_cls, num_areas, num_maxdet), dtype=torch.float64, device=device)
        score_surface = precision.clone()
        ious_out: Dict = {}
        if num_cls == 0:
            return precision, recall, score_surface, ious_out
        num_images = s.num_images
        cap = m.max_detection_thresholds[-1]

        # ---- groups: (class, image) keys; detections by (key, -score, input order)
        det_key = torch.searchsorted(classes_t, s.det_labels) * num_images + s.det_image
        gt_key = torch.searchsorted(classes_t, s.gt_labels) * num_images + s.gt_image
        neg = -s.det_scores
        neg = torch.where(torch.isnan(neg), float("nan"), neg + 0.0)  # one NaN and one zero for the sort
        order = torch.argsort(neg, stable=True)
        order = order[torch.argsort(det_key[order], stable=True)]
        sorted_key = det_key[order]
        _, det_counts_all = torch.unique_consecutive(sorted_key, return_counts=True)
        rank = torch.arange(order.shape[0], device=device) - torch.repeat_interleave(_starts(det_counts_all), det_counts_all)
        keep = rank < cap
        kept = order[keep]  # kept detections, by (class, image, rank)
        kept_key, kept_rank = sorted_key[keep], rank[keep]
        gorder = torch.argsort(gt_key, stable=True)
        gt_sorted_key = gt_key[gorder]
        group_keys = torch.unique(torch.cat([sorted_key, gt_sorted_key]))
        num_groups = group_keys.shape[0]
        kept_group = torch.searchsorted(group_keys, kept_key)
        gt_group = torch.searchsorted(group_keys, gt_sorted_key)
        d_count = torch.bincount(kept_group, minlength=num_groups)
        g_count = torch.bincount(gt_group, minlength=num_groups)
        d_start, g_start = _starts(d_count), _starts(g_count)
        group_cls = torch.div(group_keys, num_images, rounding_mode="floor")
        group_img = group_keys - group_cls * num_images

        # ---- areas and the pairs' IoUs
        bounds = torch.tensor(list(_BBOX_AREA_RANGES.values()), device=device)
        if m.iou_type == "segm":
            det_img_start = _starts(torch.bincount(s.det_image, minlength=num_images))
            gt_per_image = torch.bincount(s.gt_image, minlength=num_images)
            gt_img_start = _starts(gt_per_image)
            table, table_off, det_area_all, gt_area_all = _segm_pair_ious(s, det_img_start, gt_img_start)
            det_area, gt_area = det_area_all[kept], gt_area_all[gorder]
            bounds = bounds.to(torch.float64)
        else:
            det_area, gt_area = box_area(s.det_boxes[kept]), box_area(s.gt_boxes[gorder])
            bounds = bounds.to(torch.float32)
        det_ooa = (det_area[None, :] < bounds[:, 0:1]) | (det_area[None, :] > bounds[:, 1:2])  # [A, Nk]
        gt_ooa = (gt_area[None, :] < bounds[:, 0:1]) | (gt_area[None, :] > bounds[:, 1:2])  # [A, Ng]

        # ---- the greedy matcher, batched over groups, area ranges and thresholds
        num_kept = kept.shape[0]
        det_matches = torch.zeros((num_areas, num_thrs, num_kept), dtype=torch.bool, device=device)
        det_ignore = torch.zeros_like(det_matches)
        thresholds = torch.tensor(m.iou_thresholds, dtype=torch.float32, device=device)
        both = (d_count > 0) & (g_count > 0)
        bucket_of = torch.ceil(torch.log2(d_count.clamp(min=1).to(torch.float64))).to(torch.int64)
        if keep_ious:
            # a group with no detection or no ground truth has an empty matrix; one tensor
            # of each empty shape serves them all
            empties: Dict[Tuple[int, int], Tensor] = {}

            def empty(shape: Tuple[int, int]) -> Tensor:
                if shape not in empties:
                    empties[shape] = torch.zeros(shape, dtype=torch.float32, device=device)
                return empties[shape]

            ious_out = {(i, c): empty((0, 0)) for c in class_list for i in range(num_images)}
            for cl, img, nd, ng in zip(group_cls.tolist(), group_img.tolist(), d_count.tolist(), g_count.tolist()):
                if not (nd and ng):  # the matched groups' matrices come from their buckets
                    ious_out[(img, class_list[cl])] = empty((nd, ng))
        with torch.profiler.record_function("MeanAveragePrecision.match"):
            for b in torch.unique(bucket_of[both]).tolist():
                gids = torch.nonzero(both & (bucket_of == b)).reshape(-1)
                dg, gg = d_count[gids], g_count[gids]
                dmax, gmax = int(dg.max()), int(gg.max())
                det_idx = d_start[gids, None] + torch.arange(dmax, device=device)
                det_valid = torch.arange(dmax, device=device) < dg[:, None]
                det_idx = torch.where(det_valid, det_idx, 0)
                gt_idx = g_start[gids, None] + torch.arange(gmax, device=device)
                gt_valid = torch.arange(gmax, device=device) < gg[:, None]
                gt_idx = torch.where(gt_valid, gt_idx, 0)
                if m.iou_type == "segm":
                    k_det, k_gt = kept[det_idx], gorder[gt_idx]
                    img = group_img[gids][:, None, None]
                    n_gt_img = gt_per_image[img]
                    d_local = (k_det - det_img_start[s.det_image[k_det]])[:, :, None]
                    g_local = (k_gt - gt_img_start[s.gt_image[k_gt]])[:, None, :]
                    pair = table_off[img] + d_local * n_gt_img + g_local
                    valid_pair = det_valid[:, :, None] & gt_valid[:, None, :]
                    iou = torch.where(valid_pair, table[torch.where(valid_pair, pair, 0)], 0.0) if table.numel() else \
                        torch.zeros(valid_pair.shape, device=device)
                else:
                    iou = box_iou(s.det_boxes[kept[det_idx]], s.gt_boxes[gorder[gt_idx]])
                if keep_ious:
                    for j, (img, cl, nd, ng) in enumerate(zip(
                        group_img[gids].tolist(), group_cls[gids].tolist(), dg.tolist(), gg.tolist()
                    )):
                        ious_out[(img, class_list[cl])] = iou[j, :nd, :ng]
                dm, di = self._match(iou, det_valid, gt_valid, gt_ooa[:, gt_idx].permute(1, 0, 2), thresholds)
                flat = det_idx[det_valid]
                det_matches[:, :, flat] = dm.permute(1, 2, 0, 3)[:, :, det_valid]
                det_ignore[:, :, flat] = di.permute(1, 2, 0, 3)[:, :, det_valid]
        det_ignore |= ~det_matches & det_ooa[:, None, :]

        # ---- accumulation
        with torch.profiler.record_function("MeanAveragePrecision.accumulate"):
            kept_cls = torch.div(kept_key, num_images, rounding_mode="floor")
            acc = torch.argsort(neg[kept], stable=True)
            acc = acc[torch.argsort(kept_cls[acc], stable=True)]
            tps = (det_matches & ~det_ignore)[:, :, acc]
            fps = (~det_matches & ~det_ignore)[:, :, acc]
            acc_cls, acc_rank, acc_scores = kept_cls[acc], kept_rank[acc], s.det_scores[kept][acc]
            gt_cls_sorted = torch.div(gt_sorted_key, num_images, rounding_mode="floor")
            npig = torch.zeros((num_areas, num_cls), dtype=torch.int64, device=device)
            npig.index_add_(1, gt_cls_sorted, (~gt_ooa).to(torch.int64))
            rec_thrs = torch.tensor(m.rec_thresholds, dtype=torch.float64, device=device)
            for m_idx, max_det in enumerate(m.max_detection_thresholds):
                sel = torch.nonzero(acc_rank < max_det).reshape(-1)
                prec, rc_last, score_at = self._accumulate_prefix(
                    tps[:, :, sel], fps[:, :, sel], acc_cls[sel], acc_scores[sel], npig, rec_thrs, num_cls
                )
                has_gt = (npig > 0).T  # [K, A]: a class with no ground truth in the range stays -1
                precision[..., m_idx] = torch.where(has_gt, prec.permute(1, 3, 2, 0), -1.0)
                score_surface[..., m_idx] = torch.where(has_gt, score_at.permute(1, 3, 2, 0), -1.0)
                recall[..., m_idx] = torch.where(has_gt, rc_last.permute(1, 2, 0), -1.0)
        return precision, recall, score_surface, ious_out

    @staticmethod
    def _match(
        iou: Tensor, det_valid: Tensor, gt_valid: Tensor, gt_ignore: Tensor, thresholds: Tensor
    ) -> Tuple[Tensor, Tensor]:
        """JAX's greedy matcher (``mean_ap.py:467-477``) over a bucket of groups.

        ``iou`` [G, D, N] (detections by score, ground truths in input order),
        ``gt_ignore`` [G, A, N] (out of each area range). Returns the detections'
        matches and ignores [G, A, T, D]."""
        groups, dmax, gmax = iou.shape
        num_areas, num_thrs = gt_ignore.shape[1], thresholds.shape[0]
        device = iou.device
        col = torch.arange(gmax, device=device)
        # numpy's argmax over the ground truths sorted ignored-last takes the first
        # maximum in (ignored, index) order; padding sorts after everything
        key = torch.where(gt_valid[:, None, :], gt_ignore.to(torch.int64) * gmax + col, 2 * gmax + col)[:, :, None, :]
        big = torch.tensor(4 * gmax, dtype=torch.int64, device=device)
        ignored = gt_ignore[:, :, None, :]
        valid = gt_valid[:, None, None, :]
        neg_inf = torch.tensor(float("-inf"), dtype=iou.dtype, device=device)
        gt_matched = torch.zeros((groups, num_areas, num_thrs, gmax), dtype=torch.bool, device=device)
        det_matches = torch.zeros((groups, num_areas, num_thrs, dmax), dtype=torch.bool, device=device)
        det_ignore = torch.zeros_like(det_matches)
        ignored_t = ignored.expand(groups, num_areas, num_thrs, gmax)
        for d in range(dmax):
            available = ~(gt_matched | ignored)
            cand = iou[:, d, None, None, :] * available.to(iou.dtype)
            cand = torch.where(valid, cand, neg_inf)
            isnan = torch.isnan(cand)
            best = torch.where(isnan, neg_inf, cand).amax(dim=-1, keepdim=True)
            pick = torch.where(isnan.any(dim=-1, keepdim=True), isnan, cand == best)
            m = torch.where(pick, key, big).argmin(dim=-1, keepdim=True)
            chosen = cand.gather(-1, m)[..., 0]
            match = ~(chosen <= thresholds) & det_valid[:, d, None, None]
            det_matches[..., d] = match
            det_ignore[..., d] = match & ignored_t.gather(-1, m)[..., 0]
            gt_matched |= match[..., None] & (col == m)
        return det_matches, det_ignore

    @staticmethod
    def _accumulate_prefix(
        tps: Tensor, fps: Tensor, cls: Tensor, scores: Tensor, npig: Tensor, rec_thrs: Tensor, num_cls: int
    ) -> Tuple[Tensor, Tensor, Tensor]:
        """One max-detection prefix: tps/fps [A, T, N] in (class, score, image, rank)
        order. Returns precision and scores [A, T, K, R] and the last recall [A, T, K]."""
        num_areas, num_thrs, n = tps.shape
        device = tps.device
        num_rec = rec_thrs.shape[0]
        if n == 0:  # no detection in this prefix: recall 0, precision and scores 0
            zeros = torch.zeros((num_areas, num_thrs, num_cls, num_rec), dtype=torch.float64, device=device)
            return zeros, zeros[..., 0].clone(), zeros.clone()
        counts = torch.bincount(cls, minlength=num_cls)
        seg_end = torch.cumsum(counts, 0)
        seg_start = seg_end - counts
        # cumulative counts within each class segment, exactly (integers)
        tp_cs = torch.cumsum(tps.to(torch.int64), -1)
        fp_cs = torch.cumsum(fps.to(torch.int64), -1)
        before = torch.cat([torch.zeros((num_areas, num_thrs, 1), dtype=torch.int64, device=device), tp_cs], -1)
        before_fp = torch.cat([torch.zeros((num_areas, num_thrs, 1), dtype=torch.int64, device=device), fp_cs], -1)
        tp_int = tp_cs - before[..., seg_start][..., cls]
        fp_int = fp_cs - before_fp[..., seg_start][..., cls]
        tp = tp_int.to(torch.float64)
        fp = fp_int.to(torch.float64)
        npig_d = npig.to(torch.float64)  # [A, K]
        rc = tp / npig_d[:, None, :][..., cls]
        pr = tp / (fp + tp + np.finfo(np.float64).eps)
        last = (seg_end - 1).clamp(min=0)
        rc_last = torch.where(counts > 0, rc[..., last], 0.0)
        # precision envelope: suffix maximum within each class segment (log-step doubling)
        env = pr
        end = seg_end[cls]
        pos = torch.arange(n, device=device)
        step, longest = 1, int(counts.max()) if num_cls else 0
        while step < longest:
            nxt = pos + step
            ok = nxt < end
            env = torch.where(ok, torch.maximum(env, env[..., nxt.clamp(max=n - 1)]), env)
            step *= 2
        # the first count whose float64 recall reaches each threshold: the smallest
        # integer v with fl(v / npig) >= r is within one of ceil(r * npig)
        r = rec_thrs[None, None, :]
        base = (torch.ceil(r * npig_d[:, :, None]) - 1).clamp(min=0)
        tp_star = base + 3
        for k in (2, 1, 0):
            v = base + k
            tp_star = torch.where(v / npig_d[:, :, None] >= r, v, tp_star)
        tp_star = tp_star.clamp(max=n + 1).to(torch.int64)  # [A, K, R]
        stride = n + 2
        keys = cls * stride + tp_int  # nondecreasing along each row
        queries = (torch.arange(num_cls, device=device)[None, :, None] * stride + tp_star)  # [A, K, R]
        queries = queries[:, None].expand(num_areas, num_thrs, num_cls, num_rec)
        found = torch.searchsorted(
            keys.reshape(num_areas * num_thrs, n).contiguous(),
            queries.reshape(num_areas * num_thrs, num_cls * num_rec).contiguous(),
        ).reshape(num_areas, num_thrs, num_cls, num_rec)
        valid = found < seg_end[None, None, :, None]
        at = found.clamp(max=n - 1)
        prec = torch.where(valid, env.gather(-1, at.reshape(num_areas, num_thrs, -1)).reshape(at.shape), 0.0)
        score_at = torch.where(valid, scores.to(torch.float64)[at], 0.0)
        return prec, rc_last, score_at


class MeanAveragePrecision(Metric):
    r"""COCO mean average precision / mean average recall for object detection.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.detection import MeanAveragePrecision
        >>> preds = [{"boxes": torch.tensor([[258.0, 41.0, 606.0, 285.0]]),
        ...           "scores": torch.tensor([0.536]),
        ...           "labels": torch.tensor([0])}]
        >>> target = [{"boxes": torch.tensor([[214.0, 41.0, 562.0, 285.0]]),
        ...            "labels": torch.tensor([0])}]
        >>> metric = MeanAveragePrecision(device="cpu")
        >>> metric.update(preds, target)
        >>> result = metric.compute()
        >>> result["map_50"].round(decimals=4)
        tensor(1.)
    """

    is_differentiable = False
    higher_is_better = True
    full_state_update = True
    plot_lower_bound: float = 0.0
    plot_upper_bound: float = 1.0

    def __init__(
        self,
        box_format: str = "xyxy",
        iou_type: str = "bbox",
        iou_thresholds: Optional[List[float]] = None,
        rec_thresholds: Optional[List[float]] = None,
        max_detection_thresholds: Optional[List[int]] = None,
        class_metrics: bool = False,
        extended_summary: bool = False,
        average: str = "macro",
        buffer_capacity: Optional[int] = None,
        image_capacity: Optional[int] = None,
        mask_shape: Optional[Tuple[int, int]] = None,
        **kwargs: Any,
    ) -> None:
        kwargs.setdefault("jit_update", False)
        super().__init__(**kwargs)

        allowed_box_formats = ("xyxy", "xywh", "cxcywh")
        if box_format not in allowed_box_formats:
            raise ValueError(f"Expected argument `box_format` to be one of {allowed_box_formats} but got {box_format}")
        self.box_format = box_format
        if iou_type not in ("bbox", "segm"):
            raise ValueError(f"Expected argument `iou_type` to be one of ('bbox', 'segm') but got {iou_type}")
        self.iou_type = iou_type
        self.iou_thresholds = iou_thresholds or np.linspace(0.5, 0.95, 10).round(2).tolist()
        self.rec_thresholds = rec_thresholds or np.linspace(0.0, 1.0, 101).round(2).tolist()
        self.max_detection_thresholds = sorted(max_detection_thresholds or [1, 10, 100])
        if not isinstance(class_metrics, bool):
            raise ValueError("Expected argument `class_metrics` to be a boolean")
        self.class_metrics = class_metrics
        if not isinstance(extended_summary, bool):
            raise ValueError("Expected argument `extended_summary` to be a boolean")
        self.extended_summary = extended_summary
        if average not in ("macro", "micro"):
            raise ValueError(f"Expected argument `average` to be one of ('macro', 'micro') but got {average}")
        self.average = average

        if mask_shape is not None and (iou_type != "segm" or buffer_capacity is None):
            raise ValueError(
                "Argument `mask_shape` is only used by the buffered segm layout"
                " (`iou_type='segm'` together with `buffer_capacity`)"
            )
        self._buffered = buffer_capacity is not None
        if self._buffered:
            image_capacity = image_capacity or 256
            # rows are [x1, y1, x2, y2, score, label] / [x1, y1, x2, y2, label]
            self.add_state("det_rows", MaskedBuffer.create(buffer_capacity, (6,)), dist_reduce_fx="cat")
            self.add_state(
                "det_sizes", MaskedBuffer.create(image_capacity, (), dtype=torch.int32), dist_reduce_fx="cat"
            )
            self.add_state("gt_rows", MaskedBuffer.create(buffer_capacity, (5,)), dist_reduce_fx="cat")
            self.add_state("gt_sizes", MaskedBuffer.create(image_capacity, (), dtype=torch.int32), dist_reduce_fx="cat")
            if iou_type == "segm":
                if mask_shape is None:
                    raise ValueError(
                        "Buffered (mesh-syncable) segm states need a static `mask_shape=(H, W)`;"
                        " pass it, or use the default list-mode states (no `buffer_capacity`)"
                        " whose ragged masks sync via the eager multihost gather."
                    )
                self.mask_shape = (int(mask_shape[0]), int(mask_shape[1]))
                self._packed_len = -(-(self.mask_shape[0] * self.mask_shape[1]) // 8)
                self.add_state(
                    "det_mask_rows",
                    MaskedBuffer.create(buffer_capacity, (self._packed_len,), dtype=torch.uint8),
                    dist_reduce_fx="cat",
                )
                self.add_state(
                    "gt_mask_rows",
                    MaskedBuffer.create(buffer_capacity, (self._packed_len,), dtype=torch.uint8),
                    dist_reduce_fx="cat",
                )
        else:
            self.add_state("detections", [], dist_reduce_fx=None)
            self.add_state("detection_scores", [], dist_reduce_fx=None)
            self.add_state("detection_labels", [], dist_reduce_fx=None)
            self.add_state("groundtruths", [], dist_reduce_fx=None)
            self.add_state("groundtruth_labels", [], dist_reduce_fx=None)
            if iou_type == "segm":
                self.add_state("detection_masks", [], dist_reduce_fx=None)
                self.add_state("groundtruth_masks", [], dist_reduce_fx=None)

    # ------------------------------------------------------------------ state update

    def _canonical_masks(self, masks: Any) -> Tensor:
        """Masks as a rank-3 bool tensor on the metric's device: a 1-D empty array
        becomes (0, 0, 0), as ``_fix_empty_tensors`` does for boxes."""
        arr = torch.as_tensor(masks, device=self.device).to(torch.bool)
        if arr.numel() == 0 and arr.ndim != 3:
            return arr.reshape(0, 0, 0)
        return arr

    def _convert_boxes(self, boxes: Any) -> Tensor:
        boxes = _fix_empty_tensors(torch.as_tensor(boxes, dtype=torch.float32, device=self.device))
        if boxes.ndim != 2 or boxes.shape[-1] != 4:
            boxes = boxes.reshape(-1, 4)
        if boxes.numel():
            boxes = box_convert(boxes, in_fmt=self.box_format, out_fmt="xyxy")
        return boxes

    def _boxes_of(self, item: Dict[str, Any]) -> Tensor:
        if "boxes" in item:
            return self._convert_boxes(item["boxes"])
        n = torch.as_tensor(item["labels"]).reshape(-1).shape[0]
        return torch.zeros((n, 4), dtype=torch.float32, device=self.device)

    def update(self, preds: Sequence[Dict[str, Tensor]], target: Sequence[Dict[str, Tensor]]) -> None:
        """Store per-image detections and ground truths."""
        _input_validator(preds, target, iou_type=self.iou_type)
        if self._buffered:
            self._update_buffered(preds, target)
            return
        device = self.device
        for item in preds:
            self.detections.append(self._boxes_of(item))
            self.detection_labels.append(torch.as_tensor(item["labels"], device=device))
            self.detection_scores.append(torch.as_tensor(item["scores"], device=device))
            if self.iou_type == "segm":
                self.detection_masks.append(self._canonical_masks(item["masks"]))
        for item in target:
            self.groundtruths.append(self._boxes_of(item))
            self.groundtruth_labels.append(torch.as_tensor(item["labels"], device=device))
            if self.iou_type == "segm":
                self.groundtruth_masks.append(self._canonical_masks(item["masks"]))

    def _checked_masks(self, item: Dict[str, Tensor], n_rows: int) -> Tensor:
        masks = torch.as_tensor(item["masks"], device=self.device).to(torch.bool)
        if masks.numel() == 0 and n_rows == 0:
            return torch.zeros((0, *self.mask_shape), dtype=torch.bool, device=self.device)
        if masks.ndim != 3 or tuple(masks.shape[-2:]) != self.mask_shape or masks.shape[0] != n_rows:
            raise ValueError(
                f"Buffered segm states hold per-image masks of static shape"
                f" ({n_rows}, {self.mask_shape[0]}, {self.mask_shape[1]}) for this item,"
                f" but got an array of shape {tuple(masks.shape)}."
            )
        return masks

    def _update_buffered(self, preds: Sequence[Dict[str, Tensor]], target: Sequence[Dict[str, Tensor]]) -> None:
        # one append per state per call (not per image)
        segm = self.iou_type == "segm"
        device = self.device
        for items, rows_name, sizes_name, masks_name, with_scores in (
            (preds, "det_rows", "det_sizes", "det_mask_rows", True),
            (target, "gt_rows", "gt_sizes", "gt_mask_rows", False),
        ):
            rows, sizes, mask_rows = [], [], []
            for item in items:
                cols = [self._boxes_of(item).reshape(-1, 4)]
                if with_scores:
                    cols.append(torch.as_tensor(item["scores"], device=device).to(torch.float32).reshape(-1, 1))
                cols.append(torch.as_tensor(item["labels"], device=device).to(torch.float32).reshape(-1, 1))
                r = torch.cat(cols, dim=1)
                rows.append(r)
                sizes.append(r.shape[0])
                if segm:
                    mask_rows.append(_pack_mask_bits(self._checked_masks(item, r.shape[0]), self._packed_len))
            if rows:
                setattr(self, rows_name, getattr(self, rows_name).append(torch.cat(rows, dim=0)))
                setattr(self, sizes_name, getattr(self, sizes_name).append(
                    torch.tensor(sizes, dtype=torch.int32, device=device)))
                if segm:
                    setattr(self, masks_name, getattr(self, masks_name).append(torch.cat(mask_rows, dim=0)))

    # ---------------------------------------------------------------- distributed sync

    def _sync_dist(self, dist_sync_fn: Optional[Any] = None, process_group: Optional[Any] = None) -> None:
        if self._buffered or dist_sync_fn is not None or self.dist_sync_fn is not None:
            super()._sync_dist(dist_sync_fn, process_group)
            return
        from torchmetrics_tpu_torch.parallel.sync import allgather_ragged_arrays

        group = process_group or self.process_group
        sv = self._state_values
        for name in ("detections", "groundtruths"):
            sv[name] = allgather_ragged_arrays([a.reshape(-1, 4) for a in sv[name]], ndim=2, process_group=group)
        for name in ("detection_scores", "detection_labels", "groundtruth_labels"):
            dtype = torch.float32 if name == "detection_scores" else torch.int64
            sv[name] = allgather_ragged_arrays(
                [a.reshape(-1) for a in sv[name]], ndim=1, dtype=dtype, process_group=group
            )
        if self.iou_type == "segm":
            for name in ("detection_masks", "groundtruth_masks"):
                gathered = allgather_ragged_arrays(list(sv[name]), ndim=3, dtype=torch.uint8, process_group=group)
                sv[name] = [a.to(torch.bool) for a in gathered]

    # --------------------------------------------------------------- materialization

    def _materialize(self) -> _Samples:
        device = self.device
        if not self._buffered:
            det_n = [int(a.reshape(-1).shape[0]) for a in self.detection_labels]
            gt_n = [int(a.reshape(-1).shape[0]) for a in self.groundtruth_labels]
            num_images = len(self.groundtruths)

            def cat(parts: List[Tensor], shape: Tuple[int, ...], dtype: torch.dtype) -> Tensor:
                parts = [p.reshape(shape) for p in parts]
                return torch.cat(parts) if parts else torch.zeros((0, *shape[1:]), dtype=dtype, device=device)

            masks = None
            if self.iou_type == "segm":
                det_masks, gt_masks = self.detection_masks, self.groundtruth_masks

                def masks(i: int) -> Tuple[Tensor, Tensor]:
                    return _flat(det_masks[i]), _flat(gt_masks[i])

            return _Samples(
                num_images,
                cat(self.detections, (-1, 4), torch.float32),
                cat(self.detection_scores, (-1,), torch.float32),
                cat(self.detection_labels, (-1,), torch.int64).to(torch.int64),
                torch.repeat_interleave(torch.arange(len(det_n), device=device), torch.tensor(det_n, device=device)),
                cat(self.groundtruths, (-1, 4), torch.float32),
                cat(self.groundtruth_labels, (-1,), torch.int64).to(torch.int64),
                torch.repeat_interleave(torch.arange(len(gt_n), device=device), torch.tensor(gt_n, device=device)),
                masks,
            )
        det_rows, gt_rows = self.det_rows.values(), self.gt_rows.values()
        det_sizes = self.det_sizes.values().to(torch.int64)
        gt_sizes = self.gt_sizes.values().to(torch.int64)
        num_images = gt_sizes.shape[0]
        masks = None
        if self.iou_type == "segm":
            det_mask_rows, gt_mask_rows = self.det_mask_rows.values(), self.gt_mask_rows.values()
            det_at, gt_at = _starts(det_sizes).tolist(), _starts(gt_sizes).tolist()
            det_len, gt_len = det_sizes.tolist(), gt_sizes.tolist()
            shape = self.mask_shape

            def masks(i: int) -> Tuple[Tensor, Tensor]:
                d = _unpack_mask_bits(det_mask_rows[det_at[i]: det_at[i] + det_len[i]], shape)
                g = _unpack_mask_bits(gt_mask_rows[gt_at[i]: gt_at[i] + gt_len[i]], shape)
                return _flat(d), _flat(g)

        images = torch.arange(num_images, device=device)
        return _Samples(
            num_images,
            det_rows[:, :4],
            det_rows[:, 4],
            det_rows[:, 5].to(torch.int64),
            torch.repeat_interleave(images[: det_sizes.shape[0]], det_sizes),
            gt_rows[:, :4],
            gt_rows[:, 4].to(torch.int64),
            torch.repeat_interleave(images, gt_sizes),
            masks,
        )

    # --------------------------------------------------------------------- evaluation

    def _accumulate(self, samples: _Samples, keep_ious: bool = False) -> Tuple[Tensor, Tensor, Tensor, Dict]:
        """PR accumulation -> precision[T,R,K,A,M], recall[T,K,A,M], scores[T,R,K,A,M]."""
        return _Evaluation(self, samples).run(keep_ious)

    @staticmethod
    def _mean_over_valid(values: Tensor, dims: Optional[Tuple[int, ...]] = None) -> Tensor:
        """Mean of the entries above -1 (over ``dims``, else all), -1 where there is none."""
        valid = values > -1
        dims = tuple(range(values.ndim)) if dims is None else dims
        total = torch.where(valid, values, 0.0).sum(dim=dims) if values.numel() else values.new_zeros(())
        count = valid.sum(dim=dims) if values.numel() else values.new_zeros((), dtype=torch.int64)
        return torch.where(count > 0, total / count.clamp(min=1), -1.0).to(torch.float32)

    def _summarize(
        self,
        precision: Tensor,
        recall: Tensor,
        avg_prec: bool = True,
        iou_threshold: Optional[float] = None,
        area_range: str = "all",
        max_dets: int = 100,
    ) -> Tensor:
        """COCO summarization: mean over valid entries of the selected PR slab."""
        a_idx = list(_BBOX_AREA_RANGES).index(area_range)
        m_idx = self.max_detection_thresholds.index(max_dets)
        vals = precision[..., a_idx, m_idx] if avg_prec else recall[..., a_idx, m_idx]
        if iou_threshold is not None:
            vals = vals[self.iou_thresholds.index(iou_threshold)]
        return self._mean_over_valid(vals)

    def compute(self) -> Dict[str, Any]:
        """COCO mAP/mAR metric dictionary over all accumulated images."""
        device = self.device
        samples = self._materialize()
        eval_samples = samples.relabeled_to_single_class() if self.average == "micro" else samples
        precision, recall, score_surface, ious = self._accumulate(eval_samples, keep_ious=self.extended_summary)
        last_max_det = self.max_detection_thresholds[-1]
        minus_one = torch.tensor(-1.0, device=device)

        metrics: Dict[str, Any] = {}
        metrics["map"] = self._summarize(precision, recall, True, max_dets=last_max_det)
        metrics["map_50"] = (
            self._summarize(precision, recall, True, iou_threshold=0.5, max_dets=last_max_det)
            if 0.5 in self.iou_thresholds
            else minus_one
        )
        metrics["map_75"] = (
            self._summarize(precision, recall, True, iou_threshold=0.75, max_dets=last_max_det)
            if 0.75 in self.iou_thresholds
            else minus_one.clone()
        )
        for area in ("small", "medium", "large"):
            metrics[f"map_{area}"] = self._summarize(precision, recall, True, area_range=area, max_dets=last_max_det)
        for max_det in self.max_detection_thresholds:
            metrics[f"mar_{max_det}"] = self._summarize(precision, recall, False, max_dets=max_det)
        for area in ("small", "medium", "large"):
            metrics[f"mar_{area}"] = self._summarize(precision, recall, False, area_range=area, max_dets=last_max_det)

        if self.extended_summary:
            metrics["ious"] = ious
            metrics["precision"] = precision.to(torch.float32)
            metrics["recall"] = recall.to(torch.float32)
            metrics["scores"] = score_surface.to(torch.float32)

        map_per_class = torch.tensor([-1.0], device=device)
        mar_per_class = torch.tensor([-1.0], device=device)
        true_classes = samples.classes()
        if self.class_metrics and true_classes:
            # micro pooled everything into one class for the headline stats; per-class
            # metrics always evaluate per true class (reference ``mean_ap.py:551-559``)
            if self.average == "micro":
                cls_precision, cls_recall, _, _ = self._accumulate(samples)
            else:
                cls_precision, cls_recall = precision, recall
            m_idx = self.max_detection_thresholds.index(last_max_det)
            map_per_class = self._mean_over_valid(cls_precision[..., 0, m_idx], dims=(0, 1))
            mar_per_class = self._mean_over_valid(cls_recall[..., 0, m_idx], dims=(0,))
        metrics["map_per_class"] = map_per_class
        metrics[f"mar_{last_max_det}_per_class"] = mar_per_class
        classes = true_classes if self.class_metrics or self.average == "micro" else eval_samples.classes()
        metrics["classes"] = torch.tensor(classes, dtype=torch.int32, device=device)
        return metrics
