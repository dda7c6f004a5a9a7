"""The port's detection metrics (box ops, the IoU family, mean AP), held against JAX on the CPU.

The same seeded numpy detections (a dozen images, a few classes, jittered ground truths
with score ties, masks of at most 16 x 20) go through each JAX function or class and its
port. Covered: ``box_convert`` and ``box_area``, the four pairwise IoUs and their
functionals, the four IoU classes (thresholds, ``respect_labels``, class metrics, box
formats); mean AP in bbox and segm, in the list and the buffered layout, macro and micro,
with class metrics and the extended summary, over max-detection thresholds that cut the
groups; the matcher's exactness hazards (NaN IoUs of zero-area boxes, IoUs exactly at
float32 thresholds and their neighbours, score ties inside and across images, the
max-detection cut, ``average="micro"``, the extended summary, segm IoUs); empty
predictions and targets; JAX state dicts loaded into the port and updated further; the
validation messages, ``__all__`` lists and docstring examples.

Tolerances: mean AP's precision, recall and score surfaces, its ``ious`` and
``classes`` exactly (bitwise); its summary values (``map*``, ``mar*``, the per-class
lists) within 1e-6. Box ops, IoU values and IoU classes within 1e-6.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import torchmetrics_tpu.detection as jd  # noqa: E402
import torchmetrics_tpu.functional.detection as jf  # noqa: E402
import torchmetrics_tpu.functional.detection.box_ops as jbox  # noqa: E402
import torchmetrics_tpu_torch as ttm  # noqa: E402
import torchmetrics_tpu_torch.detection as td  # noqa: E402
import torchmetrics_tpu_torch.functional as tfunctional  # noqa: E402
import torchmetrics_tpu_torch.functional.detection as tf  # noqa: E402
import torchmetrics_tpu_torch.functional.detection.box_ops as tbox  # noqa: E402
from torchmetrics_tpu_torch.convert import load_jax_state  # noqa: E402
from torchmetrics_tpu_torch.detection import mean_ap as tmean_ap  # noqa: E402

ATOL = 1e-6
EXACT_KEYS = ("precision", "recall", "scores", "classes")


def _boxes(r, n: int, scale: float = 200.0) -> np.ndarray:
    xy = r.rand(n, 2).astype(np.float32) * scale
    wh = r.rand(n, 2).astype(np.float32) * 120 + 2
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def detections(seed: int, images: int = 12, classes: int = 4, max_det: int = 15, max_gt: int = 6,
               degenerate: bool = False):
    """Per-image dicts: jittered copies of the ground truths (70% of their class) and
    random boxes, scores rounded to 2 decimals (ties inside and across images)."""
    r = np.random.RandomState(seed)
    preds, target = [], []
    for _ in range(images):
        ng, nd = r.randint(0, max_gt + 1), r.randint(0, max_det + 1)
        gb = _boxes(r, ng)
        gl = r.randint(0, classes, ng)
        src = r.randint(0, max(ng, 1), nd)
        db = gb[src] + r.randn(nd, 4).astype(np.float32) * 8 if ng else _boxes(r, nd, 100)
        db = np.concatenate([np.minimum(db[:, :2], db[:, 2:]), np.maximum(db[:, :2], db[:, 2:])], 1)
        dl = np.where(r.rand(nd) < 0.7, gl[src] if ng else 0, r.randint(0, classes, nd))
        ds = np.round(r.rand(nd), 2).astype(np.float32)
        if degenerate and nd and ng:
            # zero-area boxes: a degenerate pair has a zero union, a NaN IoU
            db[0] = [5, 5, 5, 5]
            gb[0] = [5, 5, 5, 5]
            if ng > 1:
                gb[1] = [7, 7, 7, 9]
        preds.append({"boxes": db.astype(np.float32), "scores": ds, "labels": dl})
        target.append({"boxes": gb, "labels": gl})
    return preds, target


def mask_detections(seed: int, images: int = 8, classes: int = 3, shape=(12, 16)):
    """Per-image masks: true masks at 30% density, predicted ones their copies with 10%
    of the pixels flipped; an empty mask on each side (a zero union)."""
    r = np.random.RandomState(seed)
    preds, target = [], []
    for _ in range(images):
        ng, nd = r.randint(0, 5), r.randint(0, 7)
        gm = r.rand(ng, *shape) < 0.3
        src = r.randint(0, max(ng, 1), nd)
        dm = gm[src] ^ (r.rand(nd, *shape) < 0.1) if ng else r.rand(nd, *shape) < 0.3
        if nd > 1:
            dm[1] = False
        if ng > 1:
            gm[1] = False
        gl = r.randint(0, classes, ng)
        dl = np.where(r.rand(nd) < 0.7, gl[src] if ng else 0, r.randint(0, classes, nd))
        preds.append({"masks": dm, "scores": np.round(r.rand(nd), 1).astype(np.float32), "labels": dl})
        target.append({"masks": gm, "labels": gl})
    return preds, target


def to_torch(items: list) -> list:
    return [{k: torch.from_numpy(np.asarray(v)) for k, v in d.items()} for d in items]


def assert_map_equal(jres: dict, tres: dict) -> None:
    assert list(jres) == list(tres)
    for key, want in jres.items():
        got = tres[key]
        if key == "ious":
            assert list(want) == list(got)
            for k in want:
                a, b = np.asarray(want[k]), got[k].numpy()
                assert a.shape == b.shape and a.dtype == b.dtype, k
                assert np.array_equal(a, b, equal_nan=True), k
            continue
        a, b = np.asarray(want), got.numpy()
        assert a.shape == b.shape, key
        if key in EXACT_KEYS:
            assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True), key
        else:
            assert b.dtype == np.float32
            np.testing.assert_allclose(b, a, atol=ATOL, rtol=0, err_msg=key)


def run_both(kwargs: dict, preds: list, target: list, batch: int = 5):
    jm = jd.MeanAveragePrecision(**kwargs)
    tm = td.MeanAveragePrecision(device="cpu", **kwargs)
    for a in range(0, len(preds), batch):
        jm.update(preds[a:a + batch], target[a:a + batch])
        tm.update(to_torch(preds[a:a + batch]), to_torch(target[a:a + batch]))
    return jm, tm


# ----------------------------------------------------------------------- box ops


@pytest.mark.parametrize("in_fmt", ["xyxy", "xywh", "cxcywh"])
@pytest.mark.parametrize("out_fmt", ["xyxy", "xywh", "cxcywh"])
def test_box_convert_equals_jax(in_fmt, out_fmt):
    b = _boxes(np.random.RandomState(0), 9)
    got = tbox.box_convert(torch.from_numpy(b), in_fmt, out_fmt).numpy()
    np.testing.assert_allclose(got, np.asarray(jbox.box_convert(jnp.asarray(b), in_fmt, out_fmt)), atol=ATOL)
    np.testing.assert_array_equal(tbox.box_area(torch.from_numpy(b)).numpy(), np.asarray(jbox.box_area(b)))


@pytest.mark.parametrize("name", ["box_iou", "generalized_box_iou", "distance_box_iou", "complete_box_iou"])
def test_pairwise_ious_equal_jax(name):
    r = np.random.RandomState(1)
    a, b = _boxes(r, 7), _boxes(r, 5)
    b[:2] = a[:2] + 3
    got = getattr(tbox, name)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(getattr(jbox, name)(a, b)), atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["intersection_over_union", "generalized_intersection_over_union",
                                  "distance_intersection_over_union", "complete_intersection_over_union"])
@pytest.mark.parametrize("iou_threshold, aggregate", [(None, True), (0.4, True), (0.4, False), (None, False)])
def test_iou_functionals_equal_jax(name, iou_threshold, aggregate):
    r = np.random.RandomState(2)
    a = _boxes(r, 6)
    b = a + r.randn(6, 4).astype(np.float32) * 10
    kw = {"iou_threshold": iou_threshold, "replacement_val": -0.5, "aggregate": aggregate}
    got = getattr(tf, name)(torch.from_numpy(a), torch.from_numpy(b), **kw).numpy()
    np.testing.assert_allclose(got, np.asarray(getattr(jf, name)(a, b, **kw)), atol=ATOL, rtol=0)


def test_iou_functional_shape_errors_equal_jax():
    good, bad = np.zeros((2, 4), np.float32), np.zeros((2, 3), np.float32)
    for args in ((bad, good), (good, bad)):
        with pytest.raises(ValueError) as jerr:
            jf.intersection_over_union(*args)
        with pytest.raises(ValueError) as terr:
            tf.intersection_over_union(*map(torch.from_numpy, args))
        assert str(terr.value) == str(jerr.value)


# ------------------------------------------------------------------ the IoU family

IOU_CLASSES = ["IntersectionOverUnion", "GeneralizedIntersectionOverUnion", "DistanceIntersectionOverUnion",
               "CompleteIntersectionOverUnion"]


@pytest.mark.parametrize("cls", IOU_CLASSES)
@pytest.mark.parametrize("kwargs", [{}, {"iou_threshold": 0.5}, {"respect_labels": False, "class_metrics": True},
                                    {"class_metrics": True, "box_format": "xywh", "iou_threshold": 0.3}])
def test_iou_classes_over_batches_equal_jax(cls, kwargs):
    preds, target = detections(3, images=8)
    preds = [{k: v for k, v in p.items() if k != "scores"} for p in preds]
    jm, tm = getattr(jd, cls)(**kwargs), getattr(td, cls)(device="cpu", **kwargs)
    for a in range(0, 8, 3):
        jm.update(preds[a:a + 3], target[a:a + 3])
        tm.update(to_torch(preds[a:a + 3]), to_torch(target[a:a + 3]))
    want, got = jm.compute(), tm.compute()
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=ATOL, rtol=0, err_msg=k)
    for a, b in zip(jm.iou_matrix, tm.iou_matrix):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL, rtol=0)


def test_iou_class_of_empty_inputs_equals_jax():
    preds = [{"boxes": np.zeros((0, 4), np.float32), "labels": np.zeros(0, np.int64)}]
    target = [{"boxes": np.zeros(0, np.float32), "labels": np.zeros(0, np.int64)}]
    jm, tm = jd.IntersectionOverUnion(class_metrics=True), td.IntersectionOverUnion(class_metrics=True, device="cpu")
    jm.update(preds, target)
    tm.update(to_torch(preds), to_torch(target))
    want, got = jm.compute(), tm.compute()
    assert list(got) == list(want) and float(got["iou"]) == float(want["iou"])


# ------------------------------------------------------------------ mean AP, bbox


@pytest.mark.parametrize("kwargs", [
    {},
    {"class_metrics": True},
    {"extended_summary": True},
    {"average": "micro"},
    {"average": "micro", "class_metrics": True, "extended_summary": True},
    {"box_format": "cxcywh", "extended_summary": True},
    {"iou_thresholds": [0.3, 0.5, 0.8], "rec_thresholds": [0.0, 0.25, 0.333, 0.5, 1.0], "class_metrics": True},
])
@pytest.mark.parametrize("buffered", [False, True])
def test_bbox_map_equals_jax(kwargs, buffered):
    preds, target = detections(4)
    if buffered:
        kwargs = {**kwargs, "buffer_capacity": 300, "image_capacity": 16}
    jm, tm = run_both(kwargs, preds, target)
    assert_map_equal(jm.compute(), tm.compute())


@pytest.mark.parametrize("seed", [10, 11, 12])
def test_bbox_map_of_larger_runs_equals_jax(seed):
    preds, target = detections(seed, images=20, classes=6, max_det=40, max_gt=12)
    jm, tm = run_both({"extended_summary": True, "class_metrics": True}, preds, target, batch=7)
    assert_map_equal(jm.compute(), tm.compute())


def test_nan_ious_of_zero_area_boxes_are_matched_as_jax_matches_them():
    """Hazard 1: a zero-area detection over a zero-area ground truth has a NaN IoU, and
    NaN * 0 stays NaN: numpy's argmax takes the first NaN and ``NaN <= threshold`` is
    False, so the detection is matched, even to a matched or ignored ground truth."""
    preds, target = detections(5, degenerate=True)
    for p, t in zip(preds, target):  # more NaN pairs: a second zero-area detection
        if len(p["boxes"]) > 1 and len(t["boxes"]):
            p["boxes"][1] = [5, 5, 5, 5]
            p["labels"][:2] = t["labels"][0]
    jm, tm = run_both({"extended_summary": True}, preds, target)
    want = jm.compute()
    assert any(np.isnan(np.asarray(v)).any() for v in want["ious"].values())
    assert_map_equal(want, tm.compute())


def _widths_at(threshold: float) -> dict:
    """Integer widths (w, W) whose nested boxes ``[0, 0, w, 1]`` in ``[0, 0, W, 1]`` have
    the IoU ``fl32(w / W)`` equal to float32(threshold) and to each of its neighbours
    (areas and the union are exact integers, so the IoU is one rounding)."""
    t32 = np.float32(threshold)
    wanted = (np.nextafter(t32, np.float32(0)), t32, np.nextafter(t32, np.float32(1)))
    big = np.arange(1 << 23, (1 << 23) + 4096, dtype=np.int64)  # W + w stays below 2^24
    found = {}
    for delta in (-2, -1, 0, 1, 2):
        small = np.round(threshold * big).astype(np.int64) + delta
        iou = small.astype(np.float32) / big.astype(np.float32)
        for target in wanted:
            hit = np.nonzero(iou == target)[0]
            if target not in found and hit.size:
                found[target] = (int(small[hit[0]]), int(big[hit[0]]))
    assert len(found) == 3, found
    return found


@pytest.mark.parametrize("threshold", [0.55, 0.75])
def test_ious_exactly_at_float32_thresholds_and_their_neighbours_match_as_jax(threshold):
    """Hazard 2: numpy 2 compares a float32 IoU with the Python threshold in float32
    (NEP 50): an IoU equal to float32(threshold) is not a match, its upper neighbour is."""
    from torchmetrics_tpu.detection.mean_ap import _np_box_iou

    preds, target = [], []
    for iou, (w, big) in _widths_at(threshold).items():
        det = np.asarray([[0.0, 0.0, w, 1.0]], np.float32)
        gt = np.asarray([[0.0, 0.0, big, 1.0]], np.float32)
        assert _np_box_iou(det, gt)[0, 0] == iou
        preds.append({"boxes": det, "scores": np.asarray([0.9], np.float32), "labels": np.asarray([0])})
        target.append({"boxes": gt, "labels": np.asarray([0])})
    kw = {"iou_thresholds": [0.5, threshold], "extended_summary": True}
    jm, tm = run_both(kw, preds, target, batch=3)
    want = jm.compute()
    assert float(want["recall"][1, 0, 0, -1]) == pytest.approx(1 / 3)
    assert_map_equal(want, tm.compute())


def test_score_ties_inside_and_across_images_sort_as_jax():
    """Hazard 3: stable sorts within a group, ignored ground truths last, and across
    images at accumulation (image order, then rank) decide equal scores."""
    r = np.random.RandomState(6)
    preds, target = [], []
    for i in range(6):
        gb = _boxes(r, 4)
        db = np.concatenate([gb, gb[::-1] + 1, gb + 30]).astype(np.float32)
        preds.append({"boxes": db, "scores": np.full(12, 0.5, np.float32), "labels": np.zeros(12, np.int64)})
        small = gb.copy()
        small[:2, 2:] = small[:2, :2] + 10  # small boxes: ignored in the medium and large ranges
        target.append({"boxes": small, "labels": np.zeros(4, np.int64)})
    jm, tm = run_both({"extended_summary": True, "max_detection_thresholds": [1, 5, 12]}, preds, target, batch=2)
    assert_map_equal(jm.compute(), tm.compute())


def test_max_detection_cut_per_group_then_per_image_as_jax():
    """Hazard 4: the last max-detection threshold cuts each (image, class) group's
    sorted detections; each threshold then cuts again at accumulation."""
    preds, target = detections(7, images=10, classes=2, max_det=30, max_gt=8)
    jm, tm = run_both({"max_detection_thresholds": [2, 4, 7], "extended_summary": True, "class_metrics": True},
                      preds, target)
    assert_map_equal(jm.compute(), tm.compute())


def test_micro_average_relabels_and_class_metrics_still_per_class():
    """Hazard 5: ``average="micro"`` pools every class into class 0; with class metrics
    the per-class lists come from a second accumulation per true class."""
    preds, target = detections(8)
    jm, tm = run_both({"average": "micro", "class_metrics": True}, preds, target)
    want, got = jm.compute(), tm.compute()
    assert_map_equal(want, got)
    assert got["map_per_class"].shape[0] == len(got["classes"]) > 1


def test_extended_summary_keys_dtypes_and_ious():
    """Hazard 6: ``ious`` keyed (image, class) for every image and class, float32
    surfaces."""
    preds, target = detections(9, images=5)
    jm, tm = run_both({"extended_summary": True}, preds, target)
    got = tm.compute()
    assert_map_equal(jm.compute(), got)
    assert all(got[k].dtype == torch.float32 for k in ("precision", "recall", "scores"))
    assert len(got["ious"]) == 5 * len(got["classes"])


@pytest.mark.parametrize("kwargs", [{}, {"extended_summary": True, "class_metrics": True},
                                    {"average": "micro", "extended_summary": True}])
@pytest.mark.parametrize("buffered", [False, True])
def test_segm_map_equals_jax(kwargs, buffered):
    """Hazard 7: mask IoUs (a full-float32 product of 0/1 rows, exact) in both layouts."""
    preds, target = mask_detections(11)
    if buffered:
        kwargs = {**kwargs, "buffer_capacity": 64, "mask_shape": (12, 16)}
    jm, tm = run_both({"iou_type": "segm", **kwargs}, preds, target, batch=3)
    assert_map_equal(jm.compute(), tm.compute())


def test_bit_packing_round_trips_and_equals_jax():
    from torchmetrics_tpu.detection import mean_ap as jmean_ap

    masks = np.random.RandomState(12).rand(5, 7, 9) < 0.5
    packed = tmean_ap._pack_mask_bits(torch.from_numpy(masks), 8)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jmean_ap._pack_mask_bits(jnp.asarray(masks), 8)))
    np.testing.assert_array_equal(packed.numpy()[:, :8], np.packbits(masks.reshape(5, -1), axis=1))
    np.testing.assert_array_equal(tmean_ap._unpack_mask_bits(packed, (7, 9)).numpy(), masks)


@pytest.mark.parametrize("empty", ["preds", "target", "both"])
@pytest.mark.parametrize("buffered", [False, True])
def test_empty_predictions_and_targets_equal_jax(empty, buffered):
    preds, target = detections(13, images=4)
    if empty in ("preds", "both"):
        preds = [{"boxes": np.zeros((0, 4), np.float32), "scores": np.zeros(0, np.float32),
                  "labels": np.zeros(0, np.int64)} for _ in preds]
    if empty in ("target", "both"):
        target = [{"boxes": np.zeros(0, np.float32), "labels": np.zeros(0, np.int64)} for _ in target]
    kwargs = {"class_metrics": True, "extended_summary": True}
    if buffered:
        kwargs.update(buffer_capacity=100)
    jm, tm = run_both(kwargs, preds, target)
    assert_map_equal(jm.compute(), tm.compute())


@pytest.mark.parametrize("buffered", [False, True])
def test_a_jax_state_loaded_into_the_port_goes_on_equal(buffered):
    preds, target = detections(14)
    kwargs = {"extended_summary": True, "class_metrics": True}
    if buffered:
        kwargs.update(buffer_capacity=300)
    jm = jd.MeanAveragePrecision(**kwargs)
    jm.update(preds[:6], target[:6])
    tm = load_jax_state(td.MeanAveragePrecision(device="cpu", **kwargs), jm.state_dict(persistent_only=False))
    jm.update(preds[6:], target[6:])
    tm.update(to_torch(preds[6:]), to_torch(target[6:]))
    assert_map_equal(jm.compute(), tm.compute())


def test_validation_messages_equal_jax():
    cases = [
        ({"box_format": "xyzw"}, None), ({"iou_type": "keypoints"}, None), ({"class_metrics": 1}, None),
        ({"extended_summary": "yes"}, None), ({"average": "weighted"}, None), ({"mask_shape": (4, 4)}, None),
        ({"iou_type": "segm", "buffer_capacity": 4}, None),
    ]
    for kwargs, _ in cases:
        with pytest.raises(ValueError) as jerr:
            jd.MeanAveragePrecision(**kwargs)
        with pytest.raises(ValueError) as terr:
            td.MeanAveragePrecision(device="cpu", **kwargs)
        assert str(terr.value) == str(jerr.value)
    preds, target = detections(15, images=2)
    bad_inputs = [
        (preds, target[:1]),
        ([{k: v for k, v in p.items() if k != "scores"} for p in preds], target),
        (preds, [{"labels": t["labels"]} for t in target]),
        ([{**p, "labels": np.zeros(len(p["labels"]) + 1, np.int64)} for p in preds], target),
        (preds, [{**t, "labels": np.zeros(len(t["labels"]) + 1, np.int64)} for t in target]),
    ]
    for p, t in bad_inputs:
        with pytest.raises(ValueError) as jerr:
            jd.MeanAveragePrecision().update(p, t)
        with pytest.raises(ValueError) as terr:
            td.MeanAveragePrecision(device="cpu").update(to_torch(p), to_torch(t))
        assert str(terr.value) == str(jerr.value)
    masks = [{"masks": np.zeros((1, 3, 3), bool), "scores": np.ones(1, np.float32), "labels": np.zeros(1, np.int64)}]
    for m in (jd.MeanAveragePrecision(iou_type="segm", buffer_capacity=8, mask_shape=(4, 4)),
              td.MeanAveragePrecision(iou_type="segm", buffer_capacity=8, mask_shape=(4, 4), device="cpu")):
        with pytest.raises(ValueError, match=r"static shape \(1, 4, 4\).*\(1, 3, 3\)"):
            m.update(masks if isinstance(m, jd.MeanAveragePrecision) else to_torch(masks),
                     [{"masks": np.zeros((0, 4, 4), bool), "labels": np.zeros(0, np.int64)}]
                     if isinstance(m, jd.MeanAveragePrecision) else
                     to_torch([{"masks": np.zeros((0, 4, 4), bool), "labels": np.zeros(0, np.int64)}]))


def test_every_jax_name_is_exported():
    assert sorted(td.__all__) == sorted(jd.__all__)
    assert sorted(tf.__all__) == sorted(jf.__all__)
    assert set(td.__all__) <= set(ttm.__all__)
    assert set(tf.__all__) <= set(tfunctional.__all__) and "detection" in tfunctional.__all__


@pytest.mark.parametrize("module_name", [
    "torchmetrics_tpu_torch.functional.detection.box_ops", "torchmetrics_tpu_torch.detection.iou_modules",
    "torchmetrics_tpu_torch.detection.mean_ap",
])
def test_docstring_examples_run(module_name):
    import doctest
    import importlib

    results = doctest.testmod(importlib.import_module(module_name), optionflags=doctest.NORMALIZE_WHITESPACE)
    assert results.attempted > 0 and results.failed == 0
