"""The port's panoptic quality, held against the JAX package on the CPU.

The same seeded numpy panoptic maps (three to four images of at most 12 x 14 pixels,
categories {0, 1, 3} things and {6, 7} stuff, a few instances each, predictions that
follow the target on 60% of the pixels) go through each JAX function or class and its
port. Covered: ``panoptic_quality`` with every return form and ``modified_panoptic_quality``;
both classes over several batches; unknown categories (255 and 99) in the target (void)
and in allowed predictions; void-heavy maps, where the void share decides false positives
and negatives; the modified metric's stuff; instance ids beyond 32 bits; a batch counted
in parts; one bincount launch per update; JAX state dicts loaded into the port; the
validation messages, ``__all__`` lists and docstring examples.

Tolerances: the true-positive, false-positive and false-negative counts exactly;
``iou_sum`` within 1e-6 relative (a float64 sum in another order, cast to float32);
the computed qualities within 1e-6.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import torchmetrics_tpu.detection as jd  # noqa: E402
import torchmetrics_tpu.functional.detection as jf  # noqa: E402
import torchmetrics_tpu.functional.detection.panoptic as jp  # noqa: E402
import torchmetrics_tpu_torch.detection as td  # noqa: E402
import torchmetrics_tpu_torch.functional.detection as tf  # noqa: E402
import torchmetrics_tpu_torch.functional.detection.panoptic as tp  # noqa: E402
from torchmetrics_tpu_torch.convert import load_jax_state  # noqa: E402
from torchmetrics_tpu_torch.ops import kernels  # noqa: E402

ATOL = 1e-6
RTOL = 1e-6
THINGS, STUFFS = {0, 1, 3}, {6, 7}
CATEGORIES = np.asarray([0, 1, 3, 6, 7])


def maps(seed: int, batch: int = 3, shape=(10, 12), unknown: float = 0.05, void: float = 0.0,
         instances: int = 3, follow: float = 0.6):
    """(preds, target) int64 maps [B, H, W, 2] of (category, instance)."""
    r = np.random.RandomState(seed)

    def one():
        cat = CATEGORIES[r.randint(0, len(CATEGORIES), (batch, *shape))]
        cat = np.where(r.rand(batch, *shape) < unknown, 255, cat)
        cat = np.where(r.rand(batch, *shape) < void, 99, cat)
        return np.stack([cat, r.randint(0, instances, (batch, *shape))], -1)

    preds, target = one(), one()
    same = r.rand(batch, *shape) < follow
    preds[same] = target[same]
    return preds, target


def blocky_maps(seed: int, batch: int = 4, shape=(12, 14)):
    """Maps of 2 x 2 blocks, so segments overlap in large parts and many pairs match."""
    r = np.random.RandomState(seed)
    cat = CATEGORIES[r.randint(0, len(CATEGORIES), (batch, shape[0] // 2, shape[1] // 2))]
    inst = r.randint(0, 2, cat.shape)
    target = np.stack([cat, inst], -1).repeat(2, 1).repeat(2, 2)
    preds = target.copy()
    flip = r.rand(batch, *shape) < 0.15
    preds[flip] = np.stack([CATEGORIES[r.randint(0, 5, flip.sum())], r.randint(0, 2, flip.sum())], -1)
    target[r.rand(batch, *shape) < 0.1] = [255, 0]
    return preds, target


CASES = {
    "mixed": lambda: maps(0),
    "void_heavy": lambda: maps(1, void=0.35),
    "many_instances": lambda: maps(2, instances=6, follow=0.8),
    "blocky": lambda: blocky_maps(3),
    "one_image": lambda: maps(4, batch=1, shape=(9, 9)),
    "spatial_3d": lambda: maps(5, shape=(4, 5, 3)),
}


def _counts_equal(want, got) -> None:
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=RTOL, atol=0)
    for a, b in zip(want[1:], got[1:]):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("modified", [False, True])
def test_batch_counts_equal_jax(case, modified):
    preds, target = CASES[case]()
    void = jp._get_void_color(THINGS, STUFFS)
    stuffs = STUFFS if modified else None
    want = jp._panoptic_quality_update(
        jp._prepocess_inputs(THINGS, STUFFS, preds, void, True),
        jp._prepocess_inputs(THINGS, STUFFS, target, void, True),
        jp._get_category_id_to_continuous_id(THINGS, STUFFS), void, stuffs,
    )
    got = tp._update_from_maps(torch.from_numpy(preds), torch.from_numpy(target), THINGS, STUFFS, True, stuffs)
    _counts_equal(want, got)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("return_sq_and_rq, return_per_class", [(False, False), (True, False), (False, True),
                                                                (True, True)])
def test_panoptic_quality_equals_jax(case, return_sq_and_rq, return_per_class):
    preds, target = CASES[case]()
    kw = {"allow_unknown_preds_category": True, "return_sq_and_rq": return_sq_and_rq,
          "return_per_class": return_per_class}
    want = jf.panoptic_quality(preds, target, THINGS, STUFFS, **kw)
    got = tf.panoptic_quality(torch.from_numpy(preds), torch.from_numpy(target), THINGS, STUFFS, **kw)
    assert tuple(got.shape) == tuple(np.asarray(want).shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_modified_panoptic_quality_equals_jax(case):
    preds, target = CASES[case]()
    want = jf.modified_panoptic_quality(preds, target, THINGS, STUFFS, allow_unknown_preds_category=True)
    got = tf.modified_panoptic_quality(torch.from_numpy(preds), torch.from_numpy(target), THINGS, STUFFS,
                                       allow_unknown_preds_category=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("cls", ["PanopticQuality", "ModifiedPanopticQuality"])
def test_classes_over_batches_equal_jax(cls):
    kw = {"allow_unknown_preds_category": True}
    if cls == "PanopticQuality":
        kw["return_sq_and_rq"] = True
    jm, tm = getattr(jd, cls)(THINGS, STUFFS, **kw), getattr(td, cls)(THINGS, STUFFS, device="cpu", **kw)
    for seed in range(4):
        preds, target = maps(10 + seed, void=0.1 * seed)
        jm.update(preds, target)
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    for name in ("iou_sum", "true_positives", "false_positives", "false_negatives"):
        a, b = np.asarray(getattr(jm, name)), getattr(tm, name).numpy()
        assert a.dtype == b.dtype
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=0) if name == "iou_sum" else np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(tm.compute().numpy(), np.asarray(jm.compute()), atol=ATOL, rtol=0)


def test_instance_ids_beyond_32_bits_count_as_jax():
    preds, target = maps(20, instances=3)
    preds[..., 1] = preds[..., 1] * (1 << 40) - 7
    target[..., 1] = target[..., 1] * (1 << 40) - 7
    want = jf.panoptic_quality(preds, target, THINGS, STUFFS, allow_unknown_preds_category=True,
                               return_per_class=True)
    got = tf.panoptic_quality(torch.from_numpy(preds), torch.from_numpy(target), THINGS, STUFFS,
                              allow_unknown_preds_category=True, return_per_class=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_one_bincount_launch_per_update_and_a_batch_counted_in_parts(monkeypatch):
    calls = []
    plain = kernels.bincount

    def counted(x, valid, minlength):
        calls.append(minlength)
        return plain(x, valid, minlength)

    monkeypatch.setattr(kernels, "bincount", counted)
    preds, target = maps(21, batch=4)
    metric = td.PanopticQuality(THINGS, STUFFS, allow_unknown_preds_category=True, device="cpu")
    metric.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert len(calls) == 1
    whole = {k: getattr(metric, k).clone() for k in ("iou_sum", "true_positives", "false_positives")}
    # a kernel's bins an int: with room for one image's table a launch, four launches
    cells = calls[0] // 4
    monkeypatch.setattr(tp, "_MAX_BINS", cells)
    parts = td.PanopticQuality(THINGS, STUFFS, allow_unknown_preds_category=True, device="cpu")
    parts.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert len(calls) == 1 + 4
    for k, v in whole.items():
        assert torch.equal(getattr(parts, k), v)


def test_a_jax_state_loaded_into_the_port_goes_on_equal():
    kw = {"allow_unknown_preds_category": True}
    jm = jd.PanopticQuality(THINGS, STUFFS, **kw)
    preds, target = maps(30)
    jm.update(preds, target)
    tm = load_jax_state(td.PanopticQuality(THINGS, STUFFS, device="cpu", **kw), jm.state_dict(persistent_only=False))
    preds, target = maps(31, void=0.2)
    jm.update(preds, target)
    tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    np.testing.assert_array_equal(tm.true_positives.numpy(), np.asarray(jm.true_positives))
    np.testing.assert_allclose(tm.compute().numpy(), np.asarray(jm.compute()), atol=ATOL, rtol=0)


def _message(fn, exc=ValueError) -> str:
    with pytest.raises(exc) as err:
        fn()
    return str(err.value)


def test_validation_messages_equal_jax():
    preds, target = maps(40)
    for things, stuffs, exc in (([0, 0], [6], ValueError), ([0], [6, 6], ValueError), ({0.5}, {6}, TypeError),
                                ({0}, {"a"}, TypeError), ({0, 6}, {6}, ValueError), (set(), set(), ValueError)):
        assert _message(lambda: tf.panoptic_quality(torch.from_numpy(preds), torch.from_numpy(target), things,
                                                    stuffs), exc) == \
            _message(lambda: jf.panoptic_quality(preds, target, things, stuffs), exc)
    bad = [(preds, target[:, :-1]), (preds[:, 0, 0], target[:, 0, 0]), (preds[..., :1], target[..., :1])]
    for p, t in bad:
        assert _message(lambda: tf.panoptic_quality(torch.from_numpy(p), torch.from_numpy(t), THINGS, STUFFS)) == \
            _message(lambda: jf.panoptic_quality(p, t, THINGS, STUFFS))
    # unknown predicted categories raise, naming them, unless allowed
    assert _message(lambda: tf.panoptic_quality(torch.from_numpy(preds), torch.from_numpy(target), THINGS,
                                                STUFFS)) == _message(lambda: jf.panoptic_quality(preds, target,
                                                                                                 THINGS, STUFFS))
    assert _message(lambda: td.PanopticQuality(THINGS, STUFFS, device="cpu").update(
        torch.from_numpy(preds), torch.from_numpy(target))).startswith("Unknown categories found: [[255")


def test_every_jax_name_is_exported():
    assert {"PanopticQuality", "ModifiedPanopticQuality"} <= set(td.__all__)
    assert {"panoptic_quality", "modified_panoptic_quality"} <= set(tf.__all__)


@pytest.mark.parametrize("module_name", ["torchmetrics_tpu_torch.functional.detection.panoptic",
                                         "torchmetrics_tpu_torch.detection.panoptic"])
def test_docstring_examples_run(module_name):
    import doctest
    import importlib

    results = doctest.testmod(importlib.import_module(module_name), optionflags=doctest.NORMALIZE_WHITESPACE)
    assert results.attempted > 0 and results.failed == 0
