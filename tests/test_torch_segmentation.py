"""The segmentation scores of the port, held against the JAX package on the CPU.

The cases of ``tests/domains/test_clustering_nominal_segmentation_pairwise.py``'s
``TestSegmentation`` (mean IoU per class or not, with and without background; the
generalized dice for each weight type; both classes over batches; index input) run on
the same seeded numpy maps through both packages, held against JAX rather than the
reference. Added: the index route, counted as one (C+1) x (C+1) table an image on the
bincount kernel, against JAX's one-hot route with labels outside ``[0, C)`` on either
side (255, negative values), ``num_classes = 1``, ``include_background=False``, a batch
counted in parts, the one-hot input against the index route, ``MeanIoU``'s sum of batch
means, JAX state dicts carried into the port and updated further, the validation
messages and the ``__all__`` lists.

Tolerances: intersections and unions exactly; the scores within 1e-6.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import torchmetrics_tpu.functional.segmentation as jf  # noqa: E402
import torchmetrics_tpu.functional.segmentation.scores as jscores  # noqa: E402
import torchmetrics_tpu.segmentation as js  # noqa: E402
import torchmetrics_tpu_torch.functional.segmentation as tf  # noqa: E402
import torchmetrics_tpu_torch.functional.segmentation.scores as tscores  # noqa: E402
import torchmetrics_tpu_torch.segmentation as ts  # noqa: E402
from torchmetrics_tpu_torch.convert import load_jax_state  # noqa: E402
from torchmetrics_tpu_torch.ops import kernels  # noqa: E402

ATOL = 1e-6

rng = np.random.RandomState(42)
SEG_PREDS = rng.randint(0, 2, (4, 5, 16, 16))
SEG_TARGET = rng.randint(0, 2, (4, 5, 16, 16))

_r = np.random.RandomState(8)


def _index_maps(n: int, c: int, shape=(12, 10), ignore: float = 0.1, seed: int = 0):
    """Index maps of ``c`` classes with some 255 and negative labels on both sides."""
    r = np.random.RandomState(seed)
    preds = r.randint(0, c, (n, *shape))
    target = np.where(r.rand(n, *shape) < 0.6, preds, r.randint(0, c, (n, *shape)))
    target = np.where(r.rand(n, *shape) < ignore, 255, target)
    preds = np.where(r.rand(n, *shape) < ignore / 2, -1, preds)
    preds = np.where(r.rand(n, *shape) < ignore / 2, c + 3, preds)
    return preds, target


INDEX = {
    "cityscapes_like": (_index_maps(4, 19, seed=1), 19),
    "five": (_index_maps(3, 5, shape=(8, 8, 3), seed=2), 5),
    "one_class": (_index_maps(2, 1, seed=3), 1),
    "clean": (_index_maps(3, 4, ignore=0.0, seed=4), 4),
    "empty_class": ((np.zeros((2, 6, 6), dtype=np.int64), np.ones((2, 6, 6), dtype=np.int64)), 3),
}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _close(port, jax_value, atol: float = ATOL) -> None:
    got, want = _np(port).astype(np.float64), _np(jax_value).astype(np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("per_class", [False, True])
@pytest.mark.parametrize("include_background", [True, False])
def test_mean_iou_one_hot_equals_jax(per_class, include_background):
    kw = {"num_classes": 5, "include_background": include_background, "per_class": per_class}
    port = tf.mean_iou(torch.from_numpy(SEG_PREDS), torch.from_numpy(SEG_TARGET), **kw)
    _close(port, jf.mean_iou(jnp.asarray(SEG_PREDS), jnp.asarray(SEG_TARGET), **kw))


@pytest.mark.parametrize("weight_type", ["square", "simple", "linear"])
@pytest.mark.parametrize("include_background", [True, False])
@pytest.mark.parametrize("per_class", [False, True])
def test_generalized_dice_one_hot_equals_jax(weight_type, include_background, per_class):
    kw = {"num_classes": 5, "include_background": include_background, "per_class": per_class,
          "weight_type": weight_type}
    port = tf.generalized_dice_score(torch.from_numpy(SEG_PREDS), torch.from_numpy(SEG_TARGET), **kw)
    _close(port, jf.generalized_dice_score(jnp.asarray(SEG_PREDS), jnp.asarray(SEG_TARGET), **kw))


@pytest.mark.parametrize("case", sorted(INDEX))
@pytest.mark.parametrize("include_background", [True, False])
def test_index_route_counts_equal_jax_one_hot_exactly(case, include_background):
    (preds, target), c = INDEX[case]
    intersection, union = tscores._mean_iou_update(torch.from_numpy(preds), torch.from_numpy(target), c,
                                                   include_background, "index")
    j_intersection, j_union = jscores._mean_iou_update(jnp.asarray(preds), jnp.asarray(target), c,
                                                       include_background, "index")
    assert intersection.dtype == union.dtype == torch.int32
    np.testing.assert_array_equal(_np(intersection), _np(j_intersection))
    np.testing.assert_array_equal(_np(union), _np(j_union))


def test_an_out_of_range_label_counts_in_the_other_sides_sum():
    preds = torch.tensor([[[0, 1], [1, 255]]])
    target = torch.tensor([[[0, 255], [-1, 1]]])
    intersection, target_sum, pred_sum = tscores._index_class_sums(preds, target, 2)
    assert intersection.tolist() == [[1, 0]]
    assert target_sum.tolist() == [[1, 1]]  # the 255 and -1 targets count in no class
    assert pred_sum.tolist() == [[1, 2]]  # the preds over them still count in class 1


@pytest.mark.parametrize("case", sorted(INDEX))
@pytest.mark.parametrize("per_class", [False, True])
@pytest.mark.parametrize("include_background", [True, False])
def test_mean_iou_index_equals_jax(case, per_class, include_background):
    (preds, target), c = INDEX[case]
    kw = {"num_classes": c, "include_background": include_background, "per_class": per_class,
          "input_format": "index"}
    port = tf.mean_iou(torch.from_numpy(preds), torch.from_numpy(target), **kw)
    _close(port, jf.mean_iou(jnp.asarray(preds), jnp.asarray(target), **kw))


@pytest.mark.parametrize("case", sorted(INDEX))
@pytest.mark.parametrize("weight_type", ["square", "simple", "linear"])
@pytest.mark.parametrize("include_background", [True, False])
def test_generalized_dice_index_equals_jax(case, weight_type, include_background):
    (preds, target), c = INDEX[case]
    kw = {"num_classes": c, "include_background": include_background, "weight_type": weight_type,
          "input_format": "index"}
    for per_class in (False, True):
        port = tf.generalized_dice_score(torch.from_numpy(preds), torch.from_numpy(target), per_class=per_class, **kw)
        _close(port, jf.generalized_dice_score(jnp.asarray(preds), jnp.asarray(target), per_class=per_class, **kw))


def test_index_route_is_one_bincount_launch_a_batch(monkeypatch):
    calls = []
    real = kernels.bincount
    monkeypatch.setattr(kernels, "bincount", lambda *a: calls.append(a[2]) or real(*a))
    (preds, target), c = INDEX["cityscapes_like"]
    tf.mean_iou(torch.from_numpy(preds), torch.from_numpy(target), c, input_format="index")
    assert calls == [preds.shape[0] * (c + 1) ** 2]


@pytest.mark.parametrize("images_a_launch", [1, 3])
def test_a_batch_counted_in_parts_equals_one_launch(images_a_launch, monkeypatch):
    (preds, target), c = INDEX["cityscapes_like"]
    p, t = torch.from_numpy(preds), torch.from_numpy(target)
    whole = tscores._index_class_sums(p, t, c)
    monkeypatch.setattr(tscores, "_MAX_BINS", images_a_launch * (c + 1) ** 2)
    calls = []
    real = kernels.bincount
    monkeypatch.setattr(kernels, "bincount", lambda *a: calls.append(a[2]) or real(*a))
    parts = tscores._index_class_sums(p, t, c)
    assert len(calls) == -(-preds.shape[0] // images_a_launch)
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)


def test_one_hot_input_equals_the_index_route():
    (preds, target), c = INDEX["clean"]
    onehot = lambda x: torch.from_numpy(np.moveaxis(np.eye(c, dtype=np.int64)[x], -1, 1))  # noqa: E731
    for fn in (tf.mean_iou, tf.generalized_dice_score):
        by_index = fn(torch.from_numpy(preds), torch.from_numpy(target), c, input_format="index")
        by_one_hot = fn(onehot(preds), onehot(target), c)
        assert torch.equal(by_index, by_one_hot)


@pytest.mark.parametrize("input_format", ["one-hot", "index"])
@pytest.mark.parametrize("per_class", [False, True])
@pytest.mark.parametrize("include_background", [True, False])
def test_classes_over_batches_equal_jax(input_format, per_class, include_background):
    if input_format == "index":
        (preds, target), c = INDEX["cityscapes_like"]
    else:
        preds, target, c = SEG_PREDS, SEG_TARGET, 5
    kw = {"num_classes": c, "include_background": include_background, "per_class": per_class,
          "input_format": input_format}
    for cls, extra in (("MeanIoU", {}), ("GeneralizedDiceScore", {"weight_type": "square"})):
        port, jax_metric = getattr(ts, cls)(device="cpu", **kw, **extra), getattr(js, cls)(**kw, **extra)
        for i in range(0, preds.shape[0], 2):
            port.update(torch.from_numpy(preds[i:i + 2]), torch.from_numpy(target[i:i + 2]))
            jax_metric.update(jnp.asarray(preds[i:i + 2]), jnp.asarray(target[i:i + 2]))
        for name in port._defaults:
            _close(getattr(port, name), getattr(jax_metric, name))
        _close(port.compute(), jax_metric.compute())


def test_mean_iou_computes_the_sum_of_batch_means():
    (preds, target), c = INDEX["cityscapes_like"]
    metric = ts.MeanIoU(num_classes=c, input_format="index", device="cpu")
    means = []
    for i in range(0, 4, 2):
        metric.update(torch.from_numpy(preds[i:i + 2]), torch.from_numpy(target[i:i + 2]))
        means.append(tf.mean_iou(torch.from_numpy(preds[i:i + 2]), torch.from_numpy(target[i:i + 2]), c,
                                 input_format="index").mean())
    _close(metric.compute(), sum(means))
    assert metric.compute().ndim == 0


@pytest.mark.parametrize("cls", ["MeanIoU", "GeneralizedDiceScore"])
def test_a_jax_state_loaded_into_the_port_goes_on_equal(cls):
    (preds, target), c = INDEX["cityscapes_like"]
    kw = {"num_classes": c, "input_format": "index", "per_class": True}
    jax_metric = getattr(js, cls)(**kw)
    jax_metric.update(jnp.asarray(preds[:2]), jnp.asarray(target[:2]))
    port = load_jax_state(getattr(ts, cls)(device="cpu", **kw), jax_metric.state_dict(persistent_only=False))
    jax_metric.update(jnp.asarray(preds[2:]), jnp.asarray(target[2:]))
    port.update(torch.from_numpy(preds[2:]), torch.from_numpy(target[2:]))
    for name in port._defaults:
        _close(getattr(port, name), getattr(jax_metric, name))
    _close(port.compute(), jax_metric.compute())


def test_validation_messages_equal_jax():
    def message(fn):
        with pytest.raises(ValueError) as err:
            fn()
        return str(err.value)

    cases = [
        ("mean_iou", "MeanIoU", {"num_classes": 0}),
        ("mean_iou", "MeanIoU", {"num_classes": 3, "include_background": 1}),
        ("mean_iou", "MeanIoU", {"num_classes": 3, "per_class": "yes"}),
        ("mean_iou", "MeanIoU", {"num_classes": 3, "input_format": "probs"}),
        ("generalized_dice_score", "GeneralizedDiceScore", {"num_classes": 3, "weight_type": "cube"}),
        ("generalized_dice_score", "GeneralizedDiceScore", {"num_classes": -1}),
    ]
    p, t = torch.from_numpy(SEG_PREDS), torch.from_numpy(SEG_TARGET)
    for fn, cls, kw in cases:
        want = message(lambda: getattr(jf, fn)(jnp.asarray(SEG_PREDS), jnp.asarray(SEG_TARGET), **kw))
        assert message(lambda: getattr(tf, fn)(p, t, **kw)) == want
        assert message(lambda: getattr(ts, cls)(device="cpu", **kw)) == message(lambda: getattr(js, cls)(**kw))
    flat = np.zeros((4, 16), dtype=np.int64)
    assert message(lambda: tf.generalized_dice_score(torch.from_numpy(flat), torch.from_numpy(flat), 3,
                                                     input_format="index")) == message(
        lambda: jf.generalized_dice_score(jnp.asarray(flat), jnp.asarray(flat), 3, input_format="index"))
    with pytest.raises(RuntimeError, match="same shape"):
        tf.mean_iou(p, t[:2], 5)


@pytest.mark.parametrize("cls", sorted(js.__all__))
def test_classes_keep_jax_attributes(cls):
    for attr in ("is_differentiable", "higher_is_better", "full_state_update", "plot_lower_bound",
                 "plot_upper_bound"):
        assert getattr(getattr(ts, cls), attr) == getattr(getattr(js, cls), attr), attr


def test_the_all_lists_equal_jax():
    import torchmetrics_tpu as jtm
    import torchmetrics_tpu.clustering as jc
    import torchmetrics_tpu.nominal as jn
    import torchmetrics_tpu_torch as ttm
    import torchmetrics_tpu_torch.functional as tfunctional

    assert ts.__all__ == js.__all__
    assert tf.__all__ == jf.__all__
    assert set(jf.__all__) <= set(tfunctional.__all__) and "segmentation" in tfunctional.__all__
    # the top level holds JAX's names of the three domains
    domains = set(js.__all__) | set(jc.__all__) | set(jn.__all__)
    assert domains <= set(jtm.__all__) and domains <= set(ttm.__all__)
