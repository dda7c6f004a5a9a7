"""Functional classification of the port held against the JAX package on the CPU.

The same numpy inputs, made from a seed, go through both packages. Integer results
match exactly; float results within 1e-6 (the two packages sum in different orders);
binned threshold grids bitwise.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import torchmetrics_tpu.functional.classification as jf  # noqa: E402
import torchmetrics_tpu_torch.functional.classification as tf  # noqa: E402

ATOL = 1e-6
N, C, X = 48, 5, 3


def assert_match(jax_out, torch_out, atol: float = ATOL) -> None:
    """Recursively compare a JAX result with the port's: ints exactly, floats within ``atol``."""
    if isinstance(jax_out, (tuple, list)):
        assert isinstance(torch_out, (tuple, list)) and len(jax_out) == len(torch_out)
        for a, b in zip(jax_out, torch_out):
            assert_match(a, b, atol)
        return
    want = np.asarray(jax_out)
    got = torch_out.detach().cpu().numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    if np.issubdtype(want.dtype, np.integer) or want.dtype == np.bool_:
        assert got.dtype == want.dtype, (got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want)
    else:
        assert got.dtype == np.float32, got.dtype
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def both(jax_fn, torch_fn, *arrays, **kwargs):
    """Run ``jax_fn`` and ``torch_fn`` on the same numpy arrays with the same kwargs."""
    jax_out = jax_fn(*(jnp.asarray(a) for a in arrays), **kwargs)
    torch_out = torch_fn(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays), **kwargs)
    assert_match(jax_out, torch_out)


def _multiclass_inputs(seed: int, ignore_index=None, kind: str = "probs", multidim: bool = True):
    rng = np.random.RandomState(seed)
    shape = (N, C, X) if multidim else (N, C)
    logits = rng.randn(*shape).astype(np.float32)
    target = rng.randint(0, C, shape[:1] + shape[2:]).astype(np.int32)
    if ignore_index is not None:
        target[rng.rand(*target.shape) < 0.15] = ignore_index
    if kind == "probs":
        e = np.exp(logits - logits.max(axis=1, keepdims=True))
        preds = (e / e.sum(axis=1, keepdims=True)).astype(np.float32)
    elif kind == "logits":
        preds = logits
    else:
        preds = logits.argmax(axis=1).astype(np.int32)
    return preds, target


def _binary_inputs(seed: int, ignore_index=None, kind: str = "probs", multidim: bool = True):
    rng = np.random.RandomState(seed)
    shape = (N, X) if multidim else (N,)
    logits = (rng.randn(*shape) * 2).astype(np.float32)
    target = rng.randint(0, 2, shape).astype(np.int32)
    if ignore_index is not None:
        target[rng.rand(*shape) < 0.15] = ignore_index
    if kind == "probs":
        preds = (1 / (1 + np.exp(-logits))).astype(np.float32)
    elif kind == "logits":
        preds = logits
    else:
        preds = (logits > 0).astype(np.int32)
    return preds, target


# ----------------------------------------------------------------- stat-score family

MULTICLASS_FNS = {
    "stat_scores": (jf.multiclass_stat_scores, tf.multiclass_stat_scores),
    "accuracy": (jf.multiclass_accuracy, tf.multiclass_accuracy),
    "f1": (jf.multiclass_f1_score, tf.multiclass_f1_score),
}


@pytest.mark.parametrize("fn", sorted(MULTICLASS_FNS))
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
def test_multiclass_stat_family(fn, average, top_k, ignore_index, multidim_average):
    preds, target = _multiclass_inputs(7, ignore_index)
    jax_fn, torch_fn = MULTICLASS_FNS[fn]
    both(jax_fn, torch_fn, preds, target, num_classes=C, average=average, top_k=top_k,
         multidim_average=multidim_average, ignore_index=ignore_index)


@pytest.mark.parametrize("fn", sorted(MULTICLASS_FNS))
@pytest.mark.parametrize("kind", ["logits", "labels"])
def test_multiclass_stat_family_input_kinds(fn, kind):
    preds, target = _multiclass_inputs(8, None, kind=kind, multidim=False)
    jax_fn, torch_fn = MULTICLASS_FNS[fn]
    both(jax_fn, torch_fn, preds, target, num_classes=C, average="macro")


BINARY_FNS = {
    "stat_scores": (jf.binary_stat_scores, tf.binary_stat_scores),
    "accuracy": (jf.binary_accuracy, tf.binary_accuracy),
    "f1": (jf.binary_f1_score, tf.binary_f1_score),
}


@pytest.mark.parametrize("fn", sorted(BINARY_FNS))
@pytest.mark.parametrize("kind", ["probs", "logits", "labels"])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
def test_binary_stat_family(fn, kind, ignore_index, multidim_average):
    preds, target = _binary_inputs(9, ignore_index, kind)
    jax_fn, torch_fn = BINARY_FNS[fn]
    both(jax_fn, torch_fn, preds, target, multidim_average=multidim_average, ignore_index=ignore_index)


@pytest.mark.parametrize("normalize", [None, "true", "pred", "all"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_multiclass_confusion_matrix(normalize, ignore_index):
    preds, target = _multiclass_inputs(10, ignore_index)
    both(jf.multiclass_confusion_matrix, tf.multiclass_confusion_matrix, preds, target,
         num_classes=C, normalize=normalize, ignore_index=ignore_index)


@pytest.mark.parametrize("normalize", [None, "true", "pred", "all"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_binary_confusion_matrix(normalize, ignore_index):
    preds, target = _binary_inputs(11, ignore_index)
    both(jf.binary_confusion_matrix, tf.binary_confusion_matrix, preds, target,
         normalize=normalize, ignore_index=ignore_index)


def test_confusion_matrix_wide_classes_not_lane_multiple():
    rng = np.random.RandomState(12)
    preds = rng.randn(400, 130).astype(np.float32)
    target = rng.randint(0, 130, 400).astype(np.int32)
    both(jf.multiclass_confusion_matrix, tf.multiclass_confusion_matrix, preds, target, num_classes=130)
    both(jf.multiclass_accuracy, tf.multiclass_accuracy, preds, target, num_classes=130, average="macro")


def test_out_of_range_labels_are_dropped_without_validation():
    preds = np.array([0, 1, 2, 3, -1, 2], dtype=np.int32)
    target = np.array([0, 1, 5, 2, 1, -3], dtype=np.int32)
    both(jf.multiclass_confusion_matrix, tf.multiclass_confusion_matrix, preds, target,
         num_classes=4, validate_args=False)
    both(jf.multiclass_stat_scores, tf.multiclass_stat_scores, preds, target,
         num_classes=4, average=None, validate_args=False)


@pytest.mark.parametrize("task", ["binary", "multiclass"])
def test_task_dispatch(task):
    if task == "binary":
        preds, target = _binary_inputs(13, multidim=False)
        kw = {}
    else:
        preds, target = _multiclass_inputs(13, multidim=False)
        kw = {"num_classes": C}
    for name in ("stat_scores", "accuracy", "f1_score", "confusion_matrix", "auroc"):
        both(getattr(jf, name), getattr(tf, name), preds, target, task=task, **kw)


def test_validation_errors_match():
    preds, target = _binary_inputs(14, multidim=False)
    target[0] = 3
    with pytest.raises(RuntimeError, match="Detected the following values in `target`"):
        tf.binary_accuracy(torch.from_numpy(preds), torch.from_numpy(target))
    with pytest.raises(ValueError, match="num_classes"):
        tf.multiclass_accuracy(torch.zeros(4, 3), torch.zeros(4, dtype=torch.int32), num_classes=1)
    with pytest.raises(NotImplementedError, match="multilabel"):
        tf.accuracy(torch.zeros(4, 3), torch.zeros(4, 3, dtype=torch.int32), task="multilabel", num_labels=3)
