"""Specificity, Hamming distance, exact match, Dice and hinge loss in the port, held
against the JAX package on the CPU.

The same seeded numpy inputs go through both packages: every ``average``,
``multidim_average``, ``top_k``, ``ignore_index`` and ``threshold``; label,
probability and logit ``preds``; Dice with ``num_classes=None`` and with ``multiclass``
forced; hinge loss in both multiclass modes, squared or not. Validation errors must
carry JAX's messages and JAX state dicts load through ``convert/jax_state.py``. The
cases mirror the JAX package's own (``tests/classification/test_{confmat_family,
curve_derived,dice_fairness,topk_samplewise}.py``).

Integers must be equal; floats agree within ``ATOL`` = 1e-5, and float states (sums of
many terms in another order than JAX's) within ATOL plus 1e-6 of JAX's value
(``test_torch_fairness.states_match``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import torchmetrics_tpu.classification as jc  # noqa: E402
import torchmetrics_tpu.functional.classification as jf  # noqa: E402
import torchmetrics_tpu_torch.classification as tc  # noqa: E402
import torchmetrics_tpu_torch.functional.classification as tf  # noqa: E402
import chip_smoke  # noqa: E402
from test_torch_fairness import errors_match, family_loop_matches_jax, states_match  # noqa: E402
from test_torch_functional import assert_match  # noqa: E402
from torchmetrics_tpu_torch.convert import load_jax_state  # noqa: E402

ATOL = 1e-5
N, C, L, X = 40, 5, 4, 3
KINDS = ("labels", "probs", "logits")


def _binary(seed: int, kind: str = "probs", ignore_index=None, multidim: bool = False, n: int = N):
    rng = np.random.RandomState(seed)
    shape = (n, X) if multidim else (n,)
    target = rng.randint(0, 2, shape).astype(np.int32)
    logits = (rng.randn(*shape) + 1.2 * target - 0.6).astype(np.float32)
    if ignore_index is not None:
        target[rng.rand(*shape) < 0.15] = ignore_index
    if kind == "probs":
        return (1 / (1 + np.exp(-logits))).astype(np.float32), target
    if kind == "logits":
        return logits, target
    return (logits > 0).astype(np.int32), target


def _multiclass(seed: int, kind: str = "probs", ignore_index=None, multidim: bool = False, n: int = N):
    rng = np.random.RandomState(seed)
    tshape = (n, X) if multidim else (n,)
    target = rng.randint(0, C, tshape).astype(np.int32)
    logits = rng.randn(*((n, C, X) if multidim else (n, C))).astype(np.float32)
    logits += 1.5 * np.moveaxis(np.eye(C, dtype=np.float32)[target], -1, 1)
    if ignore_index is not None:
        target[rng.rand(*tshape) < 0.15] = ignore_index
    if kind == "probs":
        e = np.exp(logits - logits.max(1, keepdims=True))
        return (e / e.sum(1, keepdims=True)).astype(np.float32), target
    if kind == "logits":
        return logits, target
    return logits.argmax(1).astype(np.int32), target


def _multilabel(seed: int, kind: str = "probs", ignore_index=None, multidim: bool = False, n: int = N):
    rng = np.random.RandomState(seed)
    shape = (n, L, X) if multidim else (n, L)
    target = (rng.rand(*shape) < 0.4).astype(np.int32)
    logits = (rng.randn(*shape) * 1.5 + 1.2 * target - 0.6).astype(np.float32)
    if ignore_index is not None:
        target[rng.rand(*shape) < 0.15] = ignore_index
    if kind == "probs":
        return (1 / (1 + np.exp(-logits))).astype(np.float32), target
    if kind == "logits":
        return logits, target
    return (logits > 0).astype(np.int32), target


def _both(name: str, preds, target, **kwargs) -> None:
    want = getattr(jf, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got = getattr(tf, name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    assert_match(want, got, ATOL)


# ------------------------------------------------------- specificity and Hamming


STAT = ("specificity", "hamming_distance")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("stat", STAT)
def test_binary(stat, ignore_index, multidim_average, kind):
    preds, target = _binary(1, kind, ignore_index, multidim=multidim_average == "samplewise")
    _both(f"binary_{stat}", preds, target, multidim_average=multidim_average, ignore_index=ignore_index)


@pytest.mark.parametrize("threshold", [0.3, 0.75])
@pytest.mark.parametrize("stat", STAT)
def test_binary_threshold(stat, threshold):
    preds, target = _binary(2, "probs")
    _both(f"binary_{stat}", preds, target, threshold=threshold)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("stat", STAT)
def test_multiclass(stat, average, kind):
    # the macro/weighted/none update is the confusion-matrix kernel's histogram
    preds, target = _multiclass(3, kind)
    _both(f"multiclass_{stat}", preds, target, num_classes=C, average=average)


@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
@pytest.mark.parametrize("average", ["micro", "macro", "none"])
@pytest.mark.parametrize("ignore_index", [None, -1, 0])
@pytest.mark.parametrize("stat", STAT)
def test_multiclass_multidim_and_ignore_index(stat, ignore_index, average, multidim_average):
    preds, target = _multiclass(4, "logits", ignore_index, multidim=True)
    _both(f"multiclass_{stat}", preds, target, num_classes=C, average=average, multidim_average=multidim_average,
          ignore_index=ignore_index)


@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("top_k", [2, 3])
@pytest.mark.parametrize("stat", STAT)
def test_multiclass_top_k(stat, top_k, average):
    preds, target = _multiclass(5, "probs")
    _both(f"multiclass_{stat}", preds, target, num_classes=C, average=average, top_k=top_k)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("stat", STAT)
def test_multilabel(stat, average, kind):
    preds, target = _multilabel(6, kind)
    _both(f"multilabel_{stat}", preds, target, num_labels=L, average=average)


@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
@pytest.mark.parametrize("threshold", [0.5, 0.3])
@pytest.mark.parametrize("stat", STAT)
def test_multilabel_multidim_threshold_ignore_index(stat, threshold, multidim_average):
    preds, target = _multilabel(7, "probs", -1, multidim=True)
    _both(f"multilabel_{stat}", preds, target, num_labels=L, threshold=threshold, multidim_average=multidim_average,
          ignore_index=-1)


# ------------------------------------------------------------------- exact match


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_multiclass_exact_match(ignore_index, multidim_average, kind):
    preds, target = _multiclass(8, kind, ignore_index, multidim=True)
    _both("multiclass_exact_match", preds, target, num_classes=C, multidim_average=multidim_average,
          ignore_index=ignore_index)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_multilabel_exact_match(ignore_index, kind):
    preds, target = _multilabel(9, kind, ignore_index)
    _both("multilabel_exact_match", preds, target, num_labels=L, ignore_index=ignore_index)


@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
@pytest.mark.parametrize("threshold", [0.5, 0.7])
def test_multilabel_exact_match_multidim(threshold, multidim_average):
    preds, target = _multilabel(10, "probs", multidim=True)
    _both("multilabel_exact_match", preds, target, num_labels=L, threshold=threshold,
          multidim_average=multidim_average)


# --------------------------------------------------------------------------- Dice


def _dice_labels(seed: int, classes: int = C, n: int = N):
    rng = np.random.RandomState(seed)
    return rng.randint(0, classes, n).astype(np.int32), rng.randint(0, classes, n).astype(np.int32)


@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("num_classes", [None, C])
def test_dice_labels(num_classes, average):
    # num_classes=None: the function reads the largest label back, as JAX does eagerly
    preds, target = _dice_labels(11)
    _both("dice", preds, target, num_classes=num_classes, average=average)


@pytest.mark.parametrize("average", ["micro", "macro", "samples", "none"])
@pytest.mark.parametrize("top_k", [None, 2])
@pytest.mark.parametrize("ignore_index", [None, 1])
def test_dice_multiclass_probs(ignore_index, top_k, average):
    preds, target = _multiclass(13, "probs")
    _both("dice", preds, target, num_classes=C, average=average, top_k=top_k, ignore_index=ignore_index)


@pytest.mark.parametrize("mdmc_average", ["global", "samplewise"])
@pytest.mark.parametrize("average", ["micro", "macro"])
def test_dice_multidim(average, mdmc_average):
    preds, target = _multiclass(14, "probs", multidim=True)
    _both("dice", preds, target, num_classes=C, average=average, mdmc_average=mdmc_average)


@pytest.mark.parametrize("kind", ["probs", "logits", "labels"])
@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_dice_binary(kind, threshold):
    preds, target = _binary(15, kind)
    _both("dice", preds, target, threshold=threshold)


@pytest.mark.parametrize("kind", ["probs", "labels"])
def test_dice_binary_forced_multiclass(kind):
    preds, target = _binary(16, kind)
    _both("dice", preds, target, multiclass=True, average="macro", num_classes=2)
    _both("dice", preds, target, multiclass=True)


def test_dice_multilabel_forced_not_multiclass():
    preds, target = _multilabel(17, "probs")
    _both("dice", preds, target, multiclass=False)
    _both("dice", preds, target, num_classes=L, multiclass=False, average="micro")


def test_dice_zero_division():
    preds = np.zeros(8, np.int32)
    target = np.zeros(8, np.int32)
    _both("dice", preds, target, zero_division=1.0)
    _both("dice", preds, target, zero_division=0.0)


# -------------------------------------------------------------------- hinge loss


@pytest.mark.parametrize("kind", ["probs", "logits"])
@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_binary_hinge(ignore_index, squared, kind):
    preds, target = _binary(18, kind, ignore_index)
    _both("binary_hinge_loss", preds, target, squared=squared, ignore_index=ignore_index)


@pytest.mark.parametrize("kind", ["probs", "logits"])
@pytest.mark.parametrize("mode", ["crammer-singer", "one-vs-all"])
@pytest.mark.parametrize("squared", [False, True])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_multiclass_hinge(ignore_index, squared, mode, kind):
    preds, target = _multiclass(19, kind, ignore_index)
    _both("multiclass_hinge_loss", preds, target, num_classes=C, squared=squared, multiclass_mode=mode,
          ignore_index=ignore_index)


# ------------------------------------------------------------------ task dispatch


TASKS = {
    "specificity_binary": ("specificity", _binary, {"task": "binary"}),
    "specificity_multiclass": ("specificity", _multiclass, {"task": "multiclass", "num_classes": C}),
    "specificity_multilabel": ("specificity", _multilabel, {"task": "multilabel", "num_labels": L}),
    "hamming_binary": ("hamming_distance", _binary, {"task": "binary"}),
    "hamming_multiclass": ("hamming_distance", _multiclass, {"task": "multiclass", "num_classes": C, "top_k": 2}),
    "hamming_multilabel": ("hamming_distance", _multilabel, {"task": "multilabel", "num_labels": L}),
    "exact_match_multilabel": ("exact_match", _multilabel, {"task": "multilabel", "num_labels": L}),
    "hinge_binary": ("hinge_loss", _binary, {"task": "binary"}),
    "hinge_multiclass": ("hinge_loss", _multiclass, {"task": "multiclass", "num_classes": C}),
}


@pytest.mark.parametrize("case", sorted(TASKS))
def test_task_dispatch(case):
    fn, make, kwargs = TASKS[case]
    preds, target = make(20)
    _both(fn, preds, target, **kwargs)


def test_exact_match_task_dispatch_multiclass():
    preds, target = _multiclass(21, "labels", multidim=True)
    _both("exact_match", preds, target, task="multiclass", num_classes=C)


# --------------------------------------------------------------------- validation


BAD_ARGS = {
    "specificity_threshold": ("binary_specificity", _binary, {"threshold": 2.0}),
    "specificity_average": ("multiclass_specificity", _multiclass, {"num_classes": C, "average": "samples"}),
    "specificity_top_k": ("multiclass_specificity", _multiclass, {"num_classes": C, "top_k": C + 1}),
    "hamming_labels": ("multilabel_hamming_distance", _multilabel, {"num_labels": 1}),
    "hamming_multidim": ("binary_hamming_distance", _binary, {"multidim_average": "per_sample"}),
    "exact_match_classes": ("multiclass_exact_match", _multiclass, {"num_classes": 1}),
    "exact_match_task": ("exact_match", _binary, {"task": "binary"}),
    "dice_average": ("dice", _multiclass, {"average": "all"}),
    "dice_not_multiclass": ("dice", _multiclass, {"multiclass": False}),
    "hinge_squared": ("binary_hinge_loss", _binary, {"squared": 1}),
    "hinge_mode": ("multiclass_hinge_loss", _multiclass, {"num_classes": C, "multiclass_mode": "all"}),
    "hinge_ignore": ("binary_hinge_loss", _binary, {"ignore_index": 0.5}),
    "hinge_task": ("hinge_loss", _multilabel, {"task": "multilabel"}),
    "task_classes": ("specificity", _multiclass, {"task": "multiclass"}),
}


@pytest.mark.parametrize("case", sorted(BAD_ARGS))
def test_bad_arguments_raise_as_jax_does(case):
    fn, make, kwargs = BAD_ARGS[case]
    preds, target = make(22)
    errors_match(lambda: getattr(jf, fn)(jnp.asarray(preds), jnp.asarray(target), **kwargs),
                  lambda: getattr(tf, fn)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs))


BAD_TENSORS = {
    "binary_shape": ("binary_specificity", lambda: (_binary(23)[0][:5], _binary(23)[1]), {}),
    "binary_values": ("binary_hamming_distance", lambda: (_binary(23)[0], _binary(23)[1] + 2), {}),
    "multiclass_values": ("multiclass_specificity",
                          lambda: (_multiclass(23, "labels")[0], (np.arange(N) % (C + 2)).astype(np.int32)),
                          {"num_classes": C}),
    "exact_match_samplewise_1d": ("multiclass_exact_match", lambda: _multiclass(23, "labels"),
                                  {"num_classes": C, "multidim_average": "samplewise"}),
    "hinge_classes_axis": ("multiclass_hinge_loss", lambda: _multiclass(23, "probs"), {"num_classes": C + 1}),
    "hinge_values": ("binary_hinge_loss", lambda: (_binary(23)[0], _binary(23)[1] * 3), {}),
}


@pytest.mark.parametrize("case", sorted(BAD_TENSORS))
def test_bad_tensors_raise_as_jax_does(case):
    fn, make, kwargs = BAD_TENSORS[case]
    preds, target = make()
    errors_match(lambda: getattr(jf, fn)(jnp.asarray(preds), jnp.asarray(target), **kwargs),
                  lambda: getattr(tf, fn)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs))


def test_class_arguments_raise_as_jax_does():
    for build in (lambda m, **k: m.Dice(average="macro", **k),
                  lambda m, **k: m.Dice(mdmc_average="all", **k),
                  lambda m, **k: m.MulticlassHingeLoss(C, multiclass_mode="ova", **k),
                  lambda m, **k: m.BinaryHingeLoss(squared="yes", **k),
                  lambda m, **k: m.MultilabelExactMatch(1, **k),
                  lambda m, **k: m.ExactMatch(task="binary", **k),
                  lambda m, **k: m.HingeLoss(task="multiclass", **k),
                  lambda m, **k: m.Specificity(task="multilabel", **k)):
        errors_match(lambda: build(jc), lambda: build(tc, device="cpu"))


# ---------------------------------------------------------------------- stateful


STATEFUL = {
    "specificity_binary_samplewise": (_binary, lambda m, **k: m.BinarySpecificity(multidim_average="samplewise", **k)),
    "specificity_multiclass_macro_ignore": (_multiclass, lambda m, **k: m.MulticlassSpecificity(C, ignore_index=-1,
                                                                                                 **k)),
    "specificity_multiclass_micro": (_multiclass, lambda m, **k: m.MulticlassSpecificity(C, average="micro", **k)),
    "specificity_multilabel_weighted": (_multilabel, lambda m, **k: m.MultilabelSpecificity(L, average="weighted",
                                                                                             **k)),
    "hamming_binary_ignore": (_binary, lambda m, **k: m.BinaryHammingDistance(ignore_index=-1, **k)),
    "hamming_multiclass_top2": (_multiclass, lambda m, **k: m.MulticlassHammingDistance(C, top_k=2, **k)),
    "hamming_multiclass_none": (_multiclass, lambda m, **k: m.MulticlassHammingDistance(C, average=None, **k)),
    "hamming_multilabel_micro": (_multilabel, lambda m, **k: m.MultilabelHammingDistance(L, average="micro", **k)),
    "exact_match_multiclass_samplewise": (_multiclass, lambda m, **k: m.MulticlassExactMatch(
        C, multidim_average="samplewise", **k)),
    "exact_match_multilabel": (_multilabel, lambda m, **k: m.MultilabelExactMatch(L, **k)),
    "exact_match_multilabel_samplewise_ignore": (_multilabel, lambda m, **k: m.MultilabelExactMatch(
        L, multidim_average="samplewise", ignore_index=-1, **k)),
    "dice_micro": (_multiclass, lambda m, **k: m.Dice(num_classes=C, **k)),
    "dice_micro_inferred": (_multiclass, lambda m, **k: m.Dice(**k)),
    "dice_macro": (_multiclass, lambda m, **k: m.Dice(num_classes=C, average="macro", **k)),
    "dice_weighted": (_multiclass, lambda m, **k: m.Dice(num_classes=C, average="weighted", **k)),
    "dice_samples": (_multiclass, lambda m, **k: m.Dice(num_classes=C, average="samples", **k)),
    "dice_samplewise_none": (_multiclass, lambda m, **k: m.Dice(num_classes=C, average="none",
                                                                 mdmc_average="samplewise", **k)),
    "hinge_binary_squared_ignore": (_binary, lambda m, **k: m.BinaryHingeLoss(squared=True, ignore_index=-1, **k)),
    "hinge_crammer_singer": (_multiclass, lambda m, **k: m.MulticlassHingeLoss(C, **k)),
    "hinge_one_vs_all_ignore": (_multiclass, lambda m, **k: m.MulticlassHingeLoss(C, multiclass_mode="one-vs-all",
                                                                                  ignore_index=-1, **k)),
}


def _batches(case: str, make, seed: int = 30, count: int = 3):
    multidim = "samplewise" in case or ("exact_match_multiclass" in case)
    ignore = -1 if "ignore" in case else None
    out = []
    for i in range(count):
        kind = "labels" if ("exact_match_multiclass" in case and i == 0) else ("logits" if i % 2 else "probs")
        if "hinge" in case and kind == "labels":
            kind = "probs"
        # batches of one size but for samplewise exact match, whose totals must add up across sizes
        n = 16 + 4 * i if "exact_match" in case and "samplewise" in case else 16
        out.append(make(seed + i, kind, ignore, multidim=multidim, n=n))
    return out


@pytest.mark.parametrize("case", sorted(STATEFUL))
def test_stateful_matches_jax(case):
    make, build = STATEFUL[case]
    jm, tm = build(jc), build(tc, device="cpu")
    for preds, target in _batches(case, make):
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    states_match(jm, tm)
    assert_match(jm.compute(), tm.compute(), ATOL)


@pytest.mark.parametrize("case", ["specificity_multiclass_macro_ignore", "exact_match_multilabel_samplewise_ignore",
                                  "dice_samples", "dice_micro", "hinge_one_vs_all_ignore"])
def test_jax_state_dict_loads_into_the_port_and_goes_on(case):
    make, build = STATEFUL[case]
    batches = _batches(case, make, seed=40, count=4)
    jax_full, jax_half = build(jc), build(jc)
    for i, (preds, target) in enumerate(batches):
        jax_full.update(jnp.asarray(preds), jnp.asarray(target))
        if i < 2:
            jax_half.update(jnp.asarray(preds), jnp.asarray(target))
    port = load_jax_state(build(tc, device="cpu"), jax_half.state_dict(persistent_only=False))
    for preds, target in batches[2:]:
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
    states_match(jax_full, port)
    assert_match(jax_full.compute(), port.compute(), ATOL)


@pytest.mark.parametrize("case", ["specificity_binary_samplewise", "hamming_multilabel_micro", "dice_macro",
                                  "hinge_crammer_singer"])
def test_forward_returns_the_batch_value_as_jax_does(case):
    make, build = STATEFUL[case]
    jm, tm = build(jc), build(tc, device="cpu")
    for preds, target in _batches(case, make, seed=50, count=2):
        assert_match(jm(jnp.asarray(preds), jnp.asarray(target)),
                     tm(torch.from_numpy(preds), torch.from_numpy(target)), ATOL)
    assert_match(jm.compute(), tm.compute(), ATOL)


def test_states_have_jax_shapes_and_dtypes():
    assert tc.MultilabelExactMatch(L, device="cpu").correct.dtype == torch.int32
    assert tc.MulticlassExactMatch(C, multidim_average="samplewise", device="cpu").correct == []
    d = tc.Dice(num_classes=C, device="cpu")
    assert d.tp.shape == (C,) and d.tp.dtype == torch.float32
    assert tc.Dice(average="samples", num_classes=C, device="cpu").tp == []
    h = tc.MulticlassHingeLoss(C, multiclass_mode="one-vs-all", device="cpu")
    assert h.measures.shape == (C,) and h.total.dtype == torch.float32
    assert tc.MulticlassSpecificity(C, device="cpu").tn.shape == (C,)


WRAPPERS = {
    ("Specificity", "binary"): "BinarySpecificity", ("Specificity", "multiclass"): "MulticlassSpecificity",
    ("Specificity", "multilabel"): "MultilabelSpecificity", ("HammingDistance", "binary"): "BinaryHammingDistance",
    ("HammingDistance", "multiclass"): "MulticlassHammingDistance",
    ("HammingDistance", "multilabel"): "MultilabelHammingDistance",
    ("ExactMatch", "multiclass"): "MulticlassExactMatch", ("ExactMatch", "multilabel"): "MultilabelExactMatch",
    ("HingeLoss", "binary"): "BinaryHingeLoss", ("HingeLoss", "multiclass"): "MulticlassHingeLoss",
}


@pytest.mark.parametrize("wrapper,task", sorted(WRAPPERS))
def test_task_wrapper_builds_the_class_jax_builds(wrapper, task):
    kw = {"num_classes": C} if wrapper == "HingeLoss" else {"num_classes": C, "num_labels": L}
    jm = getattr(jc, wrapper)(task=task, **kw)
    tm = getattr(tc, wrapper)(task=task, device="cpu", **kw)
    assert type(jm).__name__ == type(tm).__name__ == WRAPPERS[(wrapper, task)]
    assert tm._compute_group_params() == jm._compute_group_params()
    assert (tm.plot_lower_bound, tm.plot_upper_bound) == (jm.plot_lower_bound, jm.plot_upper_bound)
    assert tm._resolved_value_bounds() == jm._resolved_value_bounds()


def test_family_eval_imagenet_loop_matches_jax():
    """``chip_smoke.py``'s imagenet ``family_eval`` loop (1000 classes, 2 batches of 64) in both packages."""
    preds, target = chip_smoke.imagenet_data(n=128, device="cpu")
    family_loop_matches_jax("imagenet", preds, target, 64)
