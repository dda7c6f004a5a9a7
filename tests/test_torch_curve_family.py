"""The fixed operating points, the stateful ROC and the label-ranking metrics of the
port, held against the JAX package on the CPU.

The same seeded numpy inputs go through both packages: binned and unbinned curves,
binary, multiclass (one-vs-rest and micro) and multilabel, with and without
``ignore_index``; the two selection rules on crafted curves (the lexicographic
``_best_subject_to`` with its ``1e6`` sentinel for a best value of 0, and the first
feasible maximum of ``_first_max_subject_to``), including ties; ranking rows with no
relevant label. JAX state dicts load through ``convert/jax_state.py`` and a mixed
``MetricCollection`` forms JAX's compute groups. The cases mirror the JAX package's own
(``tests/classification/test_{curve_derived,curves,confmat_family}.py``).

Integers must be equal and the thresholds of a fixed operating point bitwise equal;
other floats agree within ``ATOL`` = 1e-5, and float states (sums) within ATOL plus 1e-6
of JAX's value (``test_torch_fairness.states_match``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import torchmetrics_tpu as jtm  # noqa: E402
import torchmetrics_tpu.classification as jc  # noqa: E402
import torchmetrics_tpu.functional.classification as jf  # noqa: E402
import torchmetrics_tpu.functional.classification.fixed_operating_point as jfop  # noqa: E402
import torchmetrics_tpu_torch as ttm  # noqa: E402
import torchmetrics_tpu_torch.classification as tc  # noqa: E402
import torchmetrics_tpu_torch.functional.classification as tf  # noqa: E402
import torchmetrics_tpu_torch.functional.classification.fixed_operating_point as tfop  # noqa: E402
import chip_smoke  # noqa: E402
from test_torch_fairness import errors_match, family_loop_matches_jax, states_match  # noqa: E402
from test_torch_functional import assert_match  # noqa: E402
from torchmetrics_tpu_torch.convert import load_jax_state  # noqa: E402

ATOL = 1e-5
N, C, L = 48, 4, 4


def _binary(seed: int, ignore_index=None, n: int = N, logits: bool = False):
    rng = np.random.RandomState(seed)
    target = rng.randint(0, 2, n).astype(np.int32)
    z = (rng.randn(n) + 1.2 * target - 0.6).astype(np.float32)
    if ignore_index is not None:
        target[rng.rand(n) < 0.15] = ignore_index
    # a few repeated scores, so the unbinned curve has ties
    z[: n // 4] = np.round(z[: n // 4], 1)
    return (z if logits else (1 / (1 + np.exp(-z))).astype(np.float32)), target


def _multiclass(seed: int, ignore_index=None, n: int = N, logits: bool = False):
    rng = np.random.RandomState(seed)
    target = rng.randint(0, C, n).astype(np.int32)
    z = (rng.randn(n, C) + 1.5 * np.eye(C, dtype=np.float32)[target]).astype(np.float32)
    if ignore_index is not None:
        target[rng.rand(n) < 0.15] = ignore_index
    if logits:
        return z, target
    e = np.exp(z - z.max(1, keepdims=True))
    return (e / e.sum(1, keepdims=True)).astype(np.float32), target


def _multilabel(seed: int, ignore_index=None, n: int = N, logits: bool = False):
    rng = np.random.RandomState(seed)
    target = (rng.rand(n, L) < 0.4).astype(np.int32)
    z = (rng.randn(n, L) * 1.5 + 1.2 * target - 0.6).astype(np.float32)
    if ignore_index is not None:
        target[rng.rand(n, L) < 0.15] = ignore_index
    return (z if logits else (1 / (1 + np.exp(-z))).astype(np.float32)), target


def _fixed_match(want, got) -> None:
    """(value, threshold): values within ATOL, thresholds bitwise."""
    (wv, wt), (gv, gt) = want, got
    assert_match(wv, gv, ATOL)
    wt, gt = np.asarray(wt), gt.detach().cpu().numpy()
    assert wt.shape == gt.shape and wt.dtype == gt.dtype == np.float32
    assert np.array_equal(wt.view(np.int32), gt.view(np.int32)), (wt, gt)


def _call(pkg, name, preds, target, kwargs):
    arr = jnp.asarray if pkg is jf else torch.from_numpy
    return getattr(pkg, name)(arr(preds), arr(target), **kwargs)


# ------------------------------------------------------------- selection rules


RULES = ("_best_subject_to", "_first_max_subject_to")
CURVES = {
    # value, constraint, thresholds (one fewer than the curve's points)
    "feasible": ([0.2, 0.5, 0.5, 0.9, 1.0], [0.9, 0.8, 0.85, 0.6, 0.4], [0.1, 0.3, 0.5, 0.7]),
    "value_ties_then_constraint": ([0.5, 0.5, 0.5, 0.3, 1.0], [0.7, 0.9, 0.9, 0.95, 0.1], [0.1, 0.2, 0.3, 0.4]),
    "infeasible": ([0.2, 0.5, 0.9, 1.0], [0.1, 0.2, 0.3, 0.4], [0.1, 0.2, 0.3]),
    "best_value_zero": ([0.0, 0.0, 0.0, 1.0], [0.9, 0.95, 0.99, 0.1], [0.2, 0.4, 0.6]),
    "floor_exactly_met": ([0.25, 0.75, 0.75, 1.0], [0.5, 0.5, 0.49999997, 0.2], [0.3, 0.6, 0.9]),
}


@pytest.mark.parametrize("curve", sorted(CURVES))
@pytest.mark.parametrize("rule", RULES)
def test_selection_rules_match_jax(rule, curve):
    value, constraint, thresholds = (np.asarray(a, np.float32) for a in CURVES[curve])
    want = getattr(jfop, rule)(jnp.asarray(value), jnp.asarray(constraint), 0.5, jnp.asarray(thresholds))
    got = getattr(tfop, rule)(torch.from_numpy(value), torch.from_numpy(constraint), 0.5, torch.from_numpy(thresholds))
    _fixed_match(want, got)


@pytest.mark.parametrize("rule", RULES)
def test_selection_rules_over_a_class_axis_match_jax(rule):
    value = np.stack([np.asarray(CURVES[k][0][:4], np.float32) for k in sorted(CURVES)])
    constraint = np.stack([np.asarray(CURVES[k][1][:4], np.float32) for k in sorted(CURVES)])
    thresholds = np.asarray([0.1, 0.3, 0.5], np.float32)
    want = getattr(jfop, rule)(jnp.asarray(value), jnp.asarray(constraint), 0.5, jnp.asarray(thresholds))
    got = getattr(tfop, rule)(torch.from_numpy(value), torch.from_numpy(constraint), 0.5, torch.from_numpy(thresholds))
    _fixed_match(want, got)


# ---------------------------------------------------------------- fixed points


FIXED = {
    "recall_at_fixed_precision": "min_precision",
    "precision_at_fixed_recall": "min_recall",
    "specificity_at_sensitivity": "min_sensitivity",
    "sensitivity_at_specificity": "min_specificity",
}


@pytest.mark.parametrize("thresholds,floor", [(None, 0.5), (21, 0.5), (21, 0.9), ([0.1, 0.3, 0.5, 0.7, 0.9], 0.5)])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("fn", sorted(FIXED))
def test_binary_fixed_point(fn, ignore_index, thresholds, floor):
    preds, target = _binary(1, ignore_index, logits=thresholds is None)
    kw = {FIXED[fn]: floor, "thresholds": thresholds, "ignore_index": ignore_index}
    _fixed_match(_call(jf, f"binary_{fn}", preds, target, kw), _call(tf, f"binary_{fn}", preds, target, kw))


@pytest.mark.parametrize("thresholds,ignore_index", [(None, None), (11, None), (11, -1)])
@pytest.mark.parametrize("fn", sorted(FIXED))
def test_multiclass_fixed_point(fn, thresholds, ignore_index):
    preds, target = _multiclass(2, ignore_index)
    kw = {FIXED[fn]: 0.5, "thresholds": thresholds, "ignore_index": ignore_index, "num_classes": C}
    _fixed_match(_call(jf, f"multiclass_{fn}", preds, target, kw), _call(tf, f"multiclass_{fn}", preds, target, kw))


@pytest.mark.parametrize("thresholds,ignore_index", [(None, None), (11, None), (11, -1)])
@pytest.mark.parametrize("fn", sorted(FIXED))
def test_multilabel_fixed_point(fn, thresholds, ignore_index):
    preds, target = _multilabel(3, ignore_index, logits=True)
    kw = {FIXED[fn]: 0.5, "thresholds": thresholds, "ignore_index": ignore_index, "num_labels": L}
    _fixed_match(_call(jf, f"multilabel_{fn}", preds, target, kw), _call(tf, f"multilabel_{fn}", preds, target, kw))


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("fn", sorted(FIXED))
def test_fixed_point_task_dispatch(fn, task):
    make = {"binary": _binary, "multiclass": _multiclass, "multilabel": _multilabel}[task]
    preds, target = make(4)
    kw = {FIXED[fn]: 0.6, "thresholds": 15, "task": task, "num_classes": C, "num_labels": L}
    _fixed_match(_call(jf, fn, preds, target, kw), _call(tf, fn, preds, target, kw))


def test_unreachable_floor_reports_the_sentinel_as_jax_does():
    preds, target = _binary(5)
    for fn in sorted(FIXED):
        kw = {FIXED[fn]: 1.0, "thresholds": 5}
        _fixed_match(_call(jf, f"binary_{fn}", preds, target, kw), _call(tf, f"binary_{fn}", preds, target, kw))


# ------------------------------------------------------------------------- ROC


@pytest.mark.parametrize("thresholds,ignore_index", [(None, None), (11, None), (11, -1)])
@pytest.mark.parametrize("average", [None, "micro", "macro"])
def test_multiclass_roc_average(average, thresholds, ignore_index):
    preds, target = _multiclass(6, ignore_index)
    kw = {"num_classes": C, "thresholds": thresholds, "ignore_index": ignore_index, "average": average}
    assert_match(_call(jf, "multiclass_roc", preds, target, kw), _call(tf, "multiclass_roc", preds, target, kw), ATOL)


# ------------------------------------------------------------------------ ranking


RANKING = ("multilabel_coverage_error", "multilabel_ranking_average_precision", "multilabel_ranking_loss")


@pytest.mark.parametrize("logits", [False, True])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("fn", RANKING)
def test_ranking(fn, ignore_index, logits):
    preds, target = _multilabel(7, ignore_index, logits=logits)
    kw = {"num_labels": L, "ignore_index": ignore_index}
    assert_match(_call(jf, fn, preds, target, kw), _call(tf, fn, preds, target, kw), ATOL)


@pytest.mark.parametrize("fn", RANKING)
def test_ranking_rows_without_a_relevant_label(fn):
    # coverage 0, LRAP 1 and loss 0 for such rows, as JAX's where gives; a row all relevant too
    preds, target = _multilabel(8)
    target[::3] = 0
    target[1::5] = 1
    preds[2::7] = 0.5  # tied scores
    kw = {"num_labels": L}
    assert_match(_call(jf, fn, preds, target, kw), _call(tf, fn, preds, target, kw), ATOL)


@pytest.mark.parametrize("fn", RANKING)
def test_ranking_multidim(fn):
    rng = np.random.RandomState(9)
    target = (rng.rand(12, L, 3) < 0.4).astype(np.int32)
    preds = rng.rand(12, L, 3).astype(np.float32)
    kw = {"num_labels": L}
    assert_match(_call(jf, fn, preds, target, kw), _call(tf, fn, preds, target, kw), ATOL)


# --------------------------------------------------------------------- validation


BAD = {
    "floor_high": ("binary_recall_at_fixed_precision", _binary, {"min_precision": 1.5}),
    "floor_type": ("binary_precision_at_fixed_recall", _binary, {"min_recall": "half"}),
    "floor_negative": ("multiclass_specificity_at_sensitivity", _multiclass,
                       {"num_classes": C, "min_sensitivity": -0.1}),
    "thresholds": ("binary_sensitivity_at_specificity", _binary, {"min_specificity": 0.5, "thresholds": 1}),
    "classes": ("multiclass_recall_at_fixed_precision", _multiclass, {"num_classes": 1, "min_precision": 0.5}),
    "labels": ("multilabel_precision_at_fixed_recall", _multilabel, {"num_labels": 1, "min_recall": 0.5}),
    "task_classes": ("recall_at_fixed_precision", _multiclass, {"task": "multiclass", "min_precision": 0.5}),
    "ranking_int_preds": ("multilabel_ranking_loss", lambda s: ((_multilabel(s)[0] > 0.5).astype(np.int32),
                                                                _multilabel(s)[1]), {"num_labels": L}),
    "ranking_shape": ("multilabel_coverage_error", lambda s: (_multilabel(s)[0][:, :3], _multilabel(s)[1]),
                      {"num_labels": L}),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_bad_arguments_raise_as_jax_does(case):
    fn, make, kwargs = BAD[case]
    preds, target = make(10)
    errors_match(lambda: _call(jf, fn, preds, target, kwargs), lambda: _call(tf, fn, preds, target, kwargs))


def test_class_arguments_raise_as_jax_does():
    for build in (lambda m, **k: m.BinaryRecallAtFixedPrecision(2.0, **k),
                  lambda m, **k: m.MulticlassSensitivityAtSpecificity(C, -1.0, **k),
                  lambda m, **k: m.MultilabelSpecificityAtSensitivity(L, 0.5, thresholds=0, **k),
                  lambda m, **k: m.MultilabelRankingLoss(1, **k),
                  lambda m, **k: m.ROC(task="multiclass", **k),
                  lambda m, **k: m.PrecisionAtFixedRecall(task="multilabel", min_recall=0.5, **k)):
        errors_match(lambda: build(jc), lambda: build(tc, device="cpu"))


# ---------------------------------------------------------------------- stateful


STATEFUL = {
    "recall_at_precision_binary_binned": (_binary, lambda m, **k: m.BinaryRecallAtFixedPrecision(0.5, 21, **k)),
    "precision_at_recall_binary_binned_ignore": (_binary, lambda m, **k: m.BinaryPrecisionAtFixedRecall(
        0.5, [0.2, 0.4, 0.6, 0.8], ignore_index=-1, **k)),
    "spec_at_sens_binary_binned": (_binary, lambda m, **k: m.BinarySpecificityAtSensitivity(0.9, 21, **k)),
    "sens_at_spec_binary_exact": (_binary, lambda m, **k: m.BinarySensitivityAtSpecificity(0.9, **k)),
    "recall_at_precision_multiclass_binned": (_multiclass, lambda m, **k: m.MulticlassRecallAtFixedPrecision(
        C, 0.5, 11, **k)),
    "precision_at_recall_multiclass_binned": (_multiclass, lambda m, **k: m.MulticlassPrecisionAtFixedRecall(
        C, 0.5, 11, **k)),
    "spec_at_sens_multiclass_binned_ignore": (_multiclass, lambda m, **k: m.MulticlassSpecificityAtSensitivity(
        C, 0.5, 11, ignore_index=-1, **k)),
    "spec_at_sens_multiclass_exact": (_multiclass, lambda m, **k: m.MulticlassSpecificityAtSensitivity(C, 0.5, **k)),
    "sens_at_spec_multiclass_binned": (_multiclass, lambda m, **k: m.MulticlassSensitivityAtSpecificity(
        C, 0.5, 11, **k)),
    "recall_at_precision_multilabel_binned": (_multilabel, lambda m, **k: m.MultilabelRecallAtFixedPrecision(
        L, 0.5, 11, **k)),
    "precision_at_recall_multilabel_binned": (_multilabel, lambda m, **k: m.MultilabelPrecisionAtFixedRecall(
        L, 0.5, 11, **k)),
    "spec_at_sens_multilabel_binned": (_multilabel, lambda m, **k: m.MultilabelSpecificityAtSensitivity(
        L, 0.5, 11, **k)),
    "sens_at_spec_multilabel_exact": (_multilabel, lambda m, **k: m.MultilabelSensitivityAtSpecificity(L, 0.5, **k)),
    "roc_binary_binned_ignore": (_binary, lambda m, **k: m.BinaryROC(21, ignore_index=-1, **k)),
    "roc_binary_exact": (_binary, lambda m, **k: m.BinaryROC(**k)),
    "roc_binary_buffer": (_binary, lambda m, **k: m.BinaryROC(buffer_capacity=64, **k)),
    "roc_multiclass_binned": (_multiclass, lambda m, **k: m.MulticlassROC(C, 11, **k)),
    "roc_multiclass_micro_binned": (_multiclass, lambda m, **k: m.MulticlassROC(C, 11, average="micro", **k)),
    "roc_multiclass_macro_exact": (_multiclass, lambda m, **k: m.MulticlassROC(C, average="macro", **k)),
    "roc_multilabel_binned_ignore": (_multilabel, lambda m, **k: m.MultilabelROC(L, 11, ignore_index=-1, **k)),
    "roc_multilabel_exact": (_multilabel, lambda m, **k: m.MultilabelROC(L, **k)),
    "coverage_error": (_multilabel, lambda m, **k: m.MultilabelCoverageError(L, **k)),
    "ranking_ap_ignore": (_multilabel, lambda m, **k: m.MultilabelRankingAveragePrecision(L, ignore_index=-1, **k)),
    "ranking_loss": (_multilabel, lambda m, **k: m.MultilabelRankingLoss(L, **k)),
}


def _batches(case: str, make, seed: int = 30, count: int = 3):
    ignore = -1 if "ignore" in case else None
    return [make(seed + i, ignore, n=16, logits=bool(i % 2)) for i in range(count)]


def _compute_match(case, want, got) -> None:
    if "_at_" in case:
        _fixed_match(want, got)
    else:
        assert_match(want, got, ATOL)


@pytest.mark.parametrize("case", sorted(STATEFUL))
def test_stateful_matches_jax(case):
    make, build = STATEFUL[case]
    jm, tm = build(jc), build(tc, device="cpu")
    for preds, target in _batches(case, make):
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    states_match(jm, tm)
    _compute_match(case, jm.compute(), tm.compute())


@pytest.mark.parametrize("case", ["recall_at_precision_binary_binned", "spec_at_sens_multiclass_exact",
                                  "roc_binary_buffer", "roc_multilabel_binned_ignore", "ranking_ap_ignore"])
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
    _compute_match(case, jax_full.compute(), port.compute())


WRAPPERS = {
    "RecallAtFixedPrecision": ("RecallAtFixedPrecision", {"min_precision": 0.5}),
    "PrecisionAtFixedRecall": ("PrecisionAtFixedRecall", {"min_recall": 0.5}),
    "SpecificityAtSensitivity": ("SpecificityAtSensitivity", {"min_sensitivity": 0.5}),
    "SensitivityAtSpecificity": ("SensitivityAtSpecificity", {"min_specificity": 0.5}),
    "ROC": ("ROC", {}),
}


@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
def test_task_wrapper_builds_the_class_jax_builds(wrapper, task):
    name, kw = WRAPPERS[wrapper]
    kw = {**kw, "task": task, "thresholds": 11, "num_classes": C, "num_labels": L}
    jm, tm = getattr(jc, name)(**kw), getattr(tc, name)(device="cpu", **kw)
    assert type(jm).__name__ == type(tm).__name__ == task.capitalize() + name
    assert tm._compute_group_params() == jm._compute_group_params()


def test_collection_forms_the_compute_groups_jax_forms():
    def metrics(pkg, **k):
        c = pkg.classification
        return {
            "roc": c.BinaryROC(thresholds=21, **k),
            "recall_at_p": c.BinaryRecallAtFixedPrecision(0.5, thresholds=21, **k),
            "spec_at_sens": c.BinarySpecificityAtSensitivity(0.9, thresholds=21, **k),
            "pr_curve": c.BinaryPrecisionRecallCurve(thresholds=21, **k),
            "auroc": c.BinaryAUROC(thresholds=21, **k),
            "roc_exact": c.BinaryROC(**k),
            "sens_at_spec_exact": c.BinarySensitivityAtSpecificity(0.9, **k),
            "specificity": c.BinarySpecificity(**k),
            "hamming": c.BinaryHammingDistance(**k),
            "accuracy": c.BinaryAccuracy(**k),
            "hinge": c.BinaryHingeLoss(**k),
        }

    jcol = jtm.MetricCollection(metrics(jtm))
    tcol = ttm.MetricCollection(metrics(ttm, device="cpu"))
    groups = sorted(sorted(g) for g in tcol.compute_groups.values())
    assert groups == sorted(sorted(g) for g in jcol.compute_groups.values())
    assert sorted(len(g) for g in groups) == [1, 2, 3, 5]
    for preds, target in _batches("collection", _binary, seed=50):
        jcol.update(jnp.asarray(preds), jnp.asarray(target))
        tcol.update(torch.from_numpy(preds), torch.from_numpy(target))
    want, got = jcol.compute(), tcol.compute()
    assert set(want) == set(got)
    for name in want:
        _compute_match(name.replace("recall_at_p", "_at_"), want[name], got[name])


def test_family_eval_coco_loop_matches_jax():
    """``chip_smoke.py``'s coco ``family_eval`` loop (80 labels, 2 batches of 128) in both packages."""
    preds, target = chip_smoke.multilabel_data(n=256, device="cpu")
    family_loop_matches_jax("coco", preds, target, 128)
