"""The multilabel half of the classification family in the port, held against the JAX
package on the CPU.

Every multilabel function and class of the port (stat scores, accuracy, precision,
recall, F-beta/F1, confusion matrix, Jaccard, Matthews, the PR curve, ROC, AUROC and
average precision) gets the same seeded numpy inputs as its JAX counterpart: every
``average``, global and samplewise ``multidim_average`` with an extra dim
``[N, L, X]``, a ``threshold``, an ``ignore_index``, label, probability and logit
``preds``, binned and unbinned curves and a ``MaskedBuffer`` curve. The cases mirror
the JAX package's own (``tests/classification/test_{confmat_family,curves,accuracy,
precision_recall_fbeta,curve_derived}.py``). Validation errors must carry JAX's
messages, JAX state dicts load through ``convert/jax_state.py``, and a
``MetricCollection`` forms JAX's compute groups.

Integers must be equal; floats agree within ``ATOL`` = 1e-5.
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
import torchmetrics_tpu_torch as ttm  # noqa: E402
import torchmetrics_tpu_torch.classification as tc  # noqa: E402
import torchmetrics_tpu_torch.functional.classification as tf  # noqa: E402
from test_torch_functional import assert_match  # noqa: E402
from torchmetrics_tpu_torch.convert import load_jax_state  # noqa: E402

ATOL = 1e-5
N, L, X = 40, 4, 3
KINDS = ("labels", "probs", "logits")


def _inputs(seed: int, kind: str = "probs", ignore_index=None, multidim: bool = False, n: int = N):
    """preds [n, L] (or [n, L, X]) of ``kind`` and int32 0/1 targets, some set to
    ``ignore_index``."""
    rng = np.random.RandomState(seed)
    shape = (n, L, X) if multidim else (n, L)
    target = (rng.rand(*shape) < 0.4).astype(np.int32)
    logits = (rng.randn(*shape) * 1.5 + 1.2 * target - 0.6).astype(np.float32)
    if ignore_index is not None:
        target[rng.rand(*shape) < 0.15] = ignore_index
    if kind == "probs":
        preds = (1 / (1 + np.exp(-logits))).astype(np.float32)
    elif kind == "logits":
        preds = logits
    else:
        preds = (logits > 0).astype(np.int32)
    return preds, target


def _both(name: str, preds, target, **kwargs) -> None:
    """``name`` of both functional packages on the same arrays: equal results."""
    want = getattr(jf, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got = getattr(tf, name)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    assert_match(want, got, ATOL)


def _states_match(jm, tm) -> None:
    """Equal state dicts: lists item by item, a MaskedBuffer's data and count."""
    jsd, tsd = jm.state_dict(persistent_only=False), tm.state_dict(persistent_only=False)
    jsd.pop("__robust__", None)
    tsd.pop("__robust__", None)
    assert set(jsd) == set(tsd)
    for key, want in jsd.items():
        got = tsd[key]
        if isinstance(want, dict):
            assert int(got["count"]) == int(np.asarray(want["count"]))
            assert_match(want["data"], got["data"], ATOL)
        else:
            assert_match(want, got, ATOL)


# ------------------------------------------------------------------ stat scores


STAT_FNS = {
    "multilabel_stat_scores": {},
    "multilabel_accuracy": {},
    "multilabel_precision": {},
    "multilabel_recall": {},
    "multilabel_f1_score": {},
    "multilabel_fbeta_score": {"beta": 2.0},
}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("fn", sorted(STAT_FNS))
def test_stat_score_family_global(fn, average, kind):
    preds, target = _inputs(1, kind)
    _both(fn, preds, target, num_labels=L, average=average, **STAT_FNS[fn])


@pytest.mark.parametrize("multidim_average", ["global", "samplewise"])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("fn", sorted(STAT_FNS))
def test_stat_score_family_extra_dim_and_ignore_index(fn, average, multidim_average):
    preds, target = _inputs(2, "logits", ignore_index=-1, multidim=True)
    _both(fn, preds, target, num_labels=L, average=average, multidim_average=multidim_average, ignore_index=-1,
          **STAT_FNS[fn])


@pytest.mark.parametrize("threshold", [0.3, 0.75])
@pytest.mark.parametrize("fn", sorted(STAT_FNS))
def test_stat_score_family_threshold(fn, threshold):
    preds, target = _inputs(3, "probs")
    _both(fn, preds, target, num_labels=L, threshold=threshold, **STAT_FNS[fn])


def test_logits_are_squashed_only_when_outside_the_unit_interval():
    # values inside [0, 1] stay probabilities even if they came from logits
    preds, target = _inputs(4, "probs")
    _both("multilabel_stat_scores", preds * 0.5 + 0.25, target, num_labels=L, average=None)
    _both("multilabel_stat_scores", preds * 4 - 2, target, num_labels=L, average=None)


# ------------------------------------------------------- confusion-matrix family


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("normalize", [None, "true", "pred", "all"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_confusion_matrix(normalize, ignore_index, kind):
    preds, target = _inputs(5, kind, ignore_index)
    _both("multilabel_confusion_matrix", preds, target, num_labels=L, normalize=normalize, ignore_index=ignore_index)


@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("ignore_index", [None, -1, 1])
def test_jaccard(average, ignore_index):
    # ignore_index=1 is also a label index: JAX drops that label's weight
    preds, target = _inputs(6, "probs", ignore_index)
    _both("multilabel_jaccard_index", preds, target, num_labels=L, average=average, ignore_index=ignore_index)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_matthews(kind, ignore_index):
    preds, target = _inputs(7, kind, ignore_index, multidim=True)
    _both("multilabel_matthews_corrcoef", preds, target, num_labels=L, ignore_index=ignore_index)


def test_matthews_degenerate_all_correct():
    preds, target = _inputs(8, "labels")
    _both("multilabel_matthews_corrcoef", target.copy(), target, num_labels=L)


# ------------------------------------------------------------------------ curves


@pytest.mark.parametrize("thresholds", [None, 11, [0.1, 0.4, 0.6, 0.9]])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("fn", ["multilabel_precision_recall_curve", "multilabel_roc"])
def test_curves(fn, thresholds, ignore_index):
    preds, target = _inputs(9, "logits", ignore_index)
    _both(fn, preds, target, num_labels=L, thresholds=thresholds, ignore_index=ignore_index)


@pytest.mark.parametrize("fn", ["multilabel_precision_recall_curve", "multilabel_roc"])
def test_curves_extra_dim(fn):
    preds, target = _inputs(10, "probs", multidim=True)
    _both(fn, preds, target, num_labels=L, thresholds=None)
    _both(fn, preds, target, num_labels=L, thresholds=7)


@pytest.mark.parametrize("thresholds", [None, 11])
@pytest.mark.parametrize("average", ["micro", "macro", "weighted", "none"])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("fn", ["multilabel_auroc", "multilabel_average_precision"])
def test_auroc_and_average_precision(fn, average, thresholds, ignore_index):
    preds, target = _inputs(11, "probs", ignore_index)
    _both(fn, preds, target, num_labels=L, average=average, thresholds=thresholds, ignore_index=ignore_index)


def test_a_label_without_positives_is_left_out_of_the_macro_average():
    preds, target = _inputs(12, "probs")
    target[:, 2] = 0
    with pytest.warns(UserWarning, match="nan"):
        _both("multilabel_average_precision", preds, target, num_labels=L, average="macro")


# ------------------------------------------------------------------ task dispatch


TASK_FNS = {
    "stat_scores": {"average": "macro"}, "accuracy": {}, "precision": {}, "recall": {}, "f1_score": {},
    "fbeta_score": {"beta": 0.5}, "confusion_matrix": {}, "jaccard_index": {}, "matthews_corrcoef": {},
    "precision_recall_curve": {"thresholds": 5}, "roc": {"thresholds": None}, "auroc": {},
    "average_precision": {"thresholds": 9},
}


@pytest.mark.parametrize("fn", sorted(TASK_FNS))
def test_task_dispatch(fn):
    preds, target = _inputs(13, "probs")
    _both(fn, preds, target, task="multilabel", num_labels=L, **TASK_FNS[fn])


# --------------------------------------------------------------------- validation


def _errors_match(jax_call, torch_call) -> None:
    with pytest.raises(Exception) as want:
        jax_call()
    with pytest.raises(Exception) as got:
        torch_call()
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


BAD_ARGS = {
    "num_labels": ("multilabel_accuracy", {"num_labels": 1}),
    "threshold": ("multilabel_precision", {"num_labels": L, "threshold": 2.0}),
    "average": ("multilabel_recall", {"num_labels": L, "average": "samples"}),
    "multidim": ("multilabel_f1_score", {"num_labels": L, "multidim_average": "per_sample"}),
    "ignore_index": ("multilabel_stat_scores", {"num_labels": L, "ignore_index": 0.5}),
    "beta": ("multilabel_fbeta_score", {"num_labels": L, "beta": -1.0}),
    "normalize": ("multilabel_confusion_matrix", {"num_labels": L, "normalize": "rows"}),
    "jaccard_average": ("multilabel_jaccard_index", {"num_labels": L, "average": "samples"}),
    "thresholds": ("multilabel_precision_recall_curve", {"num_labels": L, "thresholds": 1}),
    "thresholds_list": ("multilabel_roc", {"num_labels": L, "thresholds": [0.5, 1.5]}),
    "curve_average": ("multilabel_auroc", {"num_labels": L, "average": "samples"}),
    "curve_labels": ("multilabel_average_precision", {"num_labels": 1}),
    "task_labels": ("accuracy", {"task": "multilabel", "num_labels": None}),
}


@pytest.mark.parametrize("case", sorted(BAD_ARGS))
def test_bad_arguments_raise_as_jax_does(case):
    fn, kwargs = BAD_ARGS[case]
    preds, target = _inputs(14, "probs")
    _errors_match(lambda: getattr(jf, fn)(jnp.asarray(preds), jnp.asarray(target), **kwargs),
                  lambda: getattr(tf, fn)(torch.from_numpy(preds), torch.from_numpy(target), **kwargs))


BAD_TENSORS = {
    "shape": ("multilabel_accuracy", lambda p, t: (p[:, :3], t), {}),
    "labels_axis": ("multilabel_stat_scores", lambda p, t: (p[:, :3], t[:, :3]), {}),
    "samplewise_2d": ("multilabel_precision", lambda p, t: (p, t), {"multidim_average": "samplewise"}),
    "target_values": ("multilabel_recall", lambda p, t: (p, t * 2), {}),
    "target_values_ignore": ("multilabel_f1_score", lambda p, t: (p, t * 2), {"ignore_index": 3}),
    "confmat_shape": ("multilabel_confusion_matrix", lambda p, t: (p[:, :3], t[:, :3]), {}),
    "confmat_values": ("multilabel_matthews_corrcoef", lambda p, t: (p, t + 1), {}),
    "curve_shape": ("multilabel_precision_recall_curve", lambda p, t: (p[:, :3], t), {}),
    "curve_int_preds": ("multilabel_roc", lambda p, t: ((p > 0.5).astype(np.int32), t), {}),
    "curve_labels_axis": ("multilabel_auroc", lambda p, t: (p[:, :3], t[:, :3]), {}),
}


@pytest.mark.parametrize("case", sorted(BAD_TENSORS))
def test_bad_tensors_raise_as_jax_does(case):
    fn, edit, kwargs = BAD_TENSORS[case]
    preds, target = edit(*_inputs(15, "probs"))
    _errors_match(lambda: getattr(jf, fn)(jnp.asarray(preds), jnp.asarray(target), num_labels=L, **kwargs),
                  lambda: getattr(tf, fn)(torch.from_numpy(preds), torch.from_numpy(target), num_labels=L, **kwargs))


# ---------------------------------------------------------------------- stateful


STATEFUL = {
    "stat_scores_macro": lambda m, **k: m.MultilabelStatScores(L, average="macro", **k),
    "stat_scores_micro": lambda m, **k: m.MultilabelStatScores(L, average="micro", **k),
    "stat_scores_samplewise": lambda m, **k: m.MultilabelStatScores(L, average=None, multidim_average="samplewise",
                                                                     **k),
    "accuracy_micro": lambda m, **k: m.MultilabelAccuracy(L, average="micro", **k),
    "accuracy_samplewise": lambda m, **k: m.MultilabelAccuracy(L, multidim_average="samplewise", **k),
    "precision_weighted": lambda m, **k: m.MultilabelPrecision(L, average="weighted", **k),
    "recall_none_ignore": lambda m, **k: m.MultilabelRecall(L, average="none", ignore_index=-1, **k),
    "f1_macro_threshold": lambda m, **k: m.MultilabelF1Score(L, threshold=0.3, **k),
    "fbeta_micro": lambda m, **k: m.MultilabelFBetaScore(2.0, L, average="micro", zero_division=1.0, **k),
    "confmat_normalized": lambda m, **k: m.MultilabelConfusionMatrix(L, normalize="true", **k),
    "jaccard_weighted_ignore": lambda m, **k: m.MultilabelJaccardIndex(L, average="weighted", ignore_index=-1, **k),
    "matthews": lambda m, **k: m.MultilabelMatthewsCorrCoef(L, **k),
    "pr_curve_exact": lambda m, **k: m.MultilabelPrecisionRecallCurve(L, **k),
    "pr_curve_binned_ignore": lambda m, **k: m.MultilabelPrecisionRecallCurve(L, thresholds=11, ignore_index=-1, **k),
    "pr_curve_buffer": lambda m, **k: m.MultilabelPrecisionRecallCurve(L, buffer_capacity=64, **k),
    "auroc_exact_ignore": lambda m, **k: m.MultilabelAUROC(L, ignore_index=-1, **k),
    "auroc_micro_binned": lambda m, **k: m.MultilabelAUROC(L, average="micro", thresholds=11, **k),
    "auroc_micro_buffer": lambda m, **k: m.MultilabelAUROC(L, average="micro", buffer_capacity=64, **k),
    "ap_macro_exact": lambda m, **k: m.MultilabelAveragePrecision(L, **k),
    "ap_weighted_binned": lambda m, **k: m.MultilabelAveragePrecision(L, average="weighted", thresholds=11, **k),
    "ap_none_buffer_ignore": lambda m, **k: m.MultilabelAveragePrecision(L, average=None, buffer_capacity=64,
                                                                          ignore_index=-1, **k),
}


def _batches(case: str, seed: int = 20, count: int = 3):
    multidim = "samplewise" in case
    ignore = -1 if "ignore" in case else None
    return [_inputs(seed + i, "logits" if i % 2 else "probs", ignore, multidim=multidim, n=16) for i in range(count)]


@pytest.mark.parametrize("case", sorted(STATEFUL))
def test_stateful_matches_jax(case):
    jm, tm = STATEFUL[case](jc), STATEFUL[case](tc, device="cpu")
    for preds, target in _batches(case):
        jm.update(jnp.asarray(preds), jnp.asarray(target))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target))
    _states_match(jm, tm)
    assert_match(jm.compute(), tm.compute(), ATOL)


@pytest.mark.parametrize("case", ["accuracy_micro", "confmat_normalized", "pr_curve_binned_ignore"])
def test_forward_returns_the_batch_value_as_jax_does(case):
    jm, tm = STATEFUL[case](jc), STATEFUL[case](tc, device="cpu")
    for preds, target in _batches(case, seed=30, count=2):
        assert_match(jm(jnp.asarray(preds), jnp.asarray(target)), tm(torch.from_numpy(preds), torch.from_numpy(target)),
                     ATOL)
    assert_match(jm.compute(), tm.compute(), ATOL)


@pytest.mark.parametrize("case", ["stat_scores_samplewise", "f1_macro_threshold", "jaccard_weighted_ignore",
                                  "pr_curve_exact", "auroc_micro_binned", "ap_none_buffer_ignore"])
def test_jax_state_dict_loads_into_the_port_and_goes_on(case):
    batches = _batches(case, seed=40, count=4)
    jax_full, jax_half = STATEFUL[case](jc), STATEFUL[case](jc)
    for i, (preds, target) in enumerate(batches):
        jax_full.update(jnp.asarray(preds), jnp.asarray(target))
        if i < 2:
            jax_half.update(jnp.asarray(preds), jnp.asarray(target))
    port = load_jax_state(STATEFUL[case](tc, device="cpu"), jax_half.state_dict(persistent_only=False))
    for preds, target in batches[2:]:
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
    _states_match(jax_full, port)
    assert_match(jax_full.compute(), port.compute(), ATOL)


def test_states_have_jax_shapes_and_dtypes():
    m = tc.MultilabelPrecisionRecallCurve(L, thresholds=11, device="cpu")
    assert m.confmat.shape == (11, L, 2, 2) and m.confmat.dtype == torch.int32
    b = tc.MultilabelAveragePrecision(L, buffer_capacity=8, device="cpu")
    assert b.preds.data.shape == (8, L) and b.target.data.dtype == torch.int32 and b.valid.data.shape == (8, L)
    c = tc.MultilabelConfusionMatrix(L, device="cpu")
    assert c.confmat.shape == (L, 2, 2) and c.confmat.dtype == torch.int32
    s = tc.MultilabelStatScores(L, device="cpu")
    assert s.tp.shape == (L,) and s.tp.dtype == torch.int32
    with pytest.raises(ValueError, match="buffer_capacity"):
        tc.MultilabelAUROC(L, thresholds=5, buffer_capacity=8, device="cpu")


WRAPPERS = {
    "StatScores": "MultilabelStatScores", "Accuracy": "MultilabelAccuracy", "Precision": "MultilabelPrecision",
    "Recall": "MultilabelRecall", "FBetaScore": "MultilabelFBetaScore", "F1Score": "MultilabelF1Score",
    "ConfusionMatrix": "MultilabelConfusionMatrix", "JaccardIndex": "MultilabelJaccardIndex",
    "MatthewsCorrCoef": "MultilabelMatthewsCorrCoef", "PrecisionRecallCurve": "MultilabelPrecisionRecallCurve",
    "AUROC": "MultilabelAUROC", "AveragePrecision": "MultilabelAveragePrecision",
}


@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
def test_task_wrapper_builds_the_multilabel_class_as_jax_does(wrapper):
    jm = getattr(jc, wrapper)(task="multilabel", num_labels=L)
    tm = getattr(tc, wrapper)(task="multilabel", num_labels=L, device="cpu")
    assert type(jm).__name__ == type(tm).__name__ == WRAPPERS[wrapper]
    assert tm._compute_group_params() == jm._compute_group_params()
    _errors_match(lambda: getattr(jc, wrapper)(task="multilabel"),
                  lambda: getattr(tc, wrapper)(task="multilabel", device="cpu"))


def test_calibration_error_and_cohen_kappa_refuse_multilabel_as_jax_does():
    for wrapper in ("CalibrationError", "CohenKappa"):
        _errors_match(lambda: getattr(jc, wrapper)(task="multilabel", num_labels=L),
                      lambda: getattr(tc, wrapper)(task="multilabel", num_labels=L, device="cpu"))


# --------------------------------------------------------------- compute groups


def _eval_metrics(pkg, **k):
    """The metrics of ``chip_smoke.py``'s ``multilabel_eval`` at L labels."""
    c, kw = pkg.classification, {"validate_args": False, **k}
    return {
        "map_exact": c.MultilabelAveragePrecision(L, "macro", **kw),
        "map_t200": c.MultilabelAveragePrecision(L, "macro", thresholds=11, **kw),
        "auroc_macro_t200": c.MultilabelAUROC(L, "macro", thresholds=11, **kw),
        "auroc_micro_t200": c.MultilabelAUROC(L, "micro", thresholds=11, **kw),
        "cp": c.MultilabelPrecision(L, average="macro", **kw),
        "cr": c.MultilabelRecall(L, average="macro", **kw),
        "cf1": c.MultilabelF1Score(L, average="macro", **kw),
        "op": c.MultilabelPrecision(L, average="micro", **kw),
        "or": c.MultilabelRecall(L, average="micro", **kw),
        "of1": c.MultilabelF1Score(L, average="micro", **kw),
        "accuracy": c.MultilabelAccuracy(L, **kw),
        "confusion_matrix": c.MultilabelConfusionMatrix(L, **kw),
        "jaccard": c.MultilabelJaccardIndex(L, **kw),
        "matthews": c.MultilabelMatthewsCorrCoef(L, **kw),
    }


def test_collection_forms_the_compute_groups_jax_forms():
    jcol = jtm.MetricCollection(_eval_metrics(jtm))
    tcol = ttm.MetricCollection(_eval_metrics(ttm, device="cpu"))
    groups = sorted(sorted(g) for g in tcol.compute_groups.values())
    assert groups == sorted(sorted(g) for g in jcol.compute_groups.values())
    assert sorted(len(g) for g in groups) == [1, 3, 3, 7]
    for preds, target in _batches("collection", seed=50, count=3):
        jcol.update(jnp.asarray(preds), jnp.asarray(target))
        tcol.update(torch.from_numpy(preds), torch.from_numpy(target))
    want, got = jcol.compute(), tcol.compute()
    assert set(want) == set(got)
    for name in want:
        assert_match(want[name], got[name], ATOL)
