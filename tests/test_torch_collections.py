"""The port's ``MetricCollection`` held against the JAX package's.

Every case of ``tests/core/test_collections.py`` runs here as one parametrised case:
the same scenario, fed the same seeded numpy batches, is played in both packages and
what it observes (keys, compute groups, values, update counts, errors) must be the
same. Then the compute groups of ``chip_smoke.py``'s ImageNet and CTR metric sets at
C=10, their ``compute``, ``forward``, ``reset``, ``clone`` and ``state_dict`` keys, and
last the aliasing rule: a compute-group member's direct ``update`` or
``load_state_dict`` leaves its leader's states as they were.

Integers must be equal; floats agree within ``ATOL`` = 1e-6.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import torchmetrics_tpu as jtm  # noqa: E402
import torchmetrics_tpu.aggregation as jagg  # noqa: E402
import torchmetrics_tpu.classification as jc  # noqa: E402
import torchmetrics_tpu_torch as ttm  # noqa: E402
import torchmetrics_tpu_torch.classification as tc  # noqa: E402
from torchmetrics_tpu_torch import Metric  # noqa: E402

ATOL = 1e-6
NUM_CLASSES = 5


class _Sum(Metric):
    """The JAX package's ``SumMetric`` for one float input (the port has no aggregation yet)."""

    full_state_update = False

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("sum_value", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, value):
        self.sum_value = self.sum_value + value.to(torch.float32).sum()

    def compute(self):
        return self.sum_value


class _Mean(Metric):
    """The JAX package's ``MeanMetric`` for one float input."""

    full_state_update = False

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.add_state("mean_value", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("weight", torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, value):
        self.mean_value = self.mean_value + value.to(torch.float32).sum()
        self.weight = self.weight + value.numel()

    def compute(self):
        return self.mean_value / self.weight


def _classes(module, **fixed):
    """Every class of ``module``, built with ``fixed`` keyword arguments added."""
    return SimpleNamespace(**{
        name: (lambda cls: lambda *a, **k: cls(*a, **fixed, **k))(getattr(module, name))
        for name in dir(module) if name[0].isupper()
    })


JAX = SimpleNamespace(
    name="jax", MetricCollection=jtm.MetricCollection, c=_classes(jc), arr=jnp.asarray,
    Sum=jagg.SumMetric, Mean=jagg.MeanMetric,
    states=lambda m: m.metric_state,
)
TORCH = SimpleNamespace(
    name="torch", MetricCollection=ttm.MetricCollection, c=_classes(tc, device="cpu"), arr=torch.as_tensor,
    Sum=lambda: _Sum(device="cpu"), Mean=lambda: _Mean(device="cpu"),
    states=lambda m: m._state_values,
)


def _np(x):
    """A package's result as numpy (recursively)."""
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if hasattr(x, "__array__") and not isinstance(x, (bool, int, float, str)):
        return np.asarray(x)
    return x


def _assert_same(want, got, where: str = "result") -> None:
    if isinstance(want, dict):
        assert list(got) == list(want), f"{where}: keys {list(got)} != {list(want)}"
        for k in want:
            _assert_same(want[k], got[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), f"{where}: length {len(got)} != {len(want)}"
        for i, (a, b) in enumerate(zip(want, got)):
            _assert_same(a, b, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.shape == want.shape, f"{where}: shape {got.shape} != {want.shape}"
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=where)
        else:
            np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, f"{where}: {got!r} != {want!r}"


def _batches(pkg, n=4, b=32):
    rng = np.random.RandomState(7)
    preds = [rng.rand(b, NUM_CLASSES).astype(np.float32) for _ in range(n)]
    target = [rng.randint(0, NUM_CLASSES, (b,)).astype(np.int32) for _ in range(n)]
    return [pkg.arr(p) for p in preds], [pkg.arr(t) for t in target]


def _raises(fn, match: str):
    """The type of the error ``fn`` raises, and whether its message holds ``match``."""
    try:
        fn()
    except Exception as err:  # the scenario's observation is the error itself
        return type(err).__name__, match in str(err)
    return None


# ------------------------------------------------------------------- the scenarios
# Each takes a package namespace and returns what it observes.


def from_list_keys_are_class_names(pkg):
    col = pkg.MetricCollection([pkg.c.MulticlassAccuracy(NUM_CLASSES), pkg.c.MulticlassPrecision(NUM_CLASSES)])
    return sorted(col.keys())


def from_args(pkg):
    return len(pkg.MetricCollection(pkg.c.MulticlassAccuracy(NUM_CLASSES), pkg.c.MulticlassPrecision(NUM_CLASSES)))


def from_dict_sorted(pkg):
    col = pkg.MetricCollection({"b_acc": pkg.c.MulticlassAccuracy(NUM_CLASSES),
                                "a_prec": pkg.c.MulticlassPrecision(NUM_CLASSES)})
    return list(col.keys())


def duplicate_class_names_raise(pkg):
    return _raises(lambda: pkg.MetricCollection([pkg.c.MulticlassAccuracy(NUM_CLASSES),
                                                 pkg.c.MulticlassAccuracy(NUM_CLASSES)]), "two metrics both named")


def not_a_metric_raises(pkg):
    return _raises(lambda: pkg.MetricCollection([pkg.c.MulticlassAccuracy(NUM_CLASSES), "nope"]), "not a instance")


def prefix_postfix(pkg):
    col = pkg.MetricCollection([pkg.c.MulticlassAccuracy(NUM_CLASSES)], prefix="train_", postfix="_epoch")
    bad = _raises(lambda: pkg.MetricCollection([pkg.c.MulticlassAccuracy(NUM_CLASSES)], prefix=5),
                  "Expected input `prefix`")
    return list(col.keys()), bad


def getitem_with_prefix(pkg):
    col = pkg.MetricCollection([pkg.c.MulticlassAccuracy(NUM_CLASSES)], prefix="train_")
    return type(col["train_MulticlassAccuracy"]).__name__, type(col["MulticlassAccuracy"]).__name__


def nested_collections_flatten(pkg):
    inner = pkg.MetricCollection([pkg.c.BinaryAccuracy()], prefix="in_")
    return list(pkg.MetricCollection({"grp": inner}).keys())


def static_groups_merge_stat_scores(pkg):
    return pkg.MetricCollection([
        pkg.c.MulticlassAccuracy(NUM_CLASSES, average="weighted"),
        pkg.c.MulticlassPrecision(NUM_CLASSES, average="macro"),
        pkg.c.MulticlassRecall(NUM_CLASSES, average="macro"),
    ]).compute_groups


def micro_scalar_state_gets_own_group(pkg):
    return pkg.MetricCollection([
        pkg.c.MulticlassAccuracy(NUM_CLASSES, average="micro"),
        pkg.c.MulticlassPrecision(NUM_CLASSES, average="macro"),
        pkg.c.MulticlassRecall(NUM_CLASSES, average="macro"),
    ]).compute_groups


def different_params_do_not_merge(pkg):
    return pkg.MetricCollection({"a": pkg.c.MulticlassAccuracy(NUM_CLASSES, ignore_index=0),
                                 "b": pkg.c.MulticlassAccuracy(NUM_CLASSES)}).compute_groups


def curve_family_groups(pkg):
    return pkg.MetricCollection([pkg.c.BinaryAUROC(thresholds=10),
                                 pkg.c.BinaryAveragePrecision(thresholds=10)]).compute_groups


def disable(pkg):
    return pkg.MetricCollection([pkg.c.MulticlassAccuracy(NUM_CLASSES), pkg.c.MulticlassPrecision(NUM_CLASSES)],
                                compute_groups=False).compute_groups


def user_specified_groups(pkg):
    return pkg.MetricCollection(
        [pkg.c.MulticlassAccuracy(NUM_CLASSES), pkg.c.MulticlassPrecision(NUM_CLASSES),
         pkg.c.MulticlassConfusionMatrix(NUM_CLASSES)],
        compute_groups=[["MulticlassAccuracy", "MulticlassPrecision"]],
    ).compute_groups


def bad_user_groups_raise(pkg):
    return _raises(lambda: pkg.MetricCollection([pkg.c.MulticlassAccuracy(NUM_CLASSES)],
                                                compute_groups=[["NotThere"]]), "compute_groups")


def _grouped_matches_ungrouped(pkg, grouped):
    preds, target = _batches(pkg)
    col = pkg.MetricCollection([
        pkg.c.MulticlassAccuracy(NUM_CLASSES, average="micro"),
        pkg.c.MulticlassPrecision(NUM_CLASSES, average="macro"),
        pkg.c.MulticlassRecall(NUM_CLASSES, average="weighted"),
    ], compute_groups=grouped)
    singles = {"MulticlassAccuracy": pkg.c.MulticlassAccuracy(NUM_CLASSES, average="micro"),
               "MulticlassPrecision": pkg.c.MulticlassPrecision(NUM_CLASSES, average="macro"),
               "MulticlassRecall": pkg.c.MulticlassRecall(NUM_CLASSES, average="weighted")}
    for p, t in zip(preds, target):
        col.update(p, t)
        for m in singles.values():
            m.update(p, t)
    res = col.compute()
    for k, m in singles.items():
        np.testing.assert_allclose(_np(res[k]), _np(m.compute()), rtol=1e-6)
    return res


def grouped_matches_ungrouped_true(pkg):
    return _grouped_matches_ungrouped(pkg, True)


def grouped_matches_ungrouped_false(pkg):
    return _grouped_matches_ungrouped(pkg, False)


def group_update_count_propagates(pkg):
    preds, target = _batches(pkg, n=3)
    col = pkg.MetricCollection([pkg.c.MulticlassAccuracy(NUM_CLASSES), pkg.c.MulticlassPrecision(NUM_CLASSES)])
    for p, t in zip(preds, target):
        col.update(p, t)
    return [m.update_count for m in col.values()]


def forward_matches_single_metric(pkg):
    preds, target = _batches(pkg, n=2)
    col = pkg.MetricCollection([pkg.c.MulticlassAccuracy(NUM_CLASSES), pkg.c.MulticlassPrecision(NUM_CLASSES)])
    single_acc, single_prec = pkg.c.MulticlassAccuracy(NUM_CLASSES), pkg.c.MulticlassPrecision(NUM_CLASSES)
    outs = []
    for p, t in zip(preds, target):
        out = col(p, t)
        np.testing.assert_allclose(_np(out["MulticlassAccuracy"]), _np(single_acc(p, t)), rtol=1e-6)
        np.testing.assert_allclose(_np(out["MulticlassPrecision"]), _np(single_prec(p, t)), rtol=1e-6)
        outs.append(out)
    np.testing.assert_allclose(_np(col.compute()["MulticlassAccuracy"]), _np(single_acc.compute()), rtol=1e-6)
    return outs, col.compute()


def reset(pkg):
    preds, target = _batches(pkg, n=1)
    col = pkg.MetricCollection([pkg.c.MulticlassAccuracy(NUM_CLASSES), pkg.c.MulticlassPrecision(NUM_CLASSES)])
    col.update(preds[0], target[0])
    col.reset()
    return [m.update_count for m in col.values()]


def confmat_derived_group(pkg):
    col = pkg.MetricCollection([pkg.c.MulticlassConfusionMatrix(NUM_CLASSES), pkg.c.MulticlassCohenKappa(NUM_CLASSES)])
    groups = dict(col.compute_groups)
    preds, target = _batches(pkg, n=2)
    for p, t in zip(preds, target):
        col.update(p, t)
    return groups, col.compute()


def forward_then_compute_not_stale_for_members(pkg):
    preds, target = _batches(pkg, n=2)
    col = pkg.MetricCollection([pkg.c.MulticlassAccuracy(NUM_CLASSES), pkg.c.MulticlassPrecision(NUM_CLASSES)])
    col(preds[0], target[0])
    first = col.compute()
    col(preds[1], target[1])
    single = pkg.c.MulticlassPrecision(NUM_CLASSES)
    single.update(preds[0], target[0])
    single.update(preds[1], target[1])
    second = col.compute()
    np.testing.assert_allclose(_np(second["MulticlassPrecision"]), _np(single.compute()), rtol=1e-6)
    return first, second


def bare_collection_input(pkg):
    return list(pkg.MetricCollection(pkg.MetricCollection([pkg.c.BinaryAccuracy()])).keys())


def member_direct_update_does_not_corrupt_leader_list_state(pkg):
    rng = np.random.RandomState(3)
    p1, t1 = pkg.arr(rng.rand(16).astype(np.float32)), pkg.arr(rng.randint(0, 2, (16,)).astype(np.int32))
    p2, t2 = pkg.arr(rng.rand(16).astype(np.float32)), pkg.arr(rng.randint(0, 2, (16,)).astype(np.int32))
    col = pkg.MetricCollection([pkg.c.BinaryAUROC(thresholds=None), pkg.c.BinaryAveragePrecision(thresholds=None)])
    col.update(p1, t1)
    col["BinaryAveragePrecision"].update(p2, t2)
    leader = col[col.compute_groups[0][0]]
    return dict(col.compute_groups), len(pkg.states(leader)["preds"]), col.compute()


def forward_member_value_shape_matches_standalone(pkg):
    rng = np.random.RandomState(4)
    p, t = pkg.arr(rng.rand(16).astype(np.float32)), pkg.arr(rng.randint(0, 2, (16,)).astype(np.int32))
    out = pkg.MetricCollection([pkg.c.BinaryPrecision(), pkg.c.BinaryRecall()])(p, t)
    ref = pkg.c.BinaryRecall()(p, t)
    assert _np(out["BinaryRecall"]).shape == _np(ref).shape
    return out, ref


def clone_with_prefix(pkg):
    col = pkg.MetricCollection([pkg.c.MulticlassAccuracy(NUM_CLASSES)])
    return list(col.clone(prefix="val_").keys()), list(col.keys())


def clone_independent_state(pkg):
    preds, target = _batches(pkg, n=1)
    col = pkg.MetricCollection([pkg.c.MulticlassAccuracy(NUM_CLASSES)])
    c2 = col.clone()
    col.update(preds[0], target[0])
    return col["MulticlassAccuracy"].update_count, c2["MulticlassAccuracy"].update_count


def state_dict_roundtrip(pkg):
    preds, target = _batches(pkg, n=2)
    col = pkg.MetricCollection([pkg.c.MulticlassAccuracy(NUM_CLASSES), pkg.c.MulticlassPrecision(NUM_CLASSES)])
    col.persistent(True)
    for p, t in zip(preds, target):
        col.update(p, t)
    sd = col.state_dict()
    col2 = pkg.MetricCollection([pkg.c.MulticlassAccuracy(NUM_CLASSES), pkg.c.MulticlassPrecision(NUM_CLASSES)])
    col2.persistent(True)
    col2.load_state_dict(sd)
    return sorted(sd), col2.compute(), col.compute()


def add_metrics_after_update_not_grouped_into_stateful(pkg):
    preds, target = _batches(pkg, n=1)
    col = pkg.MetricCollection([pkg.c.MulticlassAccuracy(NUM_CLASSES)])
    col.update(preds[0], target[0])
    col["prec"] = pkg.c.MulticlassPrecision(NUM_CLASSES)
    return col.compute_groups


def heterogeneous_kwargs_filtering(pkg):
    col = pkg.MetricCollection({"sum": pkg.Sum(), "mean": pkg.Mean()})
    col.update(pkg.arr(np.asarray([1.0, 2.0, 3.0], dtype=np.float32)))
    return col.compute()


def group_update_runs_leader_only(pkg):
    col = pkg.MetricCollection([pkg.c.MulticlassAccuracy(NUM_CLASSES), pkg.c.MulticlassPrecision(NUM_CLASSES),
                                pkg.c.MulticlassRecall(NUM_CLASSES)])
    counts = {}
    for name, m in col.items():
        def make(nm, orig):
            def f(*a, **k):
                counts[nm] = counts.get(nm, 0) + 1
                return orig(*a, **k)
            return f

        m._dispatch_update = make(name, m._dispatch_update)
    preds, target = _batches(pkg, n=4)
    for p, t in zip(preds, target):
        col.update(p, t)
    return counts, sorted(col.compute())


SCENARIOS = [
    from_list_keys_are_class_names, from_args, from_dict_sorted, duplicate_class_names_raise, not_a_metric_raises,
    prefix_postfix, getitem_with_prefix, nested_collections_flatten, static_groups_merge_stat_scores,
    micro_scalar_state_gets_own_group, different_params_do_not_merge, curve_family_groups, disable,
    user_specified_groups, bad_user_groups_raise, grouped_matches_ungrouped_true, grouped_matches_ungrouped_false,
    group_update_count_propagates, forward_matches_single_metric, reset, confmat_derived_group,
    forward_then_compute_not_stale_for_members, bare_collection_input,
    member_direct_update_does_not_corrupt_leader_list_state, forward_member_value_shape_matches_standalone,
    clone_with_prefix, clone_independent_state, state_dict_roundtrip,
    add_metrics_after_update_not_grouped_into_stateful, heterogeneous_kwargs_filtering, group_update_runs_leader_only,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s.__name__ for s in SCENARIOS])
def test_collection_scenario_matches_jax(scenario):
    _assert_same(_np(scenario(JAX)), _np(scenario(TORCH)), scenario.__name__)


# -------------------------------------------------- chip_smoke.py's sets at C=10

C = 10


def imagenet_set(pkg):
    c, kw = pkg.c, {"validate_args": False}
    return {
        "accuracy_top1": c.MulticlassAccuracy(C, average="micro", **kw),
        "accuracy_macro": c.MulticlassAccuracy(C, average="macro", **kw),
        "f1_macro": c.MulticlassF1Score(C, average="macro", **kw),
        "precision_macro": c.MulticlassPrecision(C, average="macro", **kw),
        "recall_macro": c.MulticlassRecall(C, average="macro", **kw),
        "confusion_matrix": c.MulticlassConfusionMatrix(C, **kw),
        "jaccard_macro": c.MulticlassJaccardIndex(C, average="macro", **kw),
        "matthews": c.MulticlassMatthewsCorrCoef(C, **kw),
        "cohen_kappa": c.MulticlassCohenKappa(C, **kw),
        "calibration_error_b15": c.MulticlassCalibrationError(C, n_bins=15, **kw),
        "auroc_t100": c.MulticlassAUROC(C, thresholds=100, **kw),
        "pr_curve_micro_t200": c.MulticlassPrecisionRecallCurve(C, average="micro", thresholds=200, **kw),
    }


def binary_set(pkg):
    c, kw = pkg.c, {"validate_args": False, "ignore_index": -1}
    return {
        "auroc_t1000": c.BinaryAUROC(thresholds=1000, **kw),
        "accuracy": c.BinaryAccuracy(**kw),
        "f1": c.BinaryF1Score(**kw),
        "confusion_matrix": c.BinaryConfusionMatrix(**kw),
        "average_precision_t1000": c.BinaryAveragePrecision(thresholds=1000, **kw),
        "matthews": c.BinaryMatthewsCorrCoef(**kw),
        "jaccard": c.BinaryJaccardIndex(**kw),
        "calibration_error_b15": c.BinaryCalibrationError(n_bins=15, **kw),
    }


def _set_batches(kind: str, pkg, steps: int = 3, n: int = 64):
    rng = np.random.RandomState(11 if kind == "imagenet" else 12)
    out = []
    for _ in range(steps):
        if kind == "imagenet":
            logits = rng.randn(n, C).astype(np.float32)
            preds = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
            target = rng.randint(0, C, n).astype(np.int32)
        else:
            preds = rng.rand(n).astype(np.float32)
            target = np.where(rng.rand(n) < 0.05, -1, rng.randint(0, 2, n)).astype(np.int32)
        out.append((pkg.arr(preds.astype(np.float32)), pkg.arr(target)))
    return out


SETS = {"imagenet": imagenet_set, "binary": binary_set}
EXPECTED_GROUPS = {
    "imagenet": [["accuracy_macro", "f1_macro", "precision_macro", "recall_macro"],
                 ["accuracy_top1"],
                 ["cohen_kappa", "confusion_matrix", "jaccard_macro", "matthews"],
                 ["auroc_t100"], ["calibration_error_b15"], ["pr_curve_micro_t200"]],
    "binary": [["accuracy", "f1"], ["auroc_t1000", "average_precision_t1000"],
               ["confusion_matrix", "jaccard", "matthews"], ["calibration_error_b15"]],
}


@pytest.mark.parametrize("kind", list(SETS))
def test_chip_smoke_sets_group_as_in_jax(kind):
    want = jtm.MetricCollection(SETS[kind](JAX)).compute_groups
    got = ttm.MetricCollection(SETS[kind](TORCH)).compute_groups
    assert got == want
    assert sorted(sorted(g) for g in got.values()) == sorted(EXPECTED_GROUPS[kind])


def _lifecycle(kind: str, pkg):
    """forward on two batches, update on a third, compute, then clone with a prefix,
    reset and state_dict keys; returns what each step observed."""
    col = pkg.MetricCollection(SETS[kind](pkg), prefix="val_")
    (p0, t0), (p1, t1), (p2, t2) = _set_batches(kind, pkg)
    forwards = [col(p0, t0), col(p1, t1)]
    col.update(p2, t2)
    values = col.compute()
    clone = col.clone(prefix="test_")
    keys = sorted(k for name, m in col.items(keep_base=True)
                  for k in m.state_dict(prefix=f"{name}.", persistent_only=False))
    col.reset()
    return {
        "forwards": forwards, "values": values, "clone_keys": list(clone.keys()),
        "clone_values": clone.compute(), "state_dict_keys": keys,
        "counts_after_reset": [m.update_count for m in col.values()],
        "nested": list(pkg.MetricCollection({"outer": col}, postfix="_x").keys()),
    }


@pytest.mark.parametrize("kind", list(SETS))
def test_chip_smoke_sets_forward_compute_clone_reset_match_jax(kind):
    want, got = _np(_lifecycle(kind, JAX)), _np(_lifecycle(kind, TORCH))
    _assert_same(want, got, kind)


@pytest.mark.parametrize("kind", list(SETS))
def test_pure_api_of_the_collection_matches_its_stateful_api(kind):
    """``init_state``/``pure_update``/``sync_state``/``pure_compute`` are keyed by leader
    and give what ``update``/``compute`` give, in both packages."""
    results = {}
    for pkg in (JAX, TORCH):
        col = pkg.MetricCollection(SETS[kind](pkg))
        states = col.init_state()
        assert list(states) == [members[0] for members in col.compute_groups.values()]
        for p, t in _set_batches(kind, pkg):
            states = col.pure_update(states, p, t)
            col.update(p, t)
        results[pkg.name] = _np(col.pure_compute(col.sync_state(states)))
        _assert_same(_np(col.compute()), results[pkg.name], f"{pkg.name} pure vs stateful")
    _assert_same(results["jax"], results["torch"], kind)


def test_a_member_never_changes_its_leaders_states():
    """A member's direct ``update`` and ``load_state_dict`` rebind the member's own
    states; the leader's tensors keep their values (no state is written in place)."""
    col = ttm.MetricCollection(imagenet_set(TORCH))
    batches = _set_batches("imagenet", TORCH)
    col.update(*batches[0])
    leader, member = col["confusion_matrix"], col["matthews"]
    assert member._state_values["confmat"] is leader._state_values["confmat"]  # aliased by design
    before = leader._state_values["confmat"].clone()
    member.update(*batches[1])
    assert torch.equal(leader._state_values["confmat"], before)
    assert not torch.equal(member._state_values["confmat"], before)
    member.load_state_dict({"confmat": torch.ones_like(before)})
    assert torch.equal(leader._state_values["confmat"], before)
    col.to_device("cpu")  # `_apply` binds what it returns
    assert torch.equal(col["confusion_matrix"]._state_values["confmat"], before)
    col.update(*batches[2])  # the group re-binds the leader's state to its members
    assert col["matthews"]._state_values["confmat"] is col["confusion_matrix"]._state_values["confmat"]
    assert torch.equal(col["confusion_matrix"]._state_values["confmat"] - before,
                       tc.MulticlassConfusionMatrix(C, device="cpu").pure_update(
                           {"confmat": torch.zeros_like(before)}, *batches[2])["confmat"])


def test_a_jax_collection_state_loads_into_the_port():
    from torchmetrics_tpu_torch.convert import load_jax_state

    jcol, tcol = jtm.MetricCollection(binary_set(JAX)), ttm.MetricCollection(binary_set(TORCH))
    jbatches = _set_batches("binary", JAX)
    for p, t in jbatches[:2]:
        jcol.update(p, t)
    load_jax_state(tcol, jcol.state_dict())  # every state of these metrics is persistent=False
    assert all(m.update_count == 0 for m in tcol.values())
    tcol.persistent(True)
    jcol.persistent(True)
    load_jax_state(tcol, jcol.state_dict())
    p, t = _set_batches("binary", TORCH)[2]
    jcol.update(*jbatches[2])
    tcol.update(p, t)
    _assert_same(_np(jcol.compute()), _np(tcol.compute()), "binary")
