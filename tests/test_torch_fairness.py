"""Group fairness in the port, held against the JAX package on the CPU; the exports of
the whole classification family; and ``chip_smoke.py``'s CTR ``family_eval`` loop at a
small size in both packages.

The port counts the per-group tp/fp/tn/fn as one int32 histogram on the bincount
kernel (``group * 4 + cell``, a spare bin past ``4 * G`` for what is not counted), where
the JAX package contracts a float32 one-hot; here the kernel's plain version runs, as
on any CPU tensor. The same seeded numpy inputs go through both packages: probability,
logit and label ``preds``, ``threshold``, ``ignore_index``, every ``task`` of
``binary_fairness``, a batch whose samples all land in the spare bin, groups outside
``[0, G)`` and G = 1000. The cases mirror ``tests/classification/test_dice_fairness.py``.

Integers must be equal; floats agree within ``ATOL`` = 1e-5, and the float states of
the ``family_eval`` loops, sums of many terms in another order than JAX's, within ATOL
plus ``SUM_RTOL`` = 1e-6 of JAX's value.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
import torchmetrics_tpu as jtm  # noqa: E402
import torchmetrics_tpu.classification as jc  # noqa: E402
import torchmetrics_tpu.functional.classification as jf  # noqa: E402
import torchmetrics_tpu.functional.classification.group_fairness as jgf  # noqa: E402
import torchmetrics_tpu_torch as ttm  # noqa: E402
import torchmetrics_tpu_torch.classification as tc  # noqa: E402
import torchmetrics_tpu_torch.functional.classification as tf  # noqa: E402
import torchmetrics_tpu_torch.functional.classification.group_fairness as tgf  # noqa: E402
from test_torch_functional import assert_match  # noqa: E402
from torchmetrics_tpu_torch.convert import load_jax_state  # noqa: E402
from torchmetrics_tpu_torch.ops import kernels  # noqa: E402

ATOL = 1e-5
# float states that sum many terms (hinge, ranking, Dice) in another order than JAX's
SUM_RTOL = 1e-6
N, G = 64, 4


def _inputs(seed: int, kind: str = "probs", ignore_index=None, n: int = N, groups: int = G):
    rng = np.random.RandomState(seed)
    target = rng.randint(0, 2, n).astype(np.int32)
    z = (rng.randn(n) + 1.2 * target - 0.6).astype(np.float32)
    if ignore_index is not None:
        target[rng.rand(n) < 0.15] = ignore_index
    g = rng.randint(0, groups, n).astype(np.int32)
    if kind == "probs":
        return (1 / (1 + np.exp(-z))).astype(np.float32), target, g
    if kind == "logits":
        return z, target, g
    return (z > 0).astype(np.int32), target, g


def _match(want, got) -> None:
    if isinstance(want, dict):
        assert list(want) == list(got)
        for key in want:
            assert_match(want[key], got[key], ATOL)
    else:
        assert_match(want, got, ATOL)


def errors_match(jax_call, torch_call) -> None:
    """Both calls raise the same exception type with the same message."""
    with pytest.raises(Exception) as want:
        jax_call()
    with pytest.raises(Exception) as got:
        torch_call()
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


# -------------------------------------------------------------------- functional


@pytest.mark.parametrize("kind", ["probs", "logits", "labels"])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_binary_groups_stat_rates(threshold, ignore_index, kind):
    preds, target, groups = _inputs(1, kind, ignore_index)
    kw = {"num_groups": G, "threshold": threshold, "ignore_index": ignore_index}
    _match(jf.binary_groups_stat_rates(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(groups), **kw),
           tf.binary_groups_stat_rates(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(groups),
                                       **kw))


@pytest.mark.parametrize("kind", ["probs", "logits"])
@pytest.mark.parametrize("threshold", [0.5, 0.7])
def test_demographic_parity(threshold, kind):
    preds, _, groups = _inputs(2, kind)
    _match(jf.demographic_parity(jnp.asarray(preds), jnp.asarray(groups), threshold=threshold),
           tf.demographic_parity(torch.from_numpy(preds), torch.from_numpy(groups), threshold=threshold))


@pytest.mark.parametrize("kind", ["probs", "labels"])
@pytest.mark.parametrize("ignore_index", [None, -1])
def test_equal_opportunity(ignore_index, kind):
    preds, target, groups = _inputs(3, kind, ignore_index)
    kw = {"ignore_index": ignore_index}
    _match(jf.equal_opportunity(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(groups), **kw),
           tf.equal_opportunity(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(groups), **kw))


@pytest.mark.parametrize("task", ["demographic_parity", "equal_opportunity", "all"])
def test_binary_fairness(task):
    preds, target, groups = _inputs(4)
    _match(jf.binary_fairness(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(groups), task=task),
           tf.binary_fairness(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(groups), task=task))


def test_extreme_groups_name_the_first_minimum_and_maximum_as_jax_does():
    # groups 0 and 2 tie for the lowest rate, 1 and 3 for the highest
    preds = np.asarray([0, 0, 1, 1, 0, 0, 1, 1], np.int32)
    groups = np.asarray([0, 0, 1, 1, 2, 2, 3, 3], np.int32)
    target = np.asarray([1, 1, 1, 1, 1, 1, 1, 1], np.int32)
    _match(jf.binary_fairness(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(groups)),
           tf.binary_fairness(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(groups)))


# ------------------------------------------------------------- the bincount route


def _route_both(preds, target, groups, valid, num_groups):
    want = jgf._binary_groups_stat_scores_update(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(groups),
                                                 jnp.asarray(valid), num_groups)
    got = tgf._binary_groups_stat_scores_update(torch.from_numpy(preds), torch.from_numpy(target),
                                                torch.from_numpy(groups), torch.from_numpy(valid), num_groups)
    assert_match(want, got, 0)
    return got


@pytest.mark.parametrize("groups", [1, 8, 1000])
def test_counts_on_the_bincount_route_equal_jax_contraction(groups):
    rng = np.random.RandomState(5)
    n = 4096
    preds = rng.randint(0, 2, n).astype(np.int32)
    target = rng.randint(0, 2, n).astype(np.int32)
    g = rng.randint(0, groups, n).astype(np.int32)
    valid = rng.rand(n) > 0.1
    tp, fp, tn, fn = _route_both(preds, target, g, valid, groups)
    assert tp.dtype == torch.int32 and tp.shape == (groups,)
    assert int((tp + fp + tn + fn).sum()) == int(valid.sum())


def test_a_batch_of_only_uncounted_samples_fills_only_the_spare_bin():
    rng = np.random.RandomState(6)
    preds = rng.randint(0, 2, 32).astype(np.int32)
    target = rng.randint(0, 2, 32).astype(np.int32)
    groups = rng.randint(0, G, 32).astype(np.int32)
    ids = tgf._group_cell_ids(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(groups),
                              torch.zeros(32, dtype=torch.bool), G)
    assert bool((ids == 4 * G).all())
    counts = _route_both(preds, target, groups, np.zeros(32, bool), G)
    assert all(int(c.sum()) == 0 for c in counts)


def test_groups_outside_the_range_count_nowhere_as_jax_one_hot_rows():
    rng = np.random.RandomState(7)
    preds = rng.randint(0, 2, 64).astype(np.int32)
    target = rng.randint(0, 2, 64).astype(np.int32)
    groups = rng.randint(-3, G + 3, 64).astype(np.int32)
    _route_both(preds, target, groups, np.ones(64, bool), G)


def test_cells_are_tp_fp_tn_fn_in_that_order():
    preds = torch.tensor([1, 1, 0, 0], dtype=torch.int32)
    target = torch.tensor([1, 0, 0, 1], dtype=torch.int32)
    groups = torch.tensor([0, 0, 1, 1], dtype=torch.int32)
    ids = tgf._group_cell_ids(preds, target, groups, torch.ones(4, dtype=torch.bool), 2)
    assert ids.tolist() == [0, 1, 6, 7]


def test_an_update_is_one_bincount_call_without_a_mask(monkeypatch):
    calls = []
    real = kernels.bincount

    def spy(x, valid, minlength):
        calls.append((x.dtype, valid, minlength))
        return real(x, valid, minlength)

    monkeypatch.setattr(kernels, "bincount", spy)
    preds, target, groups = _inputs(8, ignore_index=-1)
    m = tc.BinaryFairness(G, ignore_index=-1, device="cpu")
    m.update(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(groups))
    assert calls == [(torch.int32, None, 4 * G + 1)]


# ---------------------------------------------------------------------- stateful


STATEFUL = {
    "rates": lambda m, **k: m.BinaryGroupStatRates(G, **k),
    "rates_ignore_threshold": lambda m, **k: m.BinaryGroupStatRates(G, threshold=0.3, ignore_index=-1, **k),
    "fairness_all": lambda m, **k: m.BinaryFairness(G, **k),
    "fairness_dp": lambda m, **k: m.BinaryFairness(G, task="demographic_parity", **k),
    "fairness_eo_ignore": lambda m, **k: m.BinaryFairness(G, task="equal_opportunity", ignore_index=-1, **k),
}


def _batches(case: str, seed: int = 20, count: int = 3):
    ignore = -1 if "ignore" in case else None
    return [_inputs(seed + i, ("probs", "logits", "labels")[i % 3], ignore, n=32) for i in range(count)]


def _leaves_match(want, got, where: str) -> None:
    if isinstance(want, dict):  # a MaskedBuffer: data and count
        assert int(got["count"]) == int(np.asarray(want["count"])), where
        _leaves_match(want["data"], got["data"], where)
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for w, g in zip(want, got):
            _leaves_match(w, g, where)
    else:
        w = np.asarray(want)
        if np.issubdtype(w.dtype, np.floating):
            g = got.detach().cpu().numpy()
            assert g.dtype == w.dtype and g.shape == w.shape, where
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=SUM_RTOL, err_msg=where)
        else:
            assert_match(w, got, 0)


def states_match(jm, tm) -> None:
    """The state dicts of a JAX metric and its port: integers equal, float states (sums)
    within ATOL plus SUM_RTOL of JAX's; lists item by item, a MaskedBuffer's data and count."""
    jsd, tsd = jm.state_dict(persistent_only=False), tm.state_dict(persistent_only=False)
    jsd.pop("__robust__", None)
    tsd.pop("__robust__", None)
    assert set(jsd) == set(tsd)
    for key, want in jsd.items():
        _leaves_match(want, tsd[key], key)


@pytest.mark.parametrize("case", sorted(STATEFUL))
def test_stateful_matches_jax(case):
    jm, tm = STATEFUL[case](jc), STATEFUL[case](tc, device="cpu")
    for preds, target, groups in _batches(case):
        jm.update(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(groups))
        tm.update(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(groups))
    states_match(jm, tm)
    assert tm.tp.dtype == torch.int32 and tm.tp.shape == (G,)
    _match(jm.compute(), tm.compute())


@pytest.mark.parametrize("case", ["rates_ignore_threshold", "fairness_all"])
def test_jax_state_dict_loads_into_the_port_and_goes_on(case):
    batches = _batches(case, seed=40, count=4)
    jax_full, jax_half = STATEFUL[case](jc), STATEFUL[case](jc)
    for i, (preds, target, groups) in enumerate(batches):
        jax_full.update(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(groups))
        if i < 2:
            jax_half.update(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(groups))
    port = load_jax_state(STATEFUL[case](tc, device="cpu"), jax_half.state_dict(persistent_only=False))
    for preds, target, groups in batches[2:]:
        port.update(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(groups))
    states_match(jax_full, port)
    _match(jax_full.compute(), port.compute())


def test_forward_returns_the_batch_value_as_jax_does():
    jm, tm = STATEFUL["fairness_all"](jc), STATEFUL["fairness_all"](tc, device="cpu")
    for preds, target, groups in _batches("forward", seed=50, count=2):
        _match(jm(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(groups)),
               tm(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(groups)))


# --------------------------------------------------------------------- validation


def test_arguments_and_groups_raise_as_jax_does():
    preds, target, groups = _inputs(9)
    for build in (lambda m, **k: m.BinaryGroupStatRates(1, **k),
                  lambda m, **k: m.BinaryFairness(G, task="parity", **k),
                  lambda m, **k: m.BinaryFairness(G, threshold=1.5, **k)):
        errors_match(lambda: build(jc), lambda: build(tc, device="cpu"))
    bad = groups.copy()
    bad[3] = G + 2
    errors_match(lambda: jf.binary_groups_stat_rates(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(bad), G),
                  lambda: tf.binary_groups_stat_rates(torch.from_numpy(preds), torch.from_numpy(target),
                                                      torch.from_numpy(bad), G))
    errors_match(lambda: jf.binary_fairness(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(groups), "eo"),
                  lambda: tf.binary_fairness(torch.from_numpy(preds), torch.from_numpy(target),
                                             torch.from_numpy(groups), "eo"))
    # the port's update checks values eagerly (JAX's jitted update skips them): JAX's message
    tm = tc.BinaryGroupStatRates(G, device="cpu")
    errors_match(lambda: jf.binary_groups_stat_rates(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(bad), G),
                  lambda: tm.update(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(bad)))


# ------------------------------------------------------------------------ exports


def test_the_port_exports_every_classification_name_of_jax():
    import torchmetrics_tpu.classification as jcls
    import torchmetrics_tpu.functional.classification as jfun

    assert set(jcls.__all__) <= set(tc.__all__)
    assert set(jfun.__all__) <= set(tf.__all__)
    assert set(jcls.__all__) <= set(ttm.__all__)
    for name in jcls.__all__:
        assert getattr(ttm, name) is getattr(tc, name)


# ------------------------------------------------------------ family_eval's loops


def family_loop_matches_jax(kind: str, preds, target, batch: int, segments=None) -> None:
    """``chip_smoke.py``'s ``family_eval`` loop ``kind`` (its metrics at their widths) in
    both packages over the given batches: equal states and values, the fixed points'
    thresholds bitwise, and JAX's compute groups."""
    jm = chip_smoke.family_metrics(kind, None, jc)
    tm = chip_smoke.family_metrics(kind, "cpu")
    if segments is not None:
        jm.update(chip_smoke.family_metrics(kind, None, jc, fairness=True))
        tm.update(chip_smoke.family_metrics(kind, "cpu", fairness=True))
    for start in range(0, preds.shape[0], batch):
        args = [x[start:start + batch] for x in (preds, target)]
        for name in jm:
            extra = [segments[start:start + batch]] if name in chip_smoke.FAMILY_FAIRNESS else []
            jm[name].update(*(jnp.asarray(x.numpy()) for x in args + extra))
            tm[name].update(*args, *extra)
    for name in jm:
        states_match(jm[name], tm[name])
        want, got = jm[name].compute(), tm[name].compute()
        _match(want, got)
        if "_at_" in name:
            assert np.array_equal(np.asarray(want[1]).view(np.int32), got[1].numpy().view(np.int32)), name
    jgroups = jtm.MetricCollection(chip_smoke.family_metrics(kind, None, jc)).compute_groups
    tgroups = ttm.MetricCollection(chip_smoke.family_metrics(kind, "cpu")).compute_groups
    assert tgroups == jgroups
    assert sorted(len(g) for g in tgroups.values()) == chip_smoke.FAMILY_GROUP_SIZES[kind]


def test_family_eval_ctr_loop_matches_jax():
    """The CTR loop with its fairness audit, 1000 thresholds, on 4 batches of 512."""
    preds, target = chip_smoke.binary_data(n=2048, device="cpu")
    segments = chip_smoke.segment_ids(2048, device="cpu")
    family_loop_matches_jax("ctr", preds, target, 512, segments)
    counts = torch.bincount(segments.to(torch.int64), minlength=chip_smoke.FAMILY_SEGMENTS)
    assert bool((counts[:-1] > counts[1:]).all())  # the shares fall with the segment's index
