"""The nominal association metrics of the port, held against the JAX package on the CPU.

The cases of ``tests/domains/test_clustering_nominal_segmentation_pairwise.py``'s
``TestNominal`` (Cramer's V, Pearson's C, Tschuprow's T and Theil's U, functional and
class over batches; Fleiss' kappa in both modes; NaN handling) run on the same seeded
numpy series through both packages, held against JAX rather than the reference.
Added: ``replace`` and ``drop`` on series with NaN, a 2 x 2 table (Yates' correction at
df = 1), the bias correction that cannot apply (NaN and the warning), one-hot (2D)
inputs, values outside ``[0, C)`` in the classes, the four ``*_matrix`` functions with
their confusion-matrix launches counted, the compute-group key, JAX state dicts carried
into the port and updated further, and the validation messages.

Tolerances: confusion matrices and ``confmat`` states exactly; the statistics within
1e-6.
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import torchmetrics_tpu.functional.nominal as jf  # noqa: E402
import torchmetrics_tpu.functional.nominal.association as jassoc  # noqa: E402
import torchmetrics_tpu.nominal as jn  # noqa: E402
import torchmetrics_tpu_torch.functional.nominal as tf  # noqa: E402
import torchmetrics_tpu_torch.functional.nominal.association as tassoc  # noqa: E402
import torchmetrics_tpu_torch.nominal as tn  # noqa: E402
from torchmetrics_tpu_torch.convert import load_jax_state  # noqa: E402
from torchmetrics_tpu_torch.ops import kernels  # noqa: E402

ATOL = 1e-6

rng = np.random.RandomState(42)
NOM_PREDS = rng.randint(0, 4, 100)
NOM_TARGET = (NOM_PREDS + rng.randint(0, 2, 100)) % 4

_r = np.random.RandomState(5)
WIDE_PREDS = _r.randint(0, 9, 600)
WIDE_TARGET = (WIDE_PREDS * 3 + _r.randint(0, 7, 600)) % 16
NAN_PREDS = np.where(_r.rand(600) < 0.07, np.nan, WIDE_PREDS).astype(np.float32)
NAN_TARGET = np.where(_r.rand(600) < 0.07, np.nan, WIDE_TARGET).astype(np.float32)
BINARY_PREDS = _r.randint(0, 2, 300)
BINARY_TARGET = np.where(_r.rand(300) < 0.7, BINARY_PREDS, 1 - BINARY_PREDS)

SERIES = {
    "seeded": (NOM_PREDS, NOM_TARGET),
    "wide": (WIDE_PREDS, WIDE_TARGET),
    "two_by_two": (BINARY_PREDS, BINARY_TARGET),
    "sparse_values": (np.array([-4, 7, 7, 100])[_r.randint(0, 4, 200)], np.array([3, 9, 27])[_r.randint(0, 3, 200)]),
}

FUNCTIONS = {
    "cramers_v": ("CramersV", True),
    "pearsons_contingency_coefficient": ("PearsonsContingencyCoefficient", False),
    "tschuprows_t": ("TschuprowsT", True),
    "theils_u": ("TheilsU", False),
}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _close(port, jax_value, atol: float = ATOL) -> None:
    got, want = _np(port).astype(np.float64), _np(jax_value).astype(np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _kwargs(name: str, bias_correction):
    return {} if bias_correction is None or not FUNCTIONS[name][1] else {"bias_correction": bias_correction}


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
@pytest.mark.parametrize("series", sorted(SERIES))
@pytest.mark.parametrize("bias_correction", [True, False])
def test_functionals_equal_jax(name, series, bias_correction):
    preds, target = SERIES[series]
    kw = _kwargs(name, bias_correction)
    port = getattr(tf, name)(torch.from_numpy(preds), torch.from_numpy(target), **kw)
    _close(port, getattr(jf, name)(jnp.asarray(preds), jnp.asarray(target), **kw))


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
@pytest.mark.parametrize("nan_strategy", ["replace", "drop"])
@pytest.mark.parametrize("nan_replace_value", [0.0, 3])
def test_nan_strategies_equal_jax(name, nan_strategy, nan_replace_value):
    kw = {"nan_strategy": nan_strategy, "nan_replace_value": nan_replace_value}
    port = getattr(tf, name)(torch.from_numpy(NAN_PREDS), torch.from_numpy(NAN_TARGET), **kw)
    _close(port, getattr(jf, name)(jnp.asarray(NAN_PREDS), jnp.asarray(NAN_TARGET), **kw))


@pytest.mark.parametrize("nan_strategy", ["replace", "drop"])
def test_nan_handling_equals_jax(nan_strategy):
    from torchmetrics_tpu.functional.nominal.utils import _handle_nan_in_data as jhandle
    from torchmetrics_tpu_torch.functional.nominal.utils import _handle_nan_in_data as thandle

    port = thandle(torch.from_numpy(NAN_PREDS), torch.from_numpy(NAN_TARGET), nan_strategy, 2.0)
    want = jhandle(jnp.asarray(NAN_PREDS), jnp.asarray(NAN_TARGET), nan_strategy, 2.0)
    for got, expected in zip(port, want):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(_np(got), _np(expected))


def test_the_reference_nan_case_equals_jax():
    p, t = np.array([0.0, 1.0, np.nan, 2.0], dtype=np.float32), np.array([0.0, 1.0, 1.0, 2.0], dtype=np.float32)
    for kw in ({"nan_strategy": "replace", "nan_replace_value": 0.0}, {"nan_strategy": "drop", "bias_correction": False}):
        _close(tf.cramers_v(torch.from_numpy(p), torch.from_numpy(t), **kw),
               jf.cramers_v(jnp.asarray(p), jnp.asarray(t), **kw))
    with pytest.warns(UserWarning, match="Unable to compute Cramer's V using bias correction"):
        value = tf.cramers_v(torch.from_numpy(p), torch.from_numpy(t), nan_strategy="drop")
    assert np.isnan(float(value))
    with pytest.warns(UserWarning, match="Unable to compute Tschuprow's T using bias correction"):
        assert np.isnan(float(tf.tschuprows_t(torch.from_numpy(p), torch.from_numpy(t), nan_strategy="drop")))


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_one_hot_series_equal_jax(name):
    preds = np.eye(9, dtype=np.float32)[WIDE_PREDS]
    port = getattr(tf, name)(torch.from_numpy(preds), torch.from_numpy(WIDE_TARGET))
    _close(port, getattr(jf, name)(jnp.asarray(preds), jnp.asarray(WIDE_TARGET)))


def test_confusion_matrices_equal_jax_exactly():
    from torchmetrics_tpu.functional.nominal.association import _nominal_confmat_update as jupdate
    from torchmetrics_tpu.functional.nominal.association import _prepare_nominal_confmat as jprepare

    for preds, target in SERIES.values():
        port = tassoc._prepare_nominal_confmat(torch.from_numpy(preds), torch.from_numpy(target), "replace", 0.0)
        want = jprepare(jnp.asarray(preds), jnp.asarray(target), "replace", 0.0)
        assert port.dtype == torch.int32
        np.testing.assert_array_equal(_np(port), _np(want))
    # a fixed class count: values outside [0, C) count nowhere, on both sides
    port = tassoc._nominal_confmat_update(torch.from_numpy(WIDE_PREDS), torch.from_numpy(WIDE_TARGET), 12)
    np.testing.assert_array_equal(_np(port), _np(jupdate(jnp.asarray(WIDE_PREDS), jnp.asarray(WIDE_TARGET), 12)))
    assert int(port.sum()) < WIDE_PREDS.size


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
@pytest.mark.parametrize("nan_strategy", ["replace", "drop"])
def test_classes_over_batches_equal_jax(name, nan_strategy):
    cls, has_bias = FUNCTIONS[name]
    kw = {"num_classes": 16, "nan_strategy": nan_strategy}
    # JAX's jitted update cannot filter rows (a traced array has no host value): "drop" runs eagerly there
    port, jax_metric = getattr(tn, cls)(device="cpu", **kw), getattr(jn, cls)(jit_update=nan_strategy != "drop", **kw)
    for i in range(0, 600, 150):
        port.update(torch.from_numpy(NAN_PREDS[i:i + 150]), torch.from_numpy(NAN_TARGET[i:i + 150]))
        jax_metric.update(jnp.asarray(NAN_PREDS[i:i + 150]), jnp.asarray(NAN_TARGET[i:i + 150]))
    assert port.confmat.dtype == torch.float32
    np.testing.assert_array_equal(_np(port.confmat), _np(jax_metric.confmat))
    _close(port.compute(), jax_metric.compute())
    assert port._compute_group_params() == jax_metric._compute_group_params()


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_the_reference_module_case_equals_jax(name):
    cls, _ = FUNCTIONS[name]
    port, jax_metric = getattr(tn, cls)(num_classes=4, device="cpu"), getattr(jn, cls)(num_classes=4)
    for i in range(0, 100, 50):
        port.update(torch.from_numpy(NOM_PREDS[i:i + 50]), torch.from_numpy(NOM_TARGET[i:i + 50]))
        jax_metric.update(jnp.asarray(NOM_PREDS[i:i + 50]), jnp.asarray(NOM_TARGET[i:i + 50]))
    _close(port.compute(), jax_metric.compute())


@pytest.mark.parametrize("mode", ["counts", "probs"])
def test_fleiss_kappa_equals_jax(mode):
    r = np.random.RandomState(9)
    ratings = r.randint(0, 10, (40, 5)) if mode == "counts" else r.rand(40, 4, 5).astype(np.float32)
    _close(tf.fleiss_kappa(torch.from_numpy(ratings), mode), jf.fleiss_kappa(jnp.asarray(ratings), mode))
    port, jax_metric = tn.FleissKappa(mode=mode, device="cpu"), jn.FleissKappa(mode=mode)
    for i in range(0, 40, 10):
        port.update(torch.from_numpy(ratings[i:i + 10]))
        jax_metric.update(jnp.asarray(ratings[i:i + 10]))
    np.testing.assert_array_equal(_np(torch.cat(port.counts)), np.concatenate([_np(c) for c in jax_metric.counts]))
    _close(port.compute(), jax_metric.compute())


def test_fleiss_kappa_validation_equals_jax():
    for ratings, mode in ((torch.rand(4, 3), "counts"), (torch.zeros((4, 3, 2), dtype=torch.int64), "probs"),
                          (torch.rand(4, 3), "probs")):
        with pytest.raises(ValueError, match=f"If argument ``mode`` is .{mode}."):
            tf.fleiss_kappa(ratings, mode)
    with pytest.raises(ValueError, match="Argument ``mode`` must be one of 'counts' or 'probs'"):
        tf.fleiss_kappa(torch.zeros((2, 2), dtype=torch.int64), "ratio")
    with pytest.raises(ValueError, match="Argument ``mode`` must be one of 'counts' or 'probs'"):
        tn.FleissKappa(mode="ratio", device="cpu")


MATRIX = np.stack([NAN_PREDS, NAN_TARGET, np.where(_r.rand(600) < 0.05, np.nan, _r.randint(0, 3, 600)),
                   _r.randint(0, 2, 600).astype(np.float32)], axis=1).astype(np.float32)
MATRICES = {
    "cramers_v_matrix": True,
    "pearsons_contingency_coefficient_matrix": True,
    "tschuprows_t_matrix": True,
    "theils_u_matrix": False,
}


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("nan_strategy", ["replace", "drop"])
def test_matrix_functions_equal_jax_with_one_launch_a_pair(name, nan_strategy, monkeypatch):
    calls = []
    real = kernels.confusion_matrix
    monkeypatch.setattr(kernels, "confusion_matrix", lambda *a: calls.append(a[3]) or real(*a))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        port = getattr(tf, name)(torch.from_numpy(MATRIX), nan_strategy=nan_strategy)
        want = getattr(jf, name)(jnp.asarray(MATRIX), nan_strategy=nan_strategy)
    assert port.dtype == torch.float32 and port.shape == (4, 4)
    _close(port, want)
    pairs = 6 if MATRICES[name] else 12
    assert len(calls) == pairs


def test_validation_messages_equal_jax():
    def message(fn):
        with pytest.raises(ValueError) as err:
            fn()
        return str(err.value)

    p, t = torch.from_numpy(NOM_PREDS), torch.from_numpy(NOM_TARGET)
    jp, jt = jnp.asarray(NOM_PREDS), jnp.asarray(NOM_TARGET)
    assert message(lambda: tf.cramers_v(p, t, nan_strategy="mean")) == message(
        lambda: jf.cramers_v(jp, jt, nan_strategy="mean"))
    assert message(lambda: tf.theils_u(p, t, nan_replace_value=None)) == message(
        lambda: jf.theils_u(jp, jt, nan_replace_value=None))
    assert message(lambda: tn.CramersV(num_classes=1, device="cpu")) == message(lambda: jn.CramersV(num_classes=1))
    assert message(lambda: tn.TheilsU(3, nan_strategy="x", device="cpu")) == message(
        lambda: jn.TheilsU(3, nan_strategy="x"))


@pytest.mark.parametrize("cls", ["CramersV", "TheilsU", "FleissKappa"])
def test_a_jax_state_loaded_into_the_port_goes_on_equal(cls):
    if cls == "FleissKappa":
        r = np.random.RandomState(2)
        batches = [(r.randint(0, 6, (20, 5)),) for _ in range(4)]
        port, jax_metric = tn.FleissKappa(device="cpu"), jn.FleissKappa()
    else:
        batches = [(NAN_PREDS[i:i + 150], NAN_TARGET[i:i + 150]) for i in range(0, 600, 150)]
        port, jax_metric = getattr(tn, cls)(16, device="cpu"), getattr(jn, cls)(16, nan_strategy="replace")
    for batch in batches[:2]:
        jax_metric.update(*(jnp.asarray(b) for b in batch))
    port = load_jax_state(port, jax_metric.state_dict(persistent_only=False))
    for batch in batches[2:]:
        jax_metric.update(*(jnp.asarray(b) for b in batch))
        port.update(*(torch.from_numpy(b) for b in batch))
    if cls != "FleissKappa":
        np.testing.assert_array_equal(_np(port.confmat), _np(jax_metric.confmat))
    _close(port.compute(), jax_metric.compute())


@pytest.mark.parametrize("cls", sorted(jn.__all__))
def test_classes_keep_jax_attributes(cls):
    for attr in ("is_differentiable", "higher_is_better", "full_state_update", "plot_lower_bound",
                 "plot_upper_bound"):
        assert getattr(getattr(tn, cls), attr) == getattr(getattr(jn, cls), attr), attr


def test_the_all_lists_equal_jax():
    import torchmetrics_tpu_torch as ttm
    import torchmetrics_tpu_torch.functional as tfunctional

    assert tn.__all__ == jn.__all__
    assert tf.__all__ == jf.__all__
    assert set(jn.__all__) <= set(ttm.__all__)
    assert set(jf.__all__) <= set(tfunctional.__all__) and "nominal" in tfunctional.__all__
    assert jassoc.__name__.replace("torchmetrics_tpu", "torchmetrics_tpu_torch") == tassoc.__name__
