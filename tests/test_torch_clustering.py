"""The clustering metrics of the port, held against the JAX package on the CPU.

The cases of ``tests/domains/test_clustering_nominal_segmentation_pairwise.py``'s
clustering classes (the nine extrinsic scores, Calinski-Harabasz, Davies-Bouldin and
the Dunn index, functional and class over batches, float labels refused) run on the
same seeded numpy labels through both packages, held against JAX rather than sklearn.
Added: labellings with one cluster, identical or permuted ones, sparse and negative
label values, the contingency table and the pair confusion matrix themselves, the
``ValueError`` of a table of ``R * P >= 2^31`` cells, the expected mutual information
of a ~200 x 200 table against JAX's double loop, the intrinsic scores' gradients at a
zero distance (a point on its centroid, two clusters on one centroid), and JAX state
dicts carried into the port and updated further.

Tolerances: contingency tables and pair counts exactly; the extrinsic scores within
1e-6 (AMI 1e-5: its expected mutual information is summed in another order); the
intrinsic scores within 1e-5 relative (float32 products and sums in another order).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import torchmetrics_tpu.clustering as jc  # noqa: E402
import torchmetrics_tpu.functional.clustering as jf  # noqa: E402
import torchmetrics_tpu.functional.clustering.extrinsic as jext  # noqa: E402
import torchmetrics_tpu.functional.clustering.utils as jutils  # noqa: E402
import torchmetrics_tpu_torch.clustering as tc  # noqa: E402
import torchmetrics_tpu_torch.functional.clustering as tf  # noqa: E402
import torchmetrics_tpu_torch.functional.clustering.extrinsic as text  # noqa: E402
import torchmetrics_tpu_torch.functional.clustering.utils as tutils  # noqa: E402
from torchmetrics_tpu_torch.convert import load_jax_state  # noqa: E402
from torchmetrics_tpu_torch.ops import kernels  # noqa: E402

EXTRINSIC_ATOL = 1e-6
AMI_ATOL = 1e-5
INTRINSIC_RTOL = 1e-5

rng = np.random.RandomState(42)
PREDS_LABELS = rng.randint(0, 5, 100)
TARGET_LABELS = rng.randint(0, 4, 100)

EXTRINSIC = {
    "mutual_info_score": ("MutualInfoScore", {}),
    "normalized_mutual_info_score": ("NormalizedMutualInfoScore", {}),
    "adjusted_mutual_info_score": ("AdjustedMutualInfoScore", {}),
    "rand_score": ("RandScore", {}),
    "adjusted_rand_score": ("AdjustedRandScore", {}),
    "fowlkes_mallows_index": ("FowlkesMallowsIndex", {}),
    "homogeneity_score": ("HomogeneityScore", {}),
    "completeness_score": ("CompletenessScore", {}),
    "v_measure_score": ("VMeasureScore", {}),
}

_r = np.random.RandomState(7)
LABELINGS = {
    "seeded": (PREDS_LABELS, TARGET_LABELS),
    "wide": (_r.randint(0, 40, 2000), _r.randint(0, 30, 2000)),
    "identical": (TARGET_LABELS, TARGET_LABELS),
    "permuted": ((TARGET_LABELS + 1) % 4, TARGET_LABELS),
    "one_pred_cluster": (np.zeros(50, dtype=np.int64), _r.randint(0, 3, 50)),
    "one_target_cluster": (_r.randint(0, 3, 50), np.full(50, 7)),
    "sparse_negative": (_r.choice([-5, 0, 12, 900], 64), _r.choice([-1, 3, 1_000_000], 64)),
    "two_samples": (np.array([0, 1]), np.array([1, 1])),
}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _close(port, jax_value, atol: float = EXTRINSIC_ATOL, rtol: float = 0.0) -> None:
    got, want = _np(port).astype(np.float64), _np(jax_value).astype(np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _atol(name: str) -> float:
    return AMI_ATOL if "adjusted_mutual" in name else EXTRINSIC_ATOL


@pytest.mark.parametrize("name", sorted(EXTRINSIC))
@pytest.mark.parametrize("labeling", sorted(LABELINGS))
def test_extrinsic_functionals_equal_jax(name, labeling):
    preds, target = LABELINGS[labeling]
    port = getattr(tf, name)(torch.from_numpy(preds), torch.from_numpy(target))
    want = getattr(jf, name)(jnp.asarray(preds), jnp.asarray(target))
    assert port.dtype == torch.float32
    _close(port, want, _atol(name))


@pytest.mark.parametrize("average_method", ["min", "geometric", "arithmetic", "max"])
@pytest.mark.parametrize("name", ["normalized_mutual_info_score", "adjusted_mutual_info_score"])
def test_average_methods_equal_jax(name, average_method):
    preds, target = LABELINGS["wide"]
    port = getattr(tf, name)(torch.from_numpy(preds), torch.from_numpy(target), average_method)
    _close(port, getattr(jf, name)(jnp.asarray(preds), jnp.asarray(target), average_method), _atol(name))


@pytest.mark.parametrize("beta", [0.5, 1.0, 2.0])
def test_v_measure_beta_equals_jax(beta):
    preds, target = LABELINGS["wide"]
    port = tf.v_measure_score(torch.from_numpy(preds), torch.from_numpy(target), beta)
    _close(port, jf.v_measure_score(jnp.asarray(preds), jnp.asarray(target), beta))


@pytest.mark.parametrize("name", sorted(EXTRINSIC))
def test_extrinsic_classes_over_batches_equal_jax(name):
    cls, kwargs = EXTRINSIC[name]
    port, jax_metric = getattr(tc, cls)(device="cpu", **kwargs), getattr(jc, cls)(**kwargs)
    for i in range(0, 100, 25):
        port.update(torch.from_numpy(PREDS_LABELS[i:i + 25]), torch.from_numpy(TARGET_LABELS[i:i + 25]))
        jax_metric.update(jnp.asarray(PREDS_LABELS[i:i + 25]), jnp.asarray(TARGET_LABELS[i:i + 25]))
    _close(port.compute(), jax_metric.compute(), _atol(name))
    port.reset()
    assert port.update_count == 0 and port.preds == [] and port.target == []


@pytest.mark.parametrize("labeling", sorted(LABELINGS))
@pytest.mark.parametrize("eps", [None, 0.5])
def test_contingency_table_equals_jax_exactly(labeling, eps):
    preds, target = LABELINGS[labeling]
    port = tutils.calculate_contingency_matrix(torch.from_numpy(preds), torch.from_numpy(target), eps)
    want = jutils.calculate_contingency_matrix(jnp.asarray(preds), jnp.asarray(target), eps)
    assert port.dtype == torch.float64
    np.testing.assert_array_equal(_np(port), want)
    pairs = tutils.calculate_pair_cluster_confusion_matrix(contingency=port)
    np.testing.assert_array_equal(_np(pairs), jutils.calculate_pair_cluster_confusion_matrix(contingency=want))


def test_contingency_table_is_one_bincount_launch(monkeypatch):
    calls = []
    real = kernels.bincount
    monkeypatch.setattr(kernels, "bincount", lambda *a: calls.append(a[2]) or real(*a))
    preds, target = LABELINGS["wide"]
    tf.adjusted_mutual_info_score(torch.from_numpy(preds), torch.from_numpy(target))
    assert calls == [len(np.unique(preds)) * len(np.unique(target))]


def test_pair_confusion_matrix_from_labels_equals_jax():
    preds, target = LABELINGS["wide"]
    port = tutils.calculate_pair_cluster_confusion_matrix(torch.from_numpy(preds), torch.from_numpy(target))
    np.testing.assert_array_equal(
        _np(port), jutils.calculate_pair_cluster_confusion_matrix(jnp.asarray(preds), jnp.asarray(target))
    )
    for kwargs in ({}, {"preds": torch.zeros(2), "target": torch.zeros(2), "contingency": torch.zeros(1, 1)}):
        with pytest.raises(ValueError, match="Must provide either `preds` and `target` or `contingency`"):
            tutils.calculate_pair_cluster_confusion_matrix(**kwargs)


def test_a_table_of_2_pow_31_cells_raises_before_counting(monkeypatch):
    monkeypatch.setattr(kernels, "bincount", lambda *a: pytest.fail("the kernel must not be reached"))
    n = 46341  # 46341^2 >= 2^31
    labels = torch.arange(n)
    with pytest.raises(ValueError, match="more than the bincount kernel's 2\\^31 - 1 bins"):
        tutils.calculate_contingency_matrix(labels, labels.flip(0))
    with pytest.raises(ValueError, match="2\\^31"):
        tf.rand_score(labels, labels)


@pytest.mark.parametrize("labeling", ["seeded", "wide", "identical", "one_target_cluster"])
def test_entropy_equals_jax(labeling):
    for labels in LABELINGS[labeling]:
        _close(tutils.calculate_entropy(torch.from_numpy(labels)), jutils.calculate_entropy(jnp.asarray(labels)))
    assert float(tutils.calculate_entropy(torch.zeros(0, dtype=torch.int64))) == 1.0
    assert float(tutils.calculate_entropy(torch.full((5,), 3))) == 0.0


@pytest.mark.parametrize("p", ["min", "geometric", "arithmetic", "max", 3])
def test_generalized_mean_equals_jax(p):
    x = np.array([0.5, 2.0, 1.25], dtype=np.float32)
    _close(tutils.calculate_generalized_mean(torch.from_numpy(x), p), jutils.calculate_generalized_mean(x, p))
    with pytest.raises(ValueError, match="'method' must be"):
        tutils.calculate_generalized_mean(torch.from_numpy(x), "median")


def test_expected_mutual_info_of_a_200_by_200_table_equals_jax_loop():
    r = np.random.RandomState(3)
    preds, target = r.randint(0, 200, 3000), r.randint(0, 200, 3000)
    table = tutils.calculate_contingency_matrix(torch.from_numpy(preds), torch.from_numpy(target))
    assert table.shape == (200, 200)
    port = text.expected_mutual_info_score(table, preds.size)
    want = jext.expected_mutual_info_score(_np(table), preds.size)
    _close(port, want, AMI_ATOL)
    assert abs(float(port) - float(want)) <= 2 * float(np.spacing(np.float32(want)))


@pytest.mark.parametrize("block_terms", [1, 97, 5000])
def test_expected_mutual_info_in_small_blocks_equals_one_pass(block_terms, monkeypatch):
    preds, target = LABELINGS["wide"]
    table = tutils.calculate_contingency_matrix(torch.from_numpy(preds), torch.from_numpy(target))
    whole = text.expected_mutual_info_score(table, preds.size)
    monkeypatch.setattr(text, "EMI_BLOCK_TERMS", block_terms)
    _close(text.expected_mutual_info_score(table, preds.size), whole, 1e-7)
    _close(whole, jext.expected_mutual_info_score(_np(table), preds.size), AMI_ATOL)


def test_float_labels_raise_as_jax():
    with pytest.raises(ValueError, match="Expected real, discrete values"):
        tf.mutual_info_score(torch.tensor([0.5, 1.0]), torch.tensor([1, 0]))
    with pytest.raises(ValueError, match="Expected real, discrete values"):
        tc.RandScore(device="cpu").update(torch.tensor([1, 0]), torch.tensor([0.5, 1.0]))
    with pytest.raises(ValueError, match="Expected arguments to be 1-d tensors"):
        tf.rand_score(torch.zeros((2, 2), dtype=torch.int64), torch.zeros((2, 2), dtype=torch.int64))
    with pytest.raises(ValueError, match="Expected argument `average_method`"):
        tc.NormalizedMutualInfoScore("median", device="cpu")
    with pytest.raises(ValueError, match="Argument `beta` should be a positive float"):
        tc.VMeasureScore(beta=2, device="cpu")


# ------------------------------------------------------------------ intrinsic

_d = np.random.RandomState(11)
CENTRES = _d.randn(6, 8).astype(np.float32) * 4
DATA_LABELS = _d.randint(0, 6, 240)
DATA = (CENTRES[DATA_LABELS] + _d.randn(240, 8).astype(np.float32)).astype(np.float32)
SPARSE_LABELS = np.array([-3, 10, 10, 42])[_d.randint(0, 4, 240)]

INTRINSIC = {
    "calinski_harabasz_score": ("CalinskiHarabaszScore", {}),
    "davies_bouldin_score": ("DaviesBouldinScore", {}),
    "dunn_index": ("DunnIndex", {}),
    "dunn_index_p1": ("DunnIndex", {"p": 1}),
    "dunn_index_p3.5": ("DunnIndex", {"p": 3.5}),
}


def _intrinsic_call(module, name, data, labels):
    fn = getattr(module, name.split("_p")[0] if name.startswith("dunn") else name)
    p = {"dunn_index_p1": 1, "dunn_index_p3.5": 3.5}.get(name)
    return fn(data, labels) if p is None else fn(data, labels, p)


@pytest.mark.parametrize("name", sorted(INTRINSIC))
@pytest.mark.parametrize("labels", ["seeded", "sparse"])
def test_intrinsic_functionals_equal_jax(name, labels):
    lab = DATA_LABELS if labels == "seeded" else SPARSE_LABELS
    port = _intrinsic_call(tf, name, torch.from_numpy(DATA), torch.from_numpy(lab))
    want = _intrinsic_call(jf, name, jnp.asarray(DATA), jnp.asarray(lab))
    assert port.dtype == torch.float32
    _close(port, want, 0.0, INTRINSIC_RTOL)


@pytest.mark.parametrize("name", sorted(INTRINSIC))
def test_intrinsic_classes_over_batches_equal_jax(name):
    cls, kwargs = INTRINSIC[name]
    port, jax_metric = getattr(tc, cls)(device="cpu", **kwargs), getattr(jc, cls)(**kwargs)
    for i in range(0, 240, 80):
        port.update(torch.from_numpy(DATA[i:i + 80]), torch.from_numpy(DATA_LABELS[i:i + 80]))
        jax_metric.update(jnp.asarray(DATA[i:i + 80]), jnp.asarray(DATA_LABELS[i:i + 80]))
    _close(port.compute(), jax_metric.compute(), 0.0, INTRINSIC_RTOL)


@pytest.mark.parametrize("name", ["davies_bouldin_score", "dunn_index", "dunn_index_p3.5"])
def test_intrinsic_gradients_equal_jax_and_stay_finite_at_a_zero_distance(name):
    """With gradients tracked the norms take JAX's double-where guard: the same value,
    JAX's gradient, and a finite one where a point sits on its centroid."""
    import jax

    data = DATA[:60].copy()
    labels = DATA_LABELS[:60].copy()
    labels[1] = labels[0] = 99  # a cluster of two equal points: zero distances to its centroid
    data[1] = data[0]
    x = torch.from_numpy(data).requires_grad_(True)
    value = _intrinsic_call(tf, name, x, torch.from_numpy(labels))
    value.backward()
    want_value, want_grad = jax.value_and_grad(lambda d: _intrinsic_call(jf, name, d, jnp.asarray(labels)))(
        jnp.asarray(data))
    _close(value.detach(), want_value, 0.0, INTRINSIC_RTOL)
    with torch.no_grad():
        _close(_intrinsic_call(tf, name, torch.from_numpy(data), torch.from_numpy(labels)), want_value, 0.0,
               INTRINSIC_RTOL)
    assert bool(torch.isfinite(x.grad).all())
    np.testing.assert_allclose(_np(x.grad), _np(want_grad), rtol=0, atol=1e-5 * float(np.abs(want_grad).max()))


def test_dunn_index_of_the_reference_example():
    data = torch.tensor([[0.0, 0.0], [0.5, 0.0], [1.0, 0.0], [0.5, 1.0]])
    assert float(tf.dunn_index(data, torch.tensor([0, 0, 0, 1]))) == 2.0
    metric = tc.DunnIndex(p=2, device="cpu")
    metric.update(data[:2], torch.tensor([0, 0]))
    metric.update(data[2:], torch.tensor([0, 1]))
    assert float(metric.compute()) == 2.0


def test_degenerate_intrinsic_cases_equal_jax():
    same = np.repeat(DATA[:3], 4, axis=0)  # every cluster a single point: no spread
    labels = np.repeat(np.arange(3), 4)
    for name in ("calinski_harabasz_score", "davies_bouldin_score"):
        _close(getattr(tf, name)(torch.from_numpy(same), torch.from_numpy(labels)),
               getattr(jf, name)(jnp.asarray(same), jnp.asarray(labels)), 0.0, INTRINSIC_RTOL)
    with pytest.raises(ValueError, match="Number of detected clusters must be greater than one"):
        tf.calinski_harabasz_score(torch.from_numpy(DATA), torch.zeros(240, dtype=torch.int64))
    with pytest.raises(ValueError, match="Expected 2D data"):
        tf.davies_bouldin_score(torch.zeros(4), torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="Expected floating point data"):
        tf.davies_bouldin_score(torch.zeros((4, 2), dtype=torch.int64), torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="Expected 1D labels"):
        tf.calinski_harabasz_score(torch.zeros((4, 2)), torch.zeros((4, 1), dtype=torch.int64))


def test_cluster_stats_count_through_the_bincount_kernel(monkeypatch):
    calls = []
    real = kernels.bincount
    monkeypatch.setattr(kernels, "bincount", lambda *a: calls.append(a[2]) or real(*a))
    tf.calinski_harabasz_score(torch.from_numpy(DATA), torch.from_numpy(DATA_LABELS))
    assert calls == [6]


# ------------------------------------------------------------------ states and exports


@pytest.mark.parametrize("cls", ["AdjustedMutualInfoScore", "RandScore", "VMeasureScore", "DaviesBouldinScore",
                                 "DunnIndex"])
def test_a_jax_state_loaded_into_the_port_goes_on_equal(cls):
    intrinsic = cls in ("DaviesBouldinScore", "DunnIndex")
    first, second = (DATA, DATA_LABELS) if intrinsic else (PREDS_LABELS, TARGET_LABELS)
    jax_metric = getattr(jc, cls)()
    for i in range(0, 50, 25):
        jax_metric.update(jnp.asarray(first[i:i + 25]), jnp.asarray(second[i:i + 25]))
    port = load_jax_state(getattr(tc, cls)(device="cpu"), jax_metric.state_dict(persistent_only=False))
    keys = ("data", "labels") if intrinsic else ("preds", "target")
    for key in keys:
        assert len(getattr(port, key)) == 2
        np.testing.assert_array_equal(_np(torch.cat(getattr(port, key))), np.concatenate(
            [_np(v) for v in getattr(jax_metric, key)]))
    for i in range(50, 100, 25):
        jax_metric.update(jnp.asarray(first[i:i + 25]), jnp.asarray(second[i:i + 25]))
        port.update(torch.from_numpy(first[i:i + 25]), torch.from_numpy(second[i:i + 25]))
    if intrinsic:
        _close(port.compute(), jax_metric.compute(), 0.0, INTRINSIC_RTOL)
    else:
        _close(port.compute(), jax_metric.compute(), AMI_ATOL)


@pytest.mark.parametrize("cls", sorted(jc.__all__))
def test_classes_keep_jax_attributes(cls):
    port, jax_cls = getattr(tc, cls), getattr(jc, cls)
    for attr in ("is_differentiable", "higher_is_better", "full_state_update", "plot_lower_bound",
                 "plot_upper_bound"):
        assert getattr(port, attr) == getattr(jax_cls, attr), attr


def test_the_all_lists_equal_jax():
    import torchmetrics_tpu as jtm
    import torchmetrics_tpu.functional as jfunctional
    import torchmetrics_tpu_torch as ttm
    import torchmetrics_tpu_torch.functional as tfunctional

    assert tc.__all__ == jc.__all__
    assert tf.__all__ == jf.__all__
    assert set(jc.__all__) <= set(ttm.__all__) and set(jc.__all__) <= set(jtm.__all__)
    assert set(jf.__all__) <= set(tfunctional.__all__) and set(jf.__all__) <= set(jfunctional.__all__)
    assert "clustering" in tfunctional.__all__


@pytest.mark.parametrize("name", ["davies_bouldin_score", "dunn_index", "dunn_index_p3.5"])
def test_intrinsic_gradients_equal_jax_at_two_clusters_on_one_centroid(name):
    """Two clusters of the same two points: a zero distance between their centroids,
    whose gradient ``torch.cdist`` gives as 0, as JAX's guarded norms do."""
    import jax

    data = DATA[:60].copy()
    labels = DATA_LABELS[:60].copy()
    labels[:2], labels[2:4] = 97, 98
    data[2:4] = data[:2]
    x = torch.from_numpy(data).requires_grad_(True)
    value = _intrinsic_call(tf, name, x, torch.from_numpy(labels))
    value.backward()
    want_value, want_grad = jax.value_and_grad(lambda d: _intrinsic_call(jf, name, d, jnp.asarray(labels)))(
        jnp.asarray(data))
    _close(value.detach(), want_value, 0.0, INTRINSIC_RTOL)
    assert bool(torch.isfinite(x.grad).all())
    np.testing.assert_allclose(_np(x.grad), _np(want_grad), rtol=0, atol=1e-5 * float(np.abs(want_grad).max()))
