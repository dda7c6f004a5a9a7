"""The pairwise distances of the port, held against the JAX package on the CPU.

The cases of ``tests/domains/test_clustering_nominal_segmentation_pairwise.py``'s
``TestPairwise`` (cosine, Euclidean, linear, Manhattan against two sets and one set
with itself, Minkowski, the zero diagonal, every reduction) run on the same seeded
numpy inputs through both packages, with and without ``y``, plus the gradients of the
Manhattan and Minkowski distances (``torch.cdist``) against JAX's, the validation
errors and the ``__all__`` list. ``utils.compute._matmul_full_float32`` writes no
process-wide setting: it reads the TF32 flag, multiplies in float64 where it is on, and
a flag another thread sets during a product survives it.

Cosine similarities agree within 1e-5 absolute; the others within 1e-5 relative to
the matrix's largest magnitude (an inner product near 0 has no relative precision:
float32 products summed in another order). Euclidean matrices are compared squared,
as the Gram expansion computes them: a distance of a row to itself comes out of
``|x|^2 + |x|^2 - 2 x.x``, whose float32 rounding its square root magnifies near 0.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import torchmetrics_tpu.functional.pairwise as jpw  # noqa: E402
import torchmetrics_tpu_torch.functional.pairwise as tpw  # noqa: E402
from torchmetrics_tpu.utils.exceptions import TorchMetricsUserError as JaxUserError  # noqa: E402
from torchmetrics_tpu_torch.utils.exceptions import TorchMetricsUserError  # noqa: E402

COSINE_ATOL = 1e-5
RTOL = 1e-5

_rng = np.random.RandomState(42)
X = _rng.rand(6, 4).astype(np.float32)
Y = _rng.rand(5, 4).astype(np.float32)
# embedding-like rows: signed, of a few widths
WIDE_X = _rng.randn(37, 64).astype(np.float32)
WIDE_Y = _rng.randn(23, 64).astype(np.float32)

FUNCTIONS = {
    "cosine": ("pairwise_cosine_similarity", {}),
    "euclidean": ("pairwise_euclidean_distance", {}),
    "linear": ("pairwise_linear_similarity", {}),
    "manhattan": ("pairwise_manhattan_distance", {}),
    "minkowski_3": ("pairwise_minkowski_distance", {"exponent": 3}),
    "minkowski_1.5": ("pairwise_minkowski_distance", {"exponent": 1.5}),
    "minkowski_2": ("pairwise_minkowski_distance", {}),
}


def _assert_close(port, jax_value, name: str) -> None:
    got = np.asarray(port.detach().cpu(), dtype=np.float64)
    want = np.asarray(jax_value, dtype=np.float64)
    assert got.shape == want.shape
    if got.size == 0:
        return
    if name == "euclidean" and got.ndim == 2:
        got, want = got**2, want**2
    atol = COSINE_ATOL if name == "cosine" else RTOL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _both(name: str, x, y=None, **kwargs):
    fn_name, fixed = FUNCTIONS[name]
    kw = {**fixed, **kwargs}
    port = getattr(tpw, fn_name)(torch.from_numpy(x), None if y is None else torch.from_numpy(y), **kw)
    jax_value = getattr(jpw, fn_name)(jnp.asarray(x), None if y is None else jnp.asarray(y), **kw)
    return port, jax_value


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
@pytest.mark.parametrize("data", ["small", "wide"])
def test_two_sets_equal_jax(name, data):
    x, y = (X, Y) if data == "small" else (WIDE_X, WIDE_Y)
    port, jax_value = _both(name, x, y)
    assert port.dtype == torch.float32
    _assert_close(port, jax_value, name)


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
@pytest.mark.parametrize("zero_diagonal", [None, True, False])
def test_one_set_with_itself_equals_jax(name, zero_diagonal):
    port, jax_value = _both(name, WIDE_X, zero_diagonal=zero_diagonal)
    _assert_close(port, jax_value, name)
    if zero_diagonal is not False:
        assert not port.diagonal().any()


@pytest.mark.parametrize("name", ["cosine", "euclidean", "manhattan", "minkowski_3"])
def test_zero_diagonal_of_two_sets_zeroes_min_n_m_entries(name):
    port, jax_value = _both(name, X, Y, zero_diagonal=True)
    _assert_close(port, jax_value, name)
    assert not port.diagonal().any() and port.diagonal().numel() == min(X.shape[0], Y.shape[0])


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
@pytest.mark.parametrize("reduction", ["mean", "sum", "none", None])
def test_reductions_equal_jax(name, reduction):
    port, jax_value = _both(name, X, Y, reduction=reduction)
    _assert_close(port, jax_value, name)


@pytest.mark.parametrize("name", ["manhattan", "minkowski_3", "minkowski_1.5"])
@pytest.mark.parametrize("data", ["small", "wide"])
def test_gradients_of_two_sets_equal_jax(name, data):
    import jax

    fn_name, kw = FUNCTIONS[name]
    x, y = (X, Y) if data == "small" else (WIDE_X, WIDE_Y)
    tx = torch.from_numpy(x).requires_grad_(True)
    getattr(tpw, fn_name)(tx, torch.from_numpy(y), **kw).sum().backward()
    want = jax.grad(lambda a: getattr(jpw, fn_name)(a, jnp.asarray(y), **kw).sum())(jnp.asarray(x))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), rtol=0, atol=RTOL * float(np.abs(want).max()))


@pytest.mark.parametrize("name", ["manhattan", "minkowski_3", "minkowski_1.5"])
def test_gradients_of_one_set_with_itself_are_finite(name):
    """The zeroed diagonal takes no gradient, and the zero distances under it give none."""
    fn_name, kw = FUNCTIONS[name]
    tx = torch.from_numpy(WIDE_X).requires_grad_(True)
    out = getattr(tpw, fn_name)(tx, **kw)
    out.sum().backward()
    assert not out.diagonal().any()
    assert bool(torch.isfinite(tx.grad).all()) and bool(tx.grad.any())


def test_empty_x_gives_an_empty_matrix():
    port = tpw.pairwise_manhattan_distance(torch.zeros((0, 4)), torch.from_numpy(Y))
    assert port.shape == (0, Y.shape[0])


@pytest.mark.parametrize("exponent", [0.5, 0, "2"])
def test_minkowski_exponent_below_one_raises_as_jax(exponent):
    with pytest.raises(JaxUserError, match="Argument ``p`` must be a float or int greater than 1") as jax_err:
        jpw.pairwise_minkowski_distance(jnp.asarray(X), jnp.asarray(Y), exponent=exponent)
    with pytest.raises(TorchMetricsUserError) as port_err:
        tpw.pairwise_minkowski_distance(torch.from_numpy(X), torch.from_numpy(Y), exponent=exponent)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("name", sorted(FUNCTIONS))
def test_bad_shapes_and_reduction_raise_as_jax(name):
    fn_name, _ = FUNCTIONS[name]
    with pytest.raises(ValueError, match="Expected argument `x` to be a 2D tensor"):
        getattr(tpw, fn_name)(torch.zeros(3))
    with pytest.raises(ValueError, match="Expected argument `y` to be a 2D tensor"):
        getattr(tpw, fn_name)(torch.from_numpy(X), torch.zeros((3, 5)))
    with pytest.raises(ValueError, match="Expected reduction to be one of") as port_err:
        getattr(tpw, fn_name)(torch.from_numpy(X), torch.from_numpy(Y), reduction="max")
    with pytest.raises(ValueError) as jax_err:
        getattr(jpw, fn_name)(jnp.asarray(X), jnp.asarray(Y), reduction="max")
    assert str(port_err.value) == str(jax_err.value)


def test_the_all_lists_equal_jax():
    import torchmetrics_tpu.functional as jf
    import torchmetrics_tpu_torch.functional as tf

    assert tpw.__all__ == jpw.__all__
    assert set(jpw.__all__) <= set(tf.__all__)
    assert "pairwise" in tf.__all__ and "pairwise" in jf.__all__


# ------------------------------------------------------- the full-float32 product

@pytest.fixture
def matmul_precision():
    """``torch.backends.cuda.matmul.fp32_precision`` restored after the test."""
    matmul = torch.backends.cuda.matmul
    before = matmul.fp32_precision
    yield matmul
    matmul.fp32_precision = before


@pytest.mark.parametrize("precision", ["ieee", "tf32"])
def test_the_full_float32_product_writes_no_process_wide_setting(matmul_precision, precision, monkeypatch):
    """Under IEEE float32 it is ``torch.matmul`` as it is; where a caller has turned TF32
    on it multiplies in float64 and rounds once; the flag is never switched, during the
    product either."""
    from torchmetrics_tpu_torch.utils import compute

    matmul_precision.fp32_precision = precision
    seen, original = [], torch.matmul

    def spy(a, b):
        seen.append((matmul_precision.fp32_precision, a.dtype))
        return original(a, b)

    monkeypatch.setattr(torch, "matmul", spy)
    a, b = torch.from_numpy(WIDE_X), torch.from_numpy(WIDE_Y.T.copy())
    got = compute._matmul_full_float32(a, b)
    want_dtype = torch.float32 if precision == "ieee" else torch.float64
    assert seen == [(precision, want_dtype)] and matmul_precision.fp32_precision == precision
    assert got.dtype == torch.float32
    if precision == "tf32":
        assert torch.equal(got, (a.double() @ b.double()).float())


def test_a_flag_another_thread_sets_during_a_product_survives_it(matmul_precision, monkeypatch):
    import threading

    from torchmetrics_tpu_torch.utils import compute

    matmul_precision.fp32_precision = "ieee"
    inside, flag_set = threading.Event(), threading.Event()
    original = torch.matmul

    def slow(a, b):
        inside.set()
        assert flag_set.wait(10)
        return original(a, b)

    monkeypatch.setattr(torch, "matmul", slow)
    worker = threading.Thread(target=compute._matmul_full_float32, args=(torch.ones(2, 3), torch.ones(3, 2)))
    worker.start()
    assert inside.wait(10)
    matmul_precision.fp32_precision = "tf32"  # another thread turns TF32 on mid-product
    flag_set.set()
    worker.join(10)
    assert not worker.is_alive() and matmul_precision.fp32_precision == "tf32"


def test_the_pairwise_products_under_tf32_stay_full_float32_on_the_cpu(matmul_precision):
    matmul_precision.fp32_precision = "tf32"
    x, y = torch.from_numpy(WIDE_X), torch.from_numpy(WIDE_Y)
    got = tpw.pairwise_linear_similarity(x, y)
    assert torch.equal(got, (x.double() @ y.double().T).float())
    _assert_close(tpw.pairwise_cosine_similarity(x, y),
                  jpw.pairwise_cosine_similarity(jnp.asarray(WIDE_X), jnp.asarray(WIDE_Y)), "cosine")
    assert matmul_precision.fp32_precision == "tf32"
