"""The image-restoration slice of the port against the JAX package, on the CPU.

The same seeded numpy images go through the JAX function (its conv path, or the
Pallas moments kernel in interpret mode) and through its port counterpart, whose
2D SSIM moments run the plain version of the SSIM moments kernel here. Tolerances:

- ``ATOL`` = 1e-5 absolute for scores in [0, 1] and for the moments of inputs in
  [0, 1]: the two packages sum the window in float32, in other orders (a convolution
  against a separable shift-and-add).
- ``SUM_RTOL`` = 1e-6 relative for values that sum over pixels (PSNR in dB from a
  squared-error sum, total variation): float32 sums of thousands of terms.
- ``MAP_RTOL`` = 1e-5 relative on top of ``ATOL`` for the full SSIM maps of 3D
  volumes: per-voxel ratios, not averaged, of moments summed over 7^3 taps.
- Gradients within 1e-5 absolute.
- Validation errors: the same exception type and the same message text.
"""

from __future__ import annotations

import functools
import os
import re

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torchmetrics_tpu.functional.image as jf  # noqa: E402
import torchmetrics_tpu.image as jc  # noqa: E402
import torchmetrics_tpu_torch.functional.image as tf  # noqa: E402
import torchmetrics_tpu_torch.image as tc  # noqa: E402
from torchmetrics_tpu.ops.pallas_kernels import ssim_moments_pallas  # noqa: E402
from torchmetrics_tpu_torch.convert import load_jax_state  # noqa: E402
from torchmetrics_tpu_torch.functional.image import utils as tu  # noqa: E402
from torchmetrics_tpu_torch.ops import kernels  # noqa: E402

ATOL = 1e-5
SUM_RTOL = 1e-6
MAP_RTOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(seed: int, shape=(2, 3, 32, 32), noise: float = 0.1):
    rng = np.random.RandomState(seed)
    preds = rng.rand(*shape).astype(np.float32)
    target = np.clip(preds + noise * rng.randn(*shape), 0, 1).astype(np.float32)
    return preds, target


def _close(want, got, atol: float = ATOL, rtol: float = 0.0) -> None:
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(want) == len(got)
        for w, g in zip(want, got):
            _close(w, g, atol, rtol)
        return
    got = got.detach() if isinstance(got, torch.Tensor) else torch.as_tensor(got)
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=rtol)


# ---------------------------------------------------------------- the moments kernel


@pytest.mark.parametrize("shape, kh, kw", [((3, 20, 22), 5, 7), ((1, 16, 16), 11, 11), ((4, 13, 9), 3, 3)])
def test_moments_plain_matches_the_pallas_kernel(shape, kh, kw):
    rng = np.random.RandomState(sum(shape) + kh + kw)
    p, t = rng.rand(*shape).astype(np.float32), rng.rand(*shape).astype(np.float32)
    wh, ww = rng.rand(kh).astype(np.float32), rng.rand(kw).astype(np.float32)
    want = ssim_moments_pallas(*(jnp.asarray(a) for a in (p, t, wh, ww)), interpret=True)
    got = kernels.ssim_moments_plain(*(torch.from_numpy(a) for a in (p, t, wh, ww)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (shape[0], 5, shape[1] - kh + 1, shape[2] - kw + 1)
    _close(want, got)
    # the wrapper on CPU tensors is the plain version, with no launch counted
    kernels.reset_launch_counts()
    _close(want, kernels.ssim_moments(*(torch.from_numpy(a) for a in (p, t, wh, ww))))
    assert kernels.LAUNCHES["ssim_moments"] == 0


@pytest.mark.parametrize("where", ["preds", "target"])
def test_a_nan_pixel_makes_every_moment_whose_window_reads_it_nan(where):
    rng = np.random.RandomState(4)
    p, t = rng.rand(2, 17, 19).astype(np.float32), rng.rand(2, 17, 19).astype(np.float32)
    (p if where == "preds" else t)[1, 8, 5] = np.nan
    wh, ww = tu._gaussian(5, 1.0)[0].numpy(), np.full(3, 1 / 3, np.float32)
    want = np.asarray(ssim_moments_pallas(*(jnp.asarray(a) for a in (p, t, wh, ww)), interpret=True))
    got = kernels.ssim_moments_plain(*(torch.from_numpy(a) for a in (p, t, wh, ww))).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    window = np.zeros((13, 17), bool)
    window[8 - 4:8 + 1, max(0, 5 - 2):5 + 1] = True  # outputs whose 5x3 window covers (8, 5)
    touched = (0, 2, 4) if where == "preds" else (1, 3, 4)
    for m in range(5):
        np.testing.assert_array_equal(np.isnan(got[1, m]), window if m in touched else np.zeros_like(window))
    assert not np.isnan(got[0]).any()
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want), atol=ATOL)


def test_the_moments_backward_is_the_adjoint_of_the_plain_version():
    rng = np.random.RandomState(7)
    p0, t0 = rng.rand(3, 20, 22).astype(np.float32), rng.rand(3, 20, 22).astype(np.float32)
    wh, ww = torch.from_numpy(rng.rand(5).astype(np.float32)), torch.from_numpy(rng.rand(7).astype(np.float32))
    cotangent = torch.from_numpy(rng.randn(3, 5, 16, 16).astype(np.float32))
    grads = []
    for fn in (kernels.ssim_moments, kernels.ssim_moments_plain):
        p, t = torch.from_numpy(p0).requires_grad_(), torch.from_numpy(t0).requires_grad_()
        (fn(p, t, wh, ww) * cotangent).sum().backward()
        grads.append((p.grad, t.grad))
    (dp, dt), (dp_plain, dt_plain) = grads
    torch.testing.assert_close(dp, dp_plain, atol=ATOL, rtol=0)
    torch.testing.assert_close(dt, dt_plain, atol=ATOL, rtol=0)
    # only what asks for a gradient gets one
    p = torch.from_numpy(p0).requires_grad_()
    kernels.ssim_moments(p, torch.from_numpy(t0), wh, ww).sum().backward()
    assert p.grad is not None


def test_the_moments_refuse_a_window_larger_than_the_planes():
    p = torch.zeros(1, 4, 9)
    with pytest.raises(ValueError, match="larger than the padded planes"):
        kernels.ssim_moments(p, p, torch.ones(5), torch.ones(3))
    with pytest.raises(ValueError, match="one shape"):
        kernels.ssim_moments_plain(p, p[:, :3], torch.ones(3), torch.ones(3))


# ------------------------------------------------------------------ helpers vs JAX


@pytest.mark.parametrize("n, lo, hi", [(5, 2, 2), (4, 3, 3), (3, 5, 4), (1, 2, 2), (6, 0, 3)])
@pytest.mark.parametrize("mode", ["reflect", "symmetric"])
def test_padding_follows_jnp_pad(n, lo, hi, mode):
    x = np.arange(2 * n * (n + 1), dtype=np.float32).reshape(1, 2, n, n + 1)
    want = jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (lo, hi), (hi, lo)), mode=mode)
    _close(want, tu._pad(torch.from_numpy(x), ((lo, hi), (hi, lo)), mode), atol=0)


@pytest.mark.parametrize("window", [3, 4, 7, 8])
def test_uniform_filter_odd_and_even_windows(window):
    from torchmetrics_tpu.functional.image.utils import _uniform_filter

    x, _ = _pair(window, (2, 3, 19, 23))
    _close(_uniform_filter(jnp.asarray(x), window), tu._uniform_filter(torch.from_numpy(x), window))


@pytest.mark.parametrize("size, sigma", [(11, 1.5), (23, 3.0), (4, 1.0), (71, 10.0)])
def test_gaussian_window_matches_and_is_cached(size, sigma):
    from torchmetrics_tpu.functional.image.utils import _gaussian

    got = tu._gaussian(size, sigma)
    _close(_gaussian(size, sigma), got, atol=1e-7)
    assert tu._gaussian(size, sigma) is got  # built once per (size, sigma, device)


def test_convolutions_run_in_full_float32_and_restore_the_flag():
    """The convolution helpers leave cuDNN's process-wide TF32 flag as it was, during the
    call too: on the card they run on PyTorch's depthwise kernels, which have no TF32
    path (card test ``test_image_convolutions_reach_no_cudnn_kernel``)."""
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32
    seen = []
    original = torch.nn.functional.conv2d

    def spy(*args, **kwargs):
        seen.append(cudnn.allow_tf32)
        return original(*args, **kwargs)

    torch.nn.functional.conv2d = spy
    try:
        tu._conv2d(torch.ones(1, 2, 5, 5), torch.ones(2, 1, 3, 3), groups=2)
        tu._conv2d(torch.ones(5, 1, 5, 5), torch.ones(1, 1, 3, 3), groups=1)
    finally:
        torch.nn.functional.conv2d = original
    assert seen == [before, before] and cudnn.allow_tf32 == before


@pytest.mark.parametrize("planes", [1, 5])
@pytest.mark.parametrize("dims", [2, 3])
def test_a_single_channel_convolution_folded_into_depthwise_equals_the_plain_one(planes, dims):
    conv = torch.nn.functional.conv2d if dims == 2 else torch.nn.functional.conv3d
    g = torch.Generator().manual_seed(planes * 10 + dims)
    x = torch.rand(planes, 1, *([9] * dims), generator=g)
    kernel = torch.rand(1, 1, *([3] * dims), generator=g)
    got = tu._depthwise_single_channel(conv, x, kernel)
    want = conv(x, kernel)
    assert got.shape == want.shape
    # the same window sums in another order: float32 rounding of sums up to 27
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------------- SSIM

SSIM_CASES = {
    "default": {},
    "data_range_1": {"data_range": 1.0},
    "data_range_tuple": {"data_range": (0.1, 0.9)},
    "uniform": {"gaussian_kernel": False, "kernel_size": 7},
    "uniform_unequal": {"gaussian_kernel": False, "kernel_size": (5, 9), "sigma": (0.8, 1.3)},
    "sigma_unequal": {"sigma": (1.5, 2.5)},
    "sum": {"reduction": "sum", "k1": 0.02, "k2": 0.05},
    "none": {"reduction": "none", "data_range": 1.0},
    "full_image": {"return_full_image": True},
    "contrast": {"return_contrast_sensitivity": True, "sigma": (1.0, 2.0)},
}


@pytest.mark.parametrize("case", sorted(SSIM_CASES))
def test_ssim_functional(case):
    kw = SSIM_CASES[case]
    p, t = _pair(1, (2, 3, 40, 48))
    want = jf.structural_similarity_index_measure(jnp.asarray(p), jnp.asarray(t), **kw)
    got = tf.structural_similarity_index_measure(torch.from_numpy(p), torch.from_numpy(t), **kw)
    _close(want, got)


@pytest.mark.parametrize(
    "kw",
    [{"sigma": (1.5, 1.0, 0.7), "data_range": 1.0},
     {"gaussian_kernel": False, "kernel_size": (3, 5, 7), "sigma": (0.5, 1.0, 1.5)},
     {"return_full_image": True, "sigma": 0.8}],
    ids=["gaussian_unequal", "uniform_unequal", "full_image"],
)
def test_ssim_3d_volumes(kw):
    p, t = _pair(2, (2, 2, 20, 22, 24))
    want = jf.structural_similarity_index_measure(jnp.asarray(p), jnp.asarray(t), **kw)
    got = tf.structural_similarity_index_measure(torch.from_numpy(p), torch.from_numpy(t), **kw)
    if kw.get("return_full_image"):
        _close(want[0], got[0])
        _close(want[1], got[1], rtol=MAP_RTOL)
    else:
        _close(want, got)


@pytest.mark.parametrize(
    "shape, kw",
    [((2, 3, 64, 64), {"betas": (0.3, 0.4, 0.3), "data_range": 1.0}),
     ((2, 3, 64, 64), {"betas": (0.3, 0.4, 0.3), "normalize": "simple", "reduction": "none"}),
     ((2, 3, 64, 64), {"betas": (0.5, 0.5), "normalize": None, "gaussian_kernel": False, "kernel_size": 5}),
     ((1, 3, 176, 176), {"data_range": 1.0}),
     ((1, 1, 16, 24, 24), {"betas": (0.5, 0.5), "sigma": 0.5, "kernel_size": 3, "data_range": 1.0})],
    ids=["three_scales", "simple_none", "uniform_two_scales", "default_betas", "volumes"],
)
def test_ms_ssim_functional(shape, kw):
    p, t = _pair(3, shape, noise=0.05)
    want = jf.multiscale_structural_similarity_index_measure(jnp.asarray(p), jnp.asarray(t), **kw)
    got = tf.multiscale_structural_similarity_index_measure(torch.from_numpy(p), torch.from_numpy(t), **kw)
    _close(want, got)


def _states_close(jm, tm, rtol: float = 0.0) -> None:
    want, got = jm.state_dict(persistent_only=False), tm.state_dict(persistent_only=False)
    assert set(want) == set(got)
    for key, value in want.items():
        if isinstance(value, list):
            assert len(value) == len(got[key])
            for w, g in zip(value, got[key]):
                _close(w, g, rtol=rtol)
            continue
        value = np.asarray(value)
        assert str(got[key].dtype).replace("torch.", "") == str(value.dtype), key
        _close(value, got[key], rtol=rtol)


def _drive(jax_metric, port_metric, batches, rtol: float = 0.0, preds_only: bool = False) -> None:
    for batch in batches:
        args_j = [jnp.asarray(a) for a in batch][: 1 if preds_only else 2]
        args_t = [torch.from_numpy(a) for a in batch][: 1 if preds_only else 2]
        _close(jax_metric(*args_j), port_metric(*args_t), rtol=rtol)  # forward: the batch value
    _states_close(jax_metric, port_metric, rtol=rtol)
    _close(jax_metric.compute(), port_metric.compute(), rtol=rtol)


@pytest.mark.parametrize(
    "kw",
    [{}, {"reduction": "sum", "data_range": 1.0}, {"reduction": "none", "sigma": (1.0, 2.0)},
     {"return_full_image": True, "data_range": (0.0, 1.0)}, {"return_contrast_sensitivity": True},
     {"gaussian_kernel": False, "kernel_size": (5, 7)}],
    ids=["mean", "sum", "none", "full_image", "contrast", "uniform"],
)
def test_ssim_stateful(kw):
    batches = [_pair(10 + i, (2, 3, 32, 36)) for i in range(3)]
    _drive(jc.StructuralSimilarityIndexMeasure(**kw), tc.StructuralSimilarityIndexMeasure(device="cpu", **kw), batches)


@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
def test_ms_ssim_stateful(reduction):
    kw = {"betas": (0.3, 0.4, 0.3), "data_range": 1.0, "reduction": reduction}
    batches = [_pair(20 + i, (2, 3, 64, 64), noise=0.05) for i in range(2)]
    _drive(jc.MultiScaleStructuralSimilarityIndexMeasure(**kw),
           tc.MultiScaleStructuralSimilarityIndexMeasure(device="cpu", **kw), batches)


def test_ms_ssim_launches_the_moments_once_per_scale(monkeypatch):
    calls = []
    original = kernels.ssim_moments
    monkeypatch.setattr(kernels, "ssim_moments", lambda *a: calls.append(a[0].shape) or original(*a))
    p, t = _pair(5, (1, 3, 176, 176))
    tf.multiscale_structural_similarity_index_measure(torch.from_numpy(p), torch.from_numpy(t), data_range=1.0)
    assert calls == [(3, 186, 186), (3, 98, 98), (3, 54, 54), (3, 32, 32), (3, 21, 21)]


# -------------------------------------------------------------------- gradients


@pytest.mark.parametrize("kw", [{"data_range": 1.0}, {"data_range": 1.0, "gaussian_kernel": False,
                                                       "kernel_size": (5, 7)}, {}], ids=["gaussian", "uniform", "range_from_data"])
def test_ssim_gradient_matches_jax_grad(kw):
    p, t = _pair(6, (2, 3, 32, 32))
    want = jax.grad(lambda x: jf.structural_similarity_index_measure(x, jnp.asarray(t), reduction="sum", **kw))(
        jnp.asarray(p)
    )
    x = torch.from_numpy(p).requires_grad_()
    tf.structural_similarity_index_measure(x, torch.from_numpy(t), reduction="sum", **kw).backward()
    _close(want, x.grad)


def test_ms_ssim_gradient_matches_jax_grad():
    p, t = _pair(8, (1, 2, 64, 64), noise=0.05)
    kw = {"betas": (0.3, 0.4, 0.3), "data_range": 1.0}
    want = jax.grad(lambda x: jf.multiscale_structural_similarity_index_measure(x, jnp.asarray(t), **kw))(
        jnp.asarray(p)
    )
    x = torch.from_numpy(p).requires_grad_()
    tf.multiscale_structural_similarity_index_measure(x, torch.from_numpy(t), **kw).backward()
    _close(want, x.grad)


# --------------------------------------------------------------- PSNR and PSNR-B


@pytest.mark.parametrize(
    "kw",
    [{}, {"data_range": 1.0}, {"data_range": (0.2, 0.8)}, {"data_range": 1.0, "base": 2.0},
     {"data_range": 1.0, "dim": (1, 2, 3), "reduction": "none"}, {"data_range": 1.0, "dim": 1, "reduction": "sum"},
     {"data_range": 1.0, "dim": (2, 3)}],
    ids=["range_from_data", "range", "tuple", "base2", "dim_none", "dim_int_sum", "dim_mean"],
)
def test_psnr(kw):
    p, t = _pair(30, (2, 3, 16, 20))
    want = jf.peak_signal_noise_ratio(jnp.asarray(p), jnp.asarray(t), **kw)
    _close(want, tf.peak_signal_noise_ratio(torch.from_numpy(p), torch.from_numpy(t), **kw), rtol=SUM_RTOL)
    batches = [_pair(31 + i, (2, 3, 16, 20)) for i in range(3)]
    _drive(jc.PeakSignalNoiseRatio(**kw), tc.PeakSignalNoiseRatio(device="cpu", **kw), batches, rtol=SUM_RTOL)


def test_psnr_keeps_an_int32_total_and_float32_states():
    metric = tc.PeakSignalNoiseRatio(device="cpu")
    metric.update(np.zeros((2, 4), np.float64), np.ones((2, 4), np.float64))
    assert metric.total.dtype == torch.int32 and metric.sum_squared_error.dtype == torch.float32


@pytest.mark.parametrize("block_size", [8, 4, 5])
def test_psnrb(block_size):
    p, t = _pair(40 + block_size, (1, 1, 32, 32))
    want = jf.peak_signal_noise_ratio_with_blocked_effect(jnp.asarray(p), jnp.asarray(t), block_size=block_size)
    got = tf.peak_signal_noise_ratio_with_blocked_effect(torch.from_numpy(p), torch.from_numpy(t), block_size=block_size)
    _close(want, got, rtol=SUM_RTOL)
    batches = [_pair(41 + i, (1, 1, 32, 32)) for i in range(2)]
    _drive(jc.PeakSignalNoiseRatioWithBlockedEffect(block_size=block_size),
           tc.PeakSignalNoiseRatioWithBlockedEffect(block_size=block_size, device="cpu"), batches, rtol=SUM_RTOL)


# ------------------------------------------------------------ UQI, RMSE-SW and TV


@pytest.mark.parametrize(
    "kw",
    [{}, {"kernel_size": (5, 9), "sigma": (1.0, 2.0)}, {"kernel_size": (7, 3), "sigma": (1.5, 0.5), "reduction": "sum"},
     {"reduction": "none", "kernel_size": (3, 5)}],
    ids=["default", "unequal", "unequal_sum", "none"],
)
def test_uqi(kw):
    p, t = _pair(50, (2, 3, 32, 36))
    want = jf.universal_image_quality_index(jnp.asarray(p), jnp.asarray(t), **kw)
    _close(want, tf.universal_image_quality_index(torch.from_numpy(p), torch.from_numpy(t), **kw), rtol=SUM_RTOL)
    batches = [_pair(51 + i, (2, 3, 32, 36)) for i in range(2)]
    _drive(jc.UniversalImageQualityIndex(**kw), tc.UniversalImageQualityIndex(device="cpu", **kw), batches,
           rtol=SUM_RTOL)


@pytest.mark.parametrize("window", [8, 7, 3, 12])
def test_rmse_sw(window):
    p, t = _pair(60 + window, (2, 3, 32, 36))
    want = jf.root_mean_squared_error_using_sliding_window(jnp.asarray(p), jnp.asarray(t), window, True)
    _close(want, tf.root_mean_squared_error_using_sliding_window(torch.from_numpy(p), torch.from_numpy(t), window, True))
    batches = [_pair(61 + i, (2, 3, 32, 36)) for i in range(2)]
    _drive(jc.RootMeanSquaredErrorUsingSlidingWindow(window), tc.RootMeanSquaredErrorUsingSlidingWindow(window,
                                                                                                        device="cpu"),
           batches)


@pytest.mark.parametrize("reduction", ["sum", "mean", "none", None])
def test_total_variation(reduction):
    p, _ = _pair(70, (3, 3, 28, 30))
    _close(jf.total_variation(jnp.asarray(p), reduction), tf.total_variation(torch.from_numpy(p), reduction),
           rtol=SUM_RTOL)
    batches = [_pair(71 + i, (3, 3, 28, 30)) for i in range(2)]
    _drive(jc.TotalVariation(reduction), tc.TotalVariation(reduction, device="cpu"), batches, rtol=SUM_RTOL,
           preds_only=True)


# ------------------------------------------------------------------- validation


def _err(fn):
    try:
        fn()
    except Exception as err:  # noqa: BLE001 - the test compares whatever both raise
        return type(err), str(err)
    return None


ERROR_CASES = {
    "ssim_shape": lambda m, x: m.structural_similarity_index_measure(x(2, 3, 32, 32), x(2, 3, 32, 31)),
    "ssim_ndim": lambda m, x: m.structural_similarity_index_measure(x(2, 32, 32), x(2, 32, 32)),
    "ssim_even_kernel": lambda m, x: m.structural_similarity_index_measure(x(1, 1, 32, 32), x(1, 1, 32, 32),
                                                                           kernel_size=10),
    "ssim_sigma": lambda m, x: m.structural_similarity_index_measure(x(1, 1, 32, 32), x(1, 1, 32, 32), sigma=-1.0),
    "ssim_kernel_len": lambda m, x: m.structural_similarity_index_measure(x(1, 1, 32, 32), x(1, 1, 32, 32),
                                                                          kernel_size=(11, 11, 11)),
    "ssim_sigma_len": lambda m, x: m.structural_similarity_index_measure(x(1, 1, 32, 32), x(1, 1, 32, 32),
                                                                         sigma=(1.5,)),
    "ssim_exclusive": lambda m, x: m.structural_similarity_index_measure(
        x(1, 1, 32, 32), x(1, 1, 32, 32), return_full_image=True, return_contrast_sensitivity=True),
    "ssim_reduction": lambda m, x: m.structural_similarity_index_measure(x(1, 1, 32, 32), x(1, 1, 32, 32),
                                                                         reduction="max"),
    "ms_ssim_betas_type": lambda m, x: m.multiscale_structural_similarity_index_measure(
        x(1, 1, 64, 64), x(1, 1, 64, 64), betas=[0.5, 0.5]),
    "ms_ssim_betas_float": lambda m, x: m.multiscale_structural_similarity_index_measure(
        x(1, 1, 64, 64), x(1, 1, 64, 64), betas=(1, 2)),
    "ms_ssim_normalize": lambda m, x: m.multiscale_structural_similarity_index_measure(
        x(1, 1, 64, 64), x(1, 1, 64, 64), normalize="tanh"),
    "ms_ssim_small": lambda m, x: m.multiscale_structural_similarity_index_measure(x(1, 1, 16, 16), x(1, 1, 16, 16)),
    "ms_ssim_height": lambda m, x: m.multiscale_structural_similarity_index_measure(x(1, 1, 64, 200),
                                                                                    x(1, 1, 64, 200)),
    "ms_ssim_width": lambda m, x: m.multiscale_structural_similarity_index_measure(x(1, 1, 200, 64),
                                                                                   x(1, 1, 200, 64)),
    "psnr_dim_without_range": lambda m, x: m.peak_signal_noise_ratio(x(2, 4), x(2, 4), dim=1),
    "psnr_shape": lambda m, x: m.peak_signal_noise_ratio(x(2, 4), x(2, 5)),
    "psnrb_channels": lambda m, x: m.peak_signal_noise_ratio_with_blocked_effect(x(1, 3, 16, 16), x(1, 3, 16, 16)),
    "uqi_dtype": lambda m, x: m.universal_image_quality_index(x(1, 1, 16, 16), x(1, 1, 16, 16, dtype="float16")),
    "uqi_ndim": lambda m, x: m.universal_image_quality_index(x(1, 16, 16), x(1, 16, 16)),
    "uqi_kernel_len": lambda m, x: m.universal_image_quality_index(x(1, 1, 16, 16), x(1, 1, 16, 16),
                                                                   kernel_size=(3, 3, 3)),
    "uqi_even_kernel": lambda m, x: m.universal_image_quality_index(x(1, 1, 16, 16), x(1, 1, 16, 16),
                                                                    kernel_size=(4, 3)),
    "uqi_sigma": lambda m, x: m.universal_image_quality_index(x(1, 1, 16, 16), x(1, 1, 16, 16), sigma=(1.0, 0.0)),
    "uqi_reduction": lambda m, x: m.universal_image_quality_index(x(1, 1, 16, 16), x(1, 1, 16, 16),
                                                                  reduction="max"),
    "rmse_sw_window": lambda m, x: m.root_mean_squared_error_using_sliding_window(x(1, 1, 16, 16), x(1, 1, 16, 16),
                                                                                   window_size=0),
    "rmse_sw_large": lambda m, x: m.root_mean_squared_error_using_sliding_window(x(1, 1, 8, 16), x(1, 1, 8, 16),
                                                                                  window_size=16),
    "rmse_sw_dtype": lambda m, x: m.root_mean_squared_error_using_sliding_window(
        x(1, 1, 16, 16, dtype="float16"), x(1, 1, 16, 16)),
    "rmse_sw_ndim": lambda m, x: m.root_mean_squared_error_using_sliding_window(x(16, 16), x(16, 16)),
    "tv_ndim": lambda m, x: m.total_variation(x(3, 16, 16)),
    "tv_reduction": lambda m, x: m.total_variation(x(1, 3, 16, 16), reduction="max"),
}

CLASS_ERROR_CASES = {
    "ssim_reduction": lambda m: m.StructuralSimilarityIndexMeasure(reduction="max"),
    "ms_ssim_reduction": lambda m: m.MultiScaleStructuralSimilarityIndexMeasure(reduction="max"),
    "ms_ssim_kernel_type": lambda m: m.MultiScaleStructuralSimilarityIndexMeasure(kernel_size=11.0),
    "ms_ssim_kernel_len": lambda m: m.MultiScaleStructuralSimilarityIndexMeasure(kernel_size=(11,)),
    "ms_ssim_betas_type": lambda m: m.MultiScaleStructuralSimilarityIndexMeasure(betas=[0.5]),
    "ms_ssim_betas_float": lambda m: m.MultiScaleStructuralSimilarityIndexMeasure(betas=(1,)),
    "ms_ssim_normalize": lambda m: m.MultiScaleStructuralSimilarityIndexMeasure(normalize="tanh"),
    "psnr_dim_without_range": lambda m: m.PeakSignalNoiseRatio(dim=1),
    "psnrb_block": lambda m: m.PeakSignalNoiseRatioWithBlockedEffect(block_size=0),
    "rmse_sw_window": lambda m: m.RootMeanSquaredErrorUsingSlidingWindow(window_size=-1),
    "tv_reduction": lambda m: m.TotalVariation(reduction="max"),
}


def _jax_array(*shape, dtype="float32"):
    return jnp.asarray(np.random.RandomState(0).rand(*shape).astype(dtype))


def _torch_array(*shape, dtype="float32"):
    return torch.from_numpy(np.random.RandomState(0).rand(*shape).astype(dtype))


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_validation_errors_match_jax(case):
    want = _err(lambda: ERROR_CASES[case](jf, _jax_array))
    got = _err(lambda: ERROR_CASES[case](tf, _torch_array))
    assert want is not None and got == want


@pytest.mark.parametrize("case", sorted(CLASS_ERROR_CASES))
def test_class_validation_errors_match_jax(case):
    want = _err(lambda: CLASS_ERROR_CASES[case](jc))
    got = _err(lambda: CLASS_ERROR_CASES[case](_CpuModule(tc)))
    assert want is not None and got == want


class _CpuModule:
    """The port's classes, built with ``device="cpu"``."""

    def __init__(self, module):
        self._module = module

    def __getattr__(self, name):
        return functools.partial(getattr(self._module, name), device="cpu")


# ------------------------------------------------------------------- carry-across


@pytest.mark.parametrize(
    "name, factory",
    [("ssim_mean", lambda m, **k: m.StructuralSimilarityIndexMeasure(data_range=1.0, **k)),
     ("ssim_none", lambda m, **k: m.StructuralSimilarityIndexMeasure(reduction="none", **k)),
     ("psnr", lambda m, **k: m.PeakSignalNoiseRatio(**k)),
     ("psnr_dim", lambda m, **k: m.PeakSignalNoiseRatio(data_range=1.0, dim=(1, 2, 3), reduction="none", **k))],
)
def test_a_jax_state_loads_into_the_port(name, factory):
    jm = factory(jc)
    for i in range(2):
        p, t = _pair(80 + i, (2, 3, 32, 32))
        jm.update(jnp.asarray(p), jnp.asarray(t))
    port = load_jax_state(factory(tc, device="cpu"), jm.state_dict(persistent_only=False))
    _states_close(jm, port)
    _close(jm.compute(), port.compute(), rtol=SUM_RTOL)
    p, t = _pair(82, (2, 3, 32, 32))
    jm.update(jnp.asarray(p), jnp.asarray(t))
    port.update(torch.from_numpy(p), torch.from_numpy(t))
    _close(jm.compute(), port.compute(), rtol=SUM_RTOL)


# ------------------------------------------------------------------------ isolation


def test_no_port_source_imports_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|torchmetrics_tpu)(\.|\s|$)", re.MULTILINE)
    offenders = []
    for root, _, files in os.walk(os.path.join(REPO, "torchmetrics_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path, encoding="utf-8") as fh:
                    if pattern.search(fh.read()):
                        offenders.append(os.path.relpath(path, REPO))
    assert offenders == []


# ------------------------------------------------------------------------ examples

EXAMPLE_MODULES = [
    "torchmetrics_tpu_torch.functional.image.psnr",
    "torchmetrics_tpu_torch.functional.image.psnrb",
    "torchmetrics_tpu_torch.functional.image.rmse_sw",
    "torchmetrics_tpu_torch.functional.image.ssim",
    "torchmetrics_tpu_torch.functional.image.tv",
    "torchmetrics_tpu_torch.functional.image.uqi",
    "torchmetrics_tpu_torch.image.psnr",
    "torchmetrics_tpu_torch.image.quality",
    "torchmetrics_tpu_torch.image.ssim",
]


@pytest.mark.parametrize("module_name", EXAMPLE_MODULES)
def test_docstring_examples_run(module_name):
    import doctest
    import importlib

    results = doctest.testmod(importlib.import_module(module_name), optionflags=doctest.NORMALIZE_WHITESPACE)
    assert results.attempted > 0 and results.failed == 0
