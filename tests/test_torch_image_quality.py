"""The model-free rest of the image domain, held against the JAX package on the CPU.

The same seeded numpy images (up to 4 x 4 x 64 x 64) go through each JAX function and
its port: SAM, ERGAS, RASE, SCC (grayscale and colour, a custom high-pass filter,
every reduction), VIF, D-lambda, D-s (with and without ``pan_lr``, at resolution ratios
2 and 4), QNR and the image gradients; the bilinear resize that degrades D-s's
panchromatic image against ``jax.image.resize`` at ratios 2 and 4, at non-integer
ratios, upwards and along one axis; every validation message; each class over several
batches (``merge_states`` of two halves, a JAX state dict loaded and updated further);
the ``__all__`` lists, which equal JAX's with the model-based names ported.

Tolerances: every score within 1e-5 plus 1e-6 of its value (as ``chip_smoke.py``'s
image phases hold them); the resize within 1e-6 absolute of inputs in [0, 1]; the image
gradients bitwise; integer states exactly.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import torchmetrics_tpu.functional.image as jf  # noqa: E402
import torchmetrics_tpu.image as jc  # noqa: E402
import torchmetrics_tpu_torch as ttm  # noqa: E402
import torchmetrics_tpu_torch.functional as tfunctional  # noqa: E402
import torchmetrics_tpu_torch.functional.image as tf  # noqa: E402
import torchmetrics_tpu_torch.image as tc  # noqa: E402
from torchmetrics_tpu_torch.convert import load_jax_state  # noqa: E402
from torchmetrics_tpu_torch.parallel.reductions import merge_states  # noqa: E402

ATOL = 1e-5
RTOL = 1e-6


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(port, jax_value) -> None:
    got, want = _np(port), _np(jax_value)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def _pair(seed: int, shape=(2, 4, 48, 48), noise: float = 0.1):
    rng = np.random.RandomState(seed)
    target = rng.rand(*shape).astype(np.float32)
    preds = np.clip(target + noise * rng.randn(*shape), 0, 1).astype(np.float32)
    return preds, target


def _pansharpening(seed: int, batch: int = 2, bands: int = 4, size: int = 48, ratio: int = 4):
    """A fused image, its low-resolution multispectral image, a panchromatic image per
    band and a low-resolution panchromatic one."""
    rng = np.random.RandomState(seed)
    preds = rng.rand(batch, bands, size, size).astype(np.float32)
    ms = rng.rand(batch, bands, size // ratio, size // ratio).astype(np.float32)
    pan = np.clip(preds + 0.05 * rng.randn(*preds.shape), 0, 1).astype(np.float32)
    pan_lr = rng.rand(batch, bands, size // ratio, size // ratio).astype(np.float32)
    return preds, ms, pan, pan_lr


_JITTED: dict = {}


def _jax(name: str, *arrays, **static):
    """JAX's ``functional.image.<name>`` jitted over its arrays, one compile a
    configuration (op by op, JAX compiles each shape of each step)."""
    key = (name, tuple(sorted(static.items())), len(arrays))
    if key not in _JITTED:
        _JITTED[key] = jax.jit(lambda *a: getattr(jf, name)(*a, **static))
    return _JITTED[key](*arrays)


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _message(fn, exc) -> str:
    with pytest.raises(exc) as err:
        fn()
    return str(err.value)


# ------------------------------------------------------------------ functionals


def _close_angles(port, jax_value) -> None:
    """Per-pixel spectral angles: their cosines within 8 float32 ulps of 1, and their mean
    within ``ATOL``. The cosine is a float32 ratio of a dot product and two norms, each
    summed in another order (JAX's ``jnp.linalg.norm`` fuses its product into the sum;
    the port's does not), so it differs by a few ulps; the arc cosine near 1 turns one
    ulp into up to sqrt(2 * 6e-8) = 3.5e-4 rad, so the angles themselves cannot be held
    pixel by pixel."""
    got, want = _np(port), _np(jax_value)
    assert got.shape == want.shape
    np.testing.assert_allclose(np.cos(got.astype(np.float64)), np.cos(want.astype(np.float64)), atol=4.8e-7, rtol=0)
    np.testing.assert_allclose(got.mean(dtype=np.float64), want.mean(dtype=np.float64), atol=ATOL, rtol=0)


@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
def test_sam_and_ergas_equal_jax(reduction):
    preds, target = _pair(1)
    check = _close_angles if reduction == "none" else _close
    check(tf.spectral_angle_mapper(*_t(preds, target), reduction), jf.spectral_angle_mapper(preds, target, reduction))
    for ratio in (4, 2.5):
        _close(tf.error_relative_global_dimensionless_synthesis(*_t(preds, target), ratio, reduction),
               jf.error_relative_global_dimensionless_synthesis(preds, target, ratio, reduction))


@pytest.mark.parametrize("window_size", [8, 5])
def test_rase_equals_jax(window_size):
    preds, target = _pair(2)
    _close(tf.relative_average_spectral_error(*_t(preds, target), window_size),
           _jax("relative_average_spectral_error", preds, target, window_size=window_size))


@pytest.mark.parametrize("reduction", ["mean", "none"])
@pytest.mark.parametrize("shape, window_size", [((2, 3, 40, 36), 8), ((3, 32, 32), 5)])
def test_scc_equals_jax(shape, window_size, reduction):
    preds, target = _pair(3, shape, noise=0.3)
    _close(tf.spatial_correlation_coefficient(*_t(preds, target), window_size=window_size, reduction=reduction),
           _jax("spatial_correlation_coefficient", preds, target, window_size=window_size, reduction=reduction))


def test_scc_with_an_asymmetric_high_pass_filter_equals_jax():
    preds, target = _pair(4, (2, 2, 32, 32), noise=0.3)
    hp = np.array([[0.0, -1.0], [-1.0, 2.5]], np.float32)  # an even size pads asymmetrically, flipped
    _close(tf.spatial_correlation_coefficient(*_t(preds, target), torch.from_numpy(hp), window_size=4),
           _jax("spatial_correlation_coefficient", preds, target, jnp.asarray(hp), window_size=4))


@pytest.mark.parametrize("sigma_n_sq", [2.0, 0.5])
def test_vif_equals_jax(sigma_n_sq):
    preds, target = _pair(5, (2, 3, 48, 44), noise=0.2)
    _close(tf.visual_information_fidelity(*_t(preds, target), sigma_n_sq),
           _jax("visual_information_fidelity", preds, target, sigma_n_sq=sigma_n_sq))


@pytest.mark.parametrize("p, reduction", [(1, "elementwise_mean"), (2, "sum"), (1, "none")])
def test_d_lambda_equals_jax(p, reduction):
    preds, ms, _, _ = _pansharpening(6)
    _close(tf.spectral_distortion_index(*_t(preds, ms), p, reduction),
           _jax("spectral_distortion_index", preds, ms, p=p, reduction=reduction))


def test_d_lambda_of_one_band_equals_jax():
    preds, target = _pair(7, (2, 1, 24, 24))
    _close(tf.spectral_distortion_index(*_t(preds, target)), jf.spectral_distortion_index(preds, target))


@pytest.mark.parametrize("with_pan_lr", [False, True])
@pytest.mark.parametrize("ratio", [2, 4])
def test_d_s_and_qnr_equal_jax(ratio, with_pan_lr):
    preds, ms, pan, pan_lr = _pansharpening(8 + ratio, ratio=ratio, size=32)
    pan_lr = pan_lr if with_pan_lr else None
    port_lr = torch.from_numpy(pan_lr) if with_pan_lr else None
    norm_order = ratio // 2
    _close(tf.spatial_distortion_index(*_t(preds, ms, pan), port_lr, norm_order),
           _jax("spatial_distortion_index", preds, ms, pan, pan_lr, norm_order=norm_order))
    if with_pan_lr == (ratio == 2):
        _close(tf.quality_with_no_reference(*_t(preds, ms, pan), port_lr, alpha=0.5, beta=2),
               _jax("quality_with_no_reference", preds, ms, pan, pan_lr, alpha=0.5, beta=2))


@pytest.mark.parametrize("size, out", [((64, 64), (32, 32)), ((64, 64), (16, 16)), ((50, 37), (19, 23)),
                                       ((48, 48), (36, 36)), ((20, 20), (33, 41)), ((48, 48), (48, 17)),
                                       ((5, 5), (2, 2))])
def test_the_resize_of_d_s_equals_jax_image_resize(size, out):
    from torchmetrics_tpu_torch.functional.image.d_s import _resize_bilinear

    x = np.random.RandomState(sum(size) + sum(out)).rand(2, 3, *size).astype(np.float32)
    want = jax.image.resize(x, (2, 3, *out), method="bilinear")
    got = _resize_bilinear(torch.from_numpy(x), *out)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6, rtol=0)


def test_image_gradients_are_bitwise_jax_s():
    for x in (np.random.RandomState(9).rand(2, 3, 17, 12).astype(np.float32),
              np.arange(2 * 1 * 5 * 6, dtype=np.int32).reshape(2, 1, 5, 6)):
        for got, want in zip(tf.image_gradients(torch.from_numpy(x)), jf.image_gradients(x)):
            assert got.dtype == getattr(torch, str(_np(want).dtype))
            np.testing.assert_array_equal(_np(got), _np(want))


# ---------------------------------------------------------------------- messages


def test_validation_messages_equal_jax():
    a = np.zeros((2, 3, 16, 16), np.float32)
    cases = [
        (lambda m: m.spectral_angle_mapper(a, a[:, :1]), RuntimeError),
        (lambda m: m.spectral_angle_mapper(a, a.astype(np.float16)), TypeError),
        (lambda m: m.spectral_angle_mapper(a[0], a[0]), ValueError),
        (lambda m: m.spectral_angle_mapper(a[:, :1], a[:, :1]), ValueError),
        (lambda m: m.error_relative_global_dimensionless_synthesis(a, a.astype(np.int32)), TypeError),
        (lambda m: m.error_relative_global_dimensionless_synthesis(a[0], a[0]), ValueError),
        (lambda m: m.relative_average_spectral_error(a, a, 0), ValueError),
        (lambda m: m.spatial_correlation_coefficient(a[0, 0], a[0, 0]), ValueError),
        (lambda m: m.spatial_correlation_coefficient(a, a, window_size=0), ValueError),
        (lambda m: m.spatial_correlation_coefficient(a, a, window_size=17), ValueError),
        (lambda m: m.spatial_correlation_coefficient(a, a, reduction="sum"), ValueError),
        (lambda m: m.visual_information_fidelity(a, a), ValueError),
        (lambda m: m.visual_information_fidelity(np.zeros((1, 1, 41, 41), np.float32), a), ValueError),
        (lambda m: m.spectral_distortion_index(a, a.astype(np.float16)), TypeError),
        (lambda m: m.spectral_distortion_index(a[0], a[0]), ValueError),
        (lambda m: m.spectral_distortion_index(a, a[:, :2]), ValueError),
        (lambda m: m.spectral_distortion_index(a, a, p=0), ValueError),
        (lambda m: m.spatial_distortion_index(a, a[..., :8, :8], a, norm_order=0), ValueError),
        (lambda m: m.spatial_distortion_index(a, a[..., :8, :8], a, window_size=0), ValueError),
        (lambda m: m.spatial_distortion_index(a[0], a[..., :8, :8], a), ValueError),
        (lambda m: m.spatial_distortion_index(a, a[..., :8, :8].astype(np.float16), a), TypeError),
        (lambda m: m.spatial_distortion_index(a, a[0, :, :8, :8], a), ValueError),
        (lambda m: m.spatial_distortion_index(a, a[:, :2, :8, :8], a), ValueError),
        (lambda m: m.spatial_distortion_index(a, a[..., :8, :8], a[..., :8, :]), ValueError),
        (lambda m: m.spatial_distortion_index(a, a[..., :8, :8], a[..., :8]), ValueError),
        (lambda m: m.spatial_distortion_index(a, a[..., :6, :6], a), ValueError),
        (lambda m: m.spatial_distortion_index(a, a[..., :8, :8], a, a[..., :4, :4]), ValueError),
        (lambda m: m.spatial_distortion_index(a, a[..., :8, :8], a, window_size=8), ValueError),
        (lambda m: m.quality_with_no_reference(a, a[..., :8, :8], a, alpha=-1), ValueError),
        (lambda m: m.quality_with_no_reference(a, a[..., :8, :8], a, beta="1"), ValueError),
        (lambda m: m.image_gradients(a[0]), RuntimeError),
    ]
    for call, exc in cases:
        got = _message(lambda: call(tf), exc)
        assert got == _message(lambda: call(jf), exc)
    class_cases = [("VisualInformationFidelity", {"sigma_n_sq": -1.0}), ("RelativeAverageSpectralError",
                   {"window_size": 0}), ("SpectralDistortionIndex", {"p": 0}),
                   ("SpectralDistortionIndex", {"reduction": "mean"}), ("SpatialDistortionIndex", {"norm_order": 0}),
                   ("SpatialDistortionIndex", {"window_size": 1.5}), ("QualityWithNoReference", {"alpha": -1}),
                   ("QualityWithNoReference", {"beta": None}), ("QualityWithNoReference", {"reduction": None})]
    for cls, kwargs in class_cases:
        got = _message(lambda: getattr(tc, cls)(device="cpu", **kwargs), ValueError)
        assert got == _message(lambda: getattr(jc, cls)(**kwargs), ValueError)
    for cls in ("SpatialDistortionIndex", "QualityWithNoReference"):
        for target in ({"pan": a}, {"ms": a}):
            got = _message(lambda: getattr(tc, cls)(device="cpu").update(torch.from_numpy(a), target), ValueError)
            assert got == _message(lambda: getattr(jc, cls)().update(a, target), ValueError)


# ------------------------------------------------------------------------ classes


CLASSES = {
    "sam": lambda m, **kw: m.SpectralAngleMapper(**kw),
    "sam_none": lambda m, **kw: m.SpectralAngleMapper(reduction="none", **kw),
    "ergas": lambda m, **kw: m.ErrorRelativeGlobalDimensionlessSynthesis(ratio=2, **kw),
    "scc": lambda m, **kw: m.SpatialCorrelationCoefficient(window_size=5, **kw),
    "vif": lambda m, **kw: m.VisualInformationFidelity(**kw),
    "rase": lambda m, **kw: m.RelativeAverageSpectralError(window_size=6, **kw),
    "d_lambda": lambda m, **kw: m.SpectralDistortionIndex(**kw),
}
PANSHARPENING = {
    "d_s": lambda m, **kw: m.SpatialDistortionIndex(**kw),
    "qnr": lambda m, **kw: m.QualityWithNoReference(**kw),
}


def _batches(seed: int, n: int = 3) -> list:
    return [_pair(seed + i, (2, 3, 44, 44)) for i in range(n)]


@pytest.mark.parametrize("case", sorted(CLASSES))
def test_class_over_batches_equals_jax(case):
    port, jax_metric = CLASSES[case](tc, device="cpu"), CLASSES[case](jc)
    for preds, target in _batches(20):
        port.update(*_t(preds, target))
        jax_metric.update(preds, target)
    state, jax_state = port.state_dict(persistent_only=False), jax_metric.state_dict(persistent_only=False)
    assert sorted(state) == sorted(jax_state)
    for key, value in state.items():
        values = value if isinstance(value, list) else [value]
        jax_values = jax_state[key] if isinstance(jax_state[key], list) else [jax_state[key]]
        assert len(values) == len(jax_values)
        for got, want in zip(values, jax_values):
            assert got.dtype == getattr(torch, str(_np(want).dtype)), key
            _close(got, want)
    (_close_angles if case == "sam_none" else _close)(port.compute(), jax_metric.compute())


@pytest.mark.parametrize("with_pan_lr", [False, True])
@pytest.mark.parametrize("case", sorted(PANSHARPENING))
def test_pansharpening_class_over_batches_equals_jax(case, with_pan_lr):
    port, jax_metric = PANSHARPENING[case](tc, device="cpu"), PANSHARPENING[case](jc)
    for i in range(2):
        preds, ms, pan, pan_lr = _pansharpening(30 + i, size=32)
        target = {"ms": ms, "pan": pan, **({"pan_lr": pan_lr} if with_pan_lr else {})}
        port.update(torch.from_numpy(preds), {k: torch.from_numpy(v) for k, v in target.items()})
        jax_metric.update(preds, target)
    assert len(port.pan_lr) == len(jax_metric.pan_lr) == (2 if with_pan_lr else 0)
    _close(port.compute(), jax_metric.compute())


def test_merged_halves_equal_one_metric_fed_everything():
    batches = [_t(*b) for b in _batches(40, 4)]
    for make in (lambda: tc.SpatialCorrelationCoefficient(device="cpu"), lambda: tc.SpectralAngleMapper(device="cpu"),
                 lambda: tc.ErrorRelativeGlobalDimensionlessSynthesis(device="cpu")):
        first, second, whole = make(), make(), make()
        for b in batches[:2]:
            first.update(*b)
        for b in batches[2:]:
            second.update(*b)
        for b in batches:
            whole.update(*b)
        state = {k: merge_states(first.metric_state[k], second.metric_state[k], first._reductions[k], 2, 2)
                 for k in first.metric_state}
        _close(whole.pure_compute(state), whole.compute())


@pytest.mark.parametrize("case", ["vif", "sam"])
def test_a_jax_state_loaded_into_the_port_goes_on_equal(case):
    batches = _batches(50)
    jax_metric = CLASSES[case](jc)
    jax_metric.update(*batches[0])
    port = load_jax_state(CLASSES[case](tc, device="cpu"), jax_metric.state_dict(persistent_only=False))
    for preds, target in batches[1:]:
        jax_metric.update(preds, target)
        port.update(*_t(preds, target))
    _close(port.compute(), jax_metric.compute())


# ------------------------------------------------------------------------ names


MODEL_BASED_CLASSES = ("LearnedPerceptualImagePatchSimilarity", "FrechetInceptionDistance", "InceptionScore",
                       "KernelInceptionDistance", "MemorizationInformedFrechetInceptionDistance",
                       "PerceptualPathLength")
MODEL_BASED_FUNCTIONS = ("learned_perceptual_image_patch_similarity", "perceptual_path_length")


@pytest.mark.parametrize("module, name",
                         [(tc, n) for n in MODEL_BASED_CLASSES] + [(tf, n) for n in MODEL_BASED_FUNCTIONS])
def test_a_model_based_name_raises_naming_its_roadmap_item(module, name):
    # the model-based image names are ported: each is exported beside its JAX name, and
    # only an unknown name raises
    jax_module = jc if module is tc else jf
    assert name in module.__all__ and name in jax_module.__all__
    assert getattr(module, name).__name__ == getattr(jax_module, name).__name__
    assert getattr(ttm if module is tc else tfunctional.image, name) is getattr(module, name)
    with pytest.raises(AttributeError):
        getattr(module, name + "Missing")


def test_every_jax_name_but_the_model_based_ones_is_exported():
    # every JAX name is exported now, the model-based ones too
    assert tc.__all__ == jc.__all__ and tf.__all__ == jf.__all__
    assert set(MODEL_BASED_CLASSES) <= set(tc.__all__) and set(MODEL_BASED_FUNCTIONS) <= set(tf.__all__)
    assert set(tc.__all__) <= set(ttm.__all__) and set(tf.__all__) <= set(tfunctional.__all__)
    with pytest.raises(AttributeError):
        tc.NoSuchMetric  # noqa: B018


@pytest.mark.parametrize("module_name", [
    f"torchmetrics_tpu_torch.functional.image.{name}"
    for name in ("sam", "ergas", "rase", "gradients", "scc", "vif", "d_lambda", "d_s", "qnr")
] + ["torchmetrics_tpu_torch.image.pansharpening"])
def test_docstring_examples_run(module_name):
    import doctest
    import importlib

    results = doctest.testmod(importlib.import_module(module_name), optionflags=doctest.NORMALIZE_WHITESPACE)
    assert results.attempted > 0 and results.failed == 0
