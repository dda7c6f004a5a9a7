"""The port's SNR family, SDR and PIT, held against the JAX package on the CPU.

The same seeded numpy signals (0.5-1 s at 8 and 16 kHz) go through each JAX function
and its port. Covered: SNR, SI-SNR, C-SI-SNR (complex and real ``(..., F, T, 2)``
input), SI-SDR, SA-SDR, SDR (filter lengths, ``zero_mean``, ``load_diag``, the
``use_cg_iter`` warning), PIT in both modes with 2 speakers (the exhaustive search) and
4 (``linear_sum_assignment`` on the host), ``pit_permutate``, every validation message,
the dependency gates of PESQ, pystoi and srmrpy, the DNSMOS names that raise, and each
class over several batches: its states, ``merge_states`` of two halves, a JAX state dict
loaded and updated further, and ``jit_update=True`` against the eager update.

Tolerances:

- SNR, SI-SNR, SI-SDR, SA-SDR, C-SI-SNR: 1e-4 dB (float32 sums in another order).
- SDR: 1e-2 dB. Both packages solve the Toeplitz system in float32, with LAPACK's
  pivoting on either side here; the largest gap these cases give is about 1e-3 dB.
- PIT: the permutation exactly; the metric as its base metric's tolerance.
- Integer states (``total``) exactly.
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torchmetrics_tpu.audio as ja  # noqa: E402
import torchmetrics_tpu.functional.audio as jf  # noqa: E402
import torchmetrics_tpu_torch as ttm  # noqa: E402
import torchmetrics_tpu_torch.audio as ta  # noqa: E402
import torchmetrics_tpu_torch.functional as tfunctional  # noqa: E402
import torchmetrics_tpu_torch.functional.audio as tf  # noqa: E402
from torchmetrics_tpu_torch.audio import modules as tmodules  # noqa: E402
from torchmetrics_tpu_torch.convert import load_jax_state  # noqa: E402
from torchmetrics_tpu_torch.parallel.reductions import merge_states  # noqa: E402

DB_ATOL = 1e-4
SDR_ATOL = 1e-2


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(port, jax_value, atol: float = DB_ATOL) -> None:
    got, want = _np(port), _np(jax_value)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _pair(seed: int, shape: tuple, noise: float = 0.3):
    """A seeded band-limited-ish source and an estimate about 10 dB below it in noise."""
    rng = np.random.RandomState(seed)
    target = np.cumsum(rng.randn(*shape), axis=-1)
    target = (target - target.mean(axis=-1, keepdims=True)) / 20.0
    preds = target + noise * target.std() * rng.randn(*shape)
    return preds.astype(np.float32), target.astype(np.float32)


def _message(fn, exc) -> str:
    with pytest.raises(exc) as err:
        fn()
    return str(err.value)


# ------------------------------------------------------------------ the SNR family


@pytest.mark.parametrize("shape", [(4000,), (3, 4000), (2, 2, 8000)])
@pytest.mark.parametrize("zero_mean", [False, True])
@pytest.mark.parametrize("name", ["signal_noise_ratio", "scale_invariant_signal_distortion_ratio"])
def test_snr_and_si_sdr_equal_jax(name, zero_mean, shape):
    preds, target = _pair(len(shape) + 3 * zero_mean, shape)
    got = getattr(tf, name)(torch.from_numpy(preds), torch.from_numpy(target), zero_mean=zero_mean)
    want = getattr(jf, name)(jnp.asarray(preds), jnp.asarray(target), zero_mean=zero_mean)
    assert got.dtype == torch.float32
    _close(got, want)


def test_si_snr_and_float64_input_equal_jax():
    preds, target = _pair(11, (3, 8000))
    got = tf.scale_invariant_signal_noise_ratio(torch.from_numpy(preds).double(), torch.from_numpy(target).double())
    assert got.dtype == torch.float32  # JAX takes float64 as float32
    _close(got, jf.scale_invariant_signal_noise_ratio(preds.astype(np.float64), target.astype(np.float64)))


@pytest.mark.parametrize("scale_invariant", [True, False])
@pytest.mark.parametrize("zero_mean", [False, True])
def test_sa_sdr_equals_jax(scale_invariant, zero_mean):
    preds, target = _pair(12, (3, 2, 4000))
    got = tf.source_aggregated_signal_distortion_ratio(torch.from_numpy(preds), torch.from_numpy(target),
                                                        scale_invariant, zero_mean)
    _close(got, jf.source_aggregated_signal_distortion_ratio(jnp.asarray(preds), jnp.asarray(target),
                                                             scale_invariant, zero_mean))


@pytest.mark.parametrize("zero_mean", [False, True])
def test_c_si_snr_of_complex_and_real_pairs_equals_jax(zero_mean):
    rng = np.random.RandomState(13)
    target = (rng.randn(2, 65, 20) + 1j * rng.randn(2, 65, 20)).astype(np.complex64)
    preds = (target + 0.3 * (rng.randn(2, 65, 20) + 1j * rng.randn(2, 65, 20))).astype(np.complex64)
    want = jf.complex_scale_invariant_signal_noise_ratio(jnp.asarray(preds), jnp.asarray(target), zero_mean)
    got = tf.complex_scale_invariant_signal_noise_ratio(torch.from_numpy(preds), torch.from_numpy(target), zero_mean)
    _close(got, want)
    real = [np.stack([a.real, a.imag], axis=-1) for a in (preds, target)]
    _close(tf.complex_scale_invariant_signal_noise_ratio(*map(torch.from_numpy, real), zero_mean=zero_mean), want)
    # one complex, one real pair
    _close(tf.complex_scale_invariant_signal_noise_ratio(torch.from_numpy(preds), torch.from_numpy(real[1]),
                                                         zero_mean), want)


# ---------------------------------------------------------------------------- SDR


@pytest.mark.parametrize("filter_length, zero_mean, load_diag", [(512, False, None), (128, True, None),
                                                                  (64, False, 1e-3)])
def test_sdr_equals_jax_within_its_tolerance(filter_length, zero_mean, load_diag):
    preds, target = _pair(filter_length, (2, 2, 4000), noise=0.5)
    got = tf.signal_distortion_ratio(torch.from_numpy(preds), torch.from_numpy(target), None, filter_length,
                                     zero_mean, load_diag)
    want = jax.jit(jf.signal_distortion_ratio, static_argnums=(2, 3, 4, 5))(
        jnp.asarray(preds), jnp.asarray(target), None, filter_length, zero_mean, load_diag)
    _close(got, want, atol=SDR_ATOL)


def test_sdr_helpers_equal_jax():
    from torchmetrics_tpu.functional.audio.sdr import _compute_autocorr_crosscorr as jcorr
    from torchmetrics_tpu.functional.audio.sdr import _symmetric_toeplitz as jtoeplitz
    from torchmetrics_tpu_torch.functional.audio.sdr import _compute_autocorr_crosscorr as tcorr
    from torchmetrics_tpu_torch.functional.audio.sdr import _symmetric_toeplitz as ttoeplitz

    preds, target = _pair(14, (2, 3000))
    for got, want in zip(tcorr(torch.from_numpy(target), torch.from_numpy(preds), 100),
                         jcorr(jnp.asarray(target), jnp.asarray(preds), 100)):
        # FFT correlations of 3,000 samples: within float32 rounding of the largest lag
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=1e-6 * np.abs(_np(want)).max())
    v = np.random.RandomState(15).rand(3, 7).astype(np.float32)
    np.testing.assert_array_equal(_np(ttoeplitz(torch.from_numpy(v))), _np(jtoeplitz(jnp.asarray(v))))


def test_sdr_use_cg_iter_warns_with_jax_s_text():
    preds, target = _pair(16, (4000,))
    with warnings.catch_warnings(record=True) as port_warnings:
        warnings.simplefilter("always")
        tf.signal_distortion_ratio(torch.from_numpy(preds), torch.from_numpy(target), use_cg_iter=10)
    with warnings.catch_warnings(record=True) as jax_warnings:
        warnings.simplefilter("always")
        jf.signal_distortion_ratio(jnp.asarray(preds), jnp.asarray(target), use_cg_iter=10)
    port_text = [str(w.message) for w in port_warnings if "use_cg_iter" in str(w.message)]
    assert port_text and port_text == [str(w.message) for w in jax_warnings if "use_cg_iter" in str(w.message)]


# ---------------------------------------------------------------------------- PIT


@pytest.mark.parametrize("mode, eval_func, speakers", [
    ("speaker-wise", "max", 2), ("speaker-wise", "min", 2), ("speaker-wise", "max", 4), ("speaker-wise", "min", 4),
    ("permutation-wise", "max", 2), ("permutation-wise", "min", 3),
])
def test_pit_equals_jax(mode, eval_func, speakers):
    preds, target = _pair(20 + speakers, (3, speakers, 2000))
    preds = preds[:, ::-1].copy()  # the best permutation is not the identity
    got_metric, got_perm = tf.permutation_invariant_training(
        torch.from_numpy(preds), torch.from_numpy(target), tf.scale_invariant_signal_distortion_ratio, mode, eval_func)
    want_metric, want_perm = jf.permutation_invariant_training(
        jnp.asarray(preds), jnp.asarray(target), jf.scale_invariant_signal_distortion_ratio, mode, eval_func)
    np.testing.assert_array_equal(_np(got_perm), _np(want_perm))
    assert got_perm.dtype == torch.int32
    _close(got_metric, want_metric)


def test_pit_passes_keyword_arguments_and_permutates_like_jax():
    preds, target = _pair(25, (2, 3, 2000))
    preds = preds[:, [2, 0, 1]].copy()
    got_metric, got_perm = tf.permutation_invariant_training(
        torch.from_numpy(preds), torch.from_numpy(target), tf.signal_noise_ratio, zero_mean=True)
    want_metric, want_perm = jf.permutation_invariant_training(
        jnp.asarray(preds), jnp.asarray(target), jf.signal_noise_ratio, zero_mean=True)
    np.testing.assert_array_equal(_np(got_perm), _np(want_perm))
    _close(got_metric, want_metric)
    np.testing.assert_array_equal(_np(tf.pit_permutate(torch.from_numpy(preds), got_perm)),
                                  _np(jf.pit_permutate(jnp.asarray(preds), want_perm)))


# ---------------------------------------------------------------------- messages


def test_validation_messages_equal_jax():
    one, two = np.zeros(8, np.float32), np.zeros(9, np.float32)
    for name in ("signal_noise_ratio", "scale_invariant_signal_distortion_ratio", "signal_distortion_ratio",
                 "source_aggregated_signal_distortion_ratio"):
        got = _message(lambda: getattr(tf, name)(torch.from_numpy(one), torch.from_numpy(two)), RuntimeError)
        assert got == _message(lambda: getattr(jf, name)(jnp.asarray(one), jnp.asarray(two)), RuntimeError)
    got = _message(lambda: tf.source_aggregated_signal_distortion_ratio(torch.from_numpy(one), torch.from_numpy(one)),
                   RuntimeError)
    assert got == _message(lambda: jf.source_aggregated_signal_distortion_ratio(jnp.asarray(one), jnp.asarray(one)),
                           RuntimeError)
    bad = np.zeros((2, 5, 3), np.float32)
    got = _message(lambda: tf.complex_scale_invariant_signal_noise_ratio(torch.from_numpy(bad), torch.from_numpy(bad)),
                   RuntimeError)
    assert got == _message(lambda: jf.complex_scale_invariant_signal_noise_ratio(jnp.asarray(bad), jnp.asarray(bad)),
                           RuntimeError)
    pit_cases = [({"eval_func": "mean"}, (2, 2, 8)), ({"mode": "both"}, (2, 2, 8)), ({}, (8,))]
    for kwargs, shape in pit_cases:
        x = np.zeros(shape, np.float32)
        got = _message(lambda: tf.permutation_invariant_training(
            torch.from_numpy(x), torch.from_numpy(x), tf.signal_noise_ratio, **kwargs), ValueError)
        assert got == _message(lambda: jf.permutation_invariant_training(
            x, x, jf.signal_noise_ratio, **kwargs), ValueError)
    class_cases = [("ComplexScaleInvariantSignalNoiseRatio", {"zero_mean": 1}),
                   ("SourceAggregatedSignalDistortionRatio", {"scale_invariant": 1}),
                   ("SourceAggregatedSignalDistortionRatio", {"zero_mean": "no"}),
                   ("PermutationInvariantTraining", {"metric_func": None, "eval_func": "mean"}),
                   ("PermutationInvariantTraining", {"metric_func": None, "mode": "both"})]
    for cls, kwargs in class_cases:
        got = _message(lambda: getattr(ta, cls)(device="cpu", **kwargs), ValueError)
        assert got == _message(lambda: getattr(ja, cls)(**kwargs), ValueError)


@pytest.mark.parametrize("name, args", [
    ("perceptual_evaluation_speech_quality", (16000, "wb")),
    ("short_time_objective_intelligibility", (16000,)),
    ("_srmr_srmrpy", (16000,)),
])
def test_the_external_gates_raise_jax_s_install_hints(name, args):
    from torchmetrics_tpu.functional.audio import external as jexternal
    from torchmetrics_tpu_torch.functional.audio import external as texternal

    assert (texternal._PESQ_AVAILABLE, texternal._PYSTOI_AVAILABLE, texternal._SRMRPY_AVAILABLE) == (
        jexternal._PESQ_AVAILABLE, jexternal._PYSTOI_AVAILABLE, jexternal._SRMRPY_AVAILABLE) == (False, False, False)
    x = np.zeros(16000, np.float32)
    inputs = (x,) if name == "_srmr_srmrpy" else (x, x)
    got = _message(lambda: getattr(texternal, name)(*map(torch.from_numpy, inputs), *args), ModuleNotFoundError)
    assert got == _message(lambda: getattr(jexternal, name)(*inputs, *args), ModuleNotFoundError)


def test_the_pesq_class_raises_jax_s_install_hint_at_update():
    x = np.zeros(8000, np.float32)
    port = ta.PerceptualEvaluationSpeechQuality(8000, "nb", device="cpu")
    assert port._jit_update_flag is False
    got = _message(lambda: port.update(torch.from_numpy(x), torch.from_numpy(x)), ModuleNotFoundError)
    assert got == _message(lambda: ja.PerceptualEvaluationSpeechQuality(8000, "nb").update(x, x),
                           ModuleNotFoundError)


@pytest.mark.parametrize("module, name", [
    (tf, "deep_noise_suppression_mean_opinion_score"),
    (ta, "DeepNoiseSuppressionMeanOpinionScore"),
    (tmodules, "DeepNoiseSuppressionMeanOpinionScore"),
])
def test_dnsmos_raises_naming_its_roadmap_item(module, name):
    with pytest.raises(NotImplementedError, match="convert/`-and-DNSMOS item of ROADMAP Queue 1"):
        getattr(module, name)
    with pytest.raises(AttributeError):
        module.no_such_metric  # noqa: B018


def test_every_jax_name_but_dnsmos_is_exported():
    dnsmos = {"deep_noise_suppression_mean_opinion_score", "DeepNoiseSuppressionMeanOpinionScore"}
    assert sorted(tf.__all__) == sorted(set(jf.__all__) - dnsmos)
    assert sorted(ta.__all__) == sorted(set(ja.__all__) - dnsmos)
    assert set(ta.__all__) <= set(ttm.__all__)
    assert set(tf.__all__) <= set(tfunctional.__all__) and "audio" in tfunctional.__all__


# ------------------------------------------------------------------------ classes


CLASSES = {
    "snr": lambda m, **kw: m.SignalNoiseRatio(zero_mean=True, **kw),
    "si_snr": lambda m, **kw: m.ScaleInvariantSignalNoiseRatio(**kw),
    "si_sdr": lambda m, **kw: m.ScaleInvariantSignalDistortionRatio(**kw),
    "sa_sdr": lambda m, **kw: m.SourceAggregatedSignalDistortionRatio(**kw),
    "sdr": lambda m, **kw: m.SignalDistortionRatio(filter_length=64, **kw),
    "pit": lambda m, **kw: m.PermutationInvariantTraining(
        (tf if m is ta else jf).scale_invariant_signal_distortion_ratio, eval_func="max", **kw),
}


def _batches(seed: int, n: int = 3, shape=(2, 2, 2000)) -> list:
    return [_pair(seed + i, shape) for i in range(n)]


@pytest.mark.parametrize("case", sorted(CLASSES))
def test_class_over_batches_equals_jax(case):
    port, jax_metric = CLASSES[case](ta, device="cpu"), CLASSES[case](ja)
    for preds, target in _batches(30):
        _close(port(torch.from_numpy(preds), torch.from_numpy(target)),
               jax_metric(jnp.asarray(preds), jnp.asarray(target)), SDR_ATOL if case == "sdr" else DB_ATOL)
    state, jax_state = port.state_dict(persistent_only=False), jax_metric.state_dict(persistent_only=False)
    assert state["total"].dtype == torch.int32 and state["sum_score"].dtype == torch.float32
    assert int(state["total"]) == int(jax_state["total"])
    _close(port.compute(), jax_metric.compute(), SDR_ATOL if case == "sdr" else DB_ATOL)
    assert port._compute_group_params() == jax_metric._compute_group_params()


def test_c_si_snr_class_over_batches_equals_jax():
    port = ta.ComplexScaleInvariantSignalNoiseRatio(device="cpu")
    jax_metric = ja.ComplexScaleInvariantSignalNoiseRatio()
    rng = np.random.RandomState(33)
    for _ in range(3):
        target = rng.randn(2, 33, 12, 2).astype(np.float32)
        preds = (target + 0.5 * rng.randn(*target.shape)).astype(np.float32)
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
        jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
    _close(port.compute(), jax_metric.compute())
    assert int(port.total) == int(jax_metric.total) == 6


def test_merged_halves_equal_one_metric_fed_everything():
    batches = [tuple(map(torch.from_numpy, b)) for b in _batches(40, 4)]
    first, second, whole = (ta.ScaleInvariantSignalDistortionRatio(device="cpu") for _ in range(3))
    for b in batches[:2]:
        first.update(*b)
    for b in batches[2:]:
        second.update(*b)
    for b in batches:
        whole.update(*b)
    state = {k: merge_states(first.metric_state[k], second.metric_state[k], first._reductions[k], 2, 2)
             for k in first.metric_state}
    assert torch.equal(state["total"], whole.total)
    _close(whole.pure_compute(state), whole.compute())


def test_a_jax_state_loaded_into_the_port_goes_on_equal():
    batches = _batches(50, 3)
    jax_metric = ja.SignalNoiseRatio()
    jax_metric.update(jnp.asarray(batches[0][0]), jnp.asarray(batches[0][1]))
    port = load_jax_state(ta.SignalNoiseRatio(device="cpu"), jax_metric.state_dict(persistent_only=False))
    for preds, target in batches[1:]:
        jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert port.total.dtype == torch.int32 and int(port.total) == int(jax_metric.total)
    _close(port.compute(), jax_metric.compute())


@pytest.mark.parametrize("cls", ["ScaleInvariantSignalDistortionRatio", "PermutationInvariantTraining"])
def test_a_captured_update_equals_the_eager_one(cls):
    args = (tf.scale_invariant_signal_distortion_ratio,) if cls == "PermutationInvariantTraining" else ()
    eager = getattr(ta, cls)(*args, device="cpu")
    captured = getattr(ta, cls)(*args, device="cpu", jit_update=True)
    for preds, target in _batches(60):
        eager.update(torch.from_numpy(preds), torch.from_numpy(target))
        captured.update(torch.from_numpy(preds), torch.from_numpy(target))
    for key in ("sum_score", "total"):
        assert torch.equal(getattr(eager, key), getattr(captured, key))
    info = captured._jitted_update.cache_info()
    assert info["misses"] == 1 and info["hits"] == 2


@pytest.mark.parametrize("module_name", [
    "torchmetrics_tpu_torch.functional.audio.sdr", "torchmetrics_tpu_torch.functional.audio.snr",
    "torchmetrics_tpu_torch.functional.audio.pit", "torchmetrics_tpu_torch.functional.audio.stoi",
    "torchmetrics_tpu_torch.functional.audio.srmr", "torchmetrics_tpu_torch.audio.modules",
])
def test_docstring_examples_run(module_name):
    import doctest
    import importlib

    results = doctest.testmod(importlib.import_module(module_name), optionflags=doctest.NORMALIZE_WHITESPACE)
    assert results.attempted > 0 and results.failed == 0
