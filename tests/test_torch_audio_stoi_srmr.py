"""The port's native STOI, ESTOI and SRMR, held against the JAX package on the CPU.

The same seeded numpy signals (0.5-1 s at 8, 10 and 16 kHz) go through each JAX
function and its port: STOI and ESTOI with and without silent stretches (the VAD's
compaction) and over batch shapes, the polyphase resample, SRMR in both modes
(``fast=False``, the gammatone and modulation filterbanks by FFT convolution;
``fast=True``, the gammatonegram) with and without ``norm``, on float and on int16
audio, every validation message, and the classes over several batches: their states,
a JAX state dict loaded and updated further, and ``jit_update=True`` against the eager
update. STOI is also held against the float64 transcription of the published
algorithm in ``tests/helpers/stoi_numpy.py``.

Tolerances: STOI and ESTOI within 1e-5 absolute of JAX (and 1e-4 of the float64
transcription, as the JAX package's own tests hold it); SRMR within 1e-4 relative (the
FFT libraries differ); the resample within 1e-5 absolute; integer states exactly.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torchmetrics_tpu.audio as ja  # noqa: E402
import torchmetrics_tpu.functional.audio as jf  # noqa: E402
import torchmetrics_tpu_torch.audio as ta  # noqa: E402
import torchmetrics_tpu_torch.functional.audio as tf  # noqa: E402
from tests.helpers.stoi_numpy import stoi_numpy  # noqa: E402
from torchmetrics_tpu_torch.convert import load_jax_state  # noqa: E402

STOI_ATOL = 1e-5
STOI_F64_ATOL = 1e-4
SRMR_RTOL = 1e-4

# JAX's references jitted, as its own tests run them: one compile a configuration
_jax_stoi = jax.jit(jf.short_time_objective_intelligibility, static_argnums=(2, 3))
_jax_srmr = jax.jit(jf.speech_reverberation_modulation_energy_ratio, static_argnums=(1, 2, 3, 4, 5, 6, 7))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _speech(seed: int, shape: tuple, fs: int, silence: bool = False, noise: float = 0.5):
    """Seeded amplitude-modulated noise (a syllable rate of 4 Hz) and a noisy copy; with
    ``silence`` the first quarter of the clean signal is silent."""
    rng = np.random.RandomState(seed)
    t = np.arange(shape[-1]) / fs
    clean = rng.randn(*shape) * (0.6 + 0.4 * np.sin(2 * np.pi * 4 * t + rng.rand()))
    if silence:
        clean[..., : shape[-1] // 4] = 0.0
    noisy = clean + noise * rng.randn(*shape)
    return noisy.astype(np.float32), clean.astype(np.float32)


def _message(fn, exc) -> str:
    with pytest.raises(exc) as err:
        fn()
    return str(err.value)


# ------------------------------------------------------------------------ STOI


@pytest.mark.parametrize("fs, extended", [(8000, False), (8000, True), (16000, False), (16000, True), (10000, False)])
def test_stoi_equals_jax(fs, extended):
    preds, target = _speech(fs + extended, (2, 8000), fs, silence=True)
    got = tf.short_time_objective_intelligibility(torch.from_numpy(preds), torch.from_numpy(target), fs, extended)
    want = _jax_stoi(jnp.asarray(preds), jnp.asarray(target), fs, extended)
    assert got.shape == (2,) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=STOI_ATOL, rtol=0)
    for row in range(2):
        assert abs(float(got[row]) - stoi_numpy(target[row], preds[row], fs, extended)) < STOI_F64_ATOL


def test_stoi_batch_shapes_and_too_few_frames_equal_jax():
    preds, target = _speech(7, (1, 2, 8000), 8000)
    target[0, 1, 2000:] = 0.0  # fewer than 30 frames survive the VAD: pystoi's 1e-5
    got = tf.short_time_objective_intelligibility(torch.from_numpy(preds), torch.from_numpy(target), 8000)
    want = _jax_stoi(jnp.asarray(preds), jnp.asarray(target), 8000)
    assert tuple(got.shape) == (1, 2) and float(got[0, 1]) == pytest.approx(1e-5)
    np.testing.assert_allclose(_np(got), _np(want), atol=STOI_ATOL, rtol=0)
    # one signal alone gives a scalar, its row's score
    alone = tf.short_time_objective_intelligibility(torch.from_numpy(preds[0, 0]), torch.from_numpy(target[0, 0]), 8000)
    assert alone.shape == () and torch.equal(alone, got[0, 0])


@pytest.mark.parametrize("fs_in, fs_out", [(16000, 10000), (8000, 10000), (48000, 16000)])
def test_resample_poly_equals_jax(fs_in, fs_out):
    from torchmetrics_tpu.functional.audio.stoi import resample_poly as jresample
    from torchmetrics_tpu_torch.functional.audio.stoi import resample_poly as tresample

    x = np.random.RandomState(fs_in).randn(2, 4801).astype(np.float32)
    got, want = tresample(torch.from_numpy(x), fs_in, fs_out), jresample(jnp.asarray(x), fs_in, fs_out)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)


def test_stoi_messages_equal_jax():
    a, b = np.zeros(8000, np.float32), np.zeros(8001, np.float32)
    cases = [((a, b, 16000), {}), ((a, a, 0), {}), ((a[:300], a[:300], 8000), {})]
    for args, kwargs in cases:
        got = _message(lambda: tf.short_time_objective_intelligibility(*args, **kwargs), ValueError)
        assert got == _message(lambda: jf.short_time_objective_intelligibility(*args, **kwargs), ValueError)


def _stoi_batches(seed: int, n: int = 3) -> list:
    return [_speech(seed + i, (2, 8000), 8000, silence=i == 1) for i in range(n)]


@pytest.mark.parametrize("extended", [False, True])
def test_stoi_class_over_batches_equals_jax(extended):
    port = ta.ShortTimeObjectiveIntelligibility(8000, extended, device="cpu")
    jax_metric = ja.ShortTimeObjectiveIntelligibility(8000, extended)
    for preds, target in _stoi_batches(20):
        got = port(torch.from_numpy(preds), torch.from_numpy(target))
        np.testing.assert_allclose(_np(got), _np(jax_metric(jnp.asarray(preds), jnp.asarray(target))),
                                   atol=STOI_ATOL, rtol=0)
    assert port.total.dtype == torch.int32 and int(port.total) == int(jax_metric.total) == 6
    np.testing.assert_allclose(_np(port.compute()), _np(jax_metric.compute()), atol=STOI_ATOL, rtol=0)
    assert port._compute_group_params() == jax_metric._compute_group_params()


def test_a_jax_stoi_state_loaded_into_the_port_goes_on_equal():
    batches = _stoi_batches(30)
    jax_metric = ja.ShortTimeObjectiveIntelligibility(8000)
    jax_metric.update(jnp.asarray(batches[0][0]), jnp.asarray(batches[0][1]))
    port = load_jax_state(ta.ShortTimeObjectiveIntelligibility(8000, device="cpu"),
                          jax_metric.state_dict(persistent_only=False))
    for preds, target in batches[1:]:
        jax_metric.update(jnp.asarray(preds), jnp.asarray(target))
        port.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert int(port.total) == int(jax_metric.total)
    np.testing.assert_allclose(_np(port.compute()), _np(jax_metric.compute()), atol=STOI_ATOL, rtol=0)


def test_a_captured_stoi_update_equals_the_eager_one():
    eager = ta.ShortTimeObjectiveIntelligibility(8000, device="cpu")
    captured = ta.ShortTimeObjectiveIntelligibility(8000, device="cpu", jit_update=True)
    for preds, target in _stoi_batches(40):
        eager.update(torch.from_numpy(preds), torch.from_numpy(target))
        captured.update(torch.from_numpy(preds), torch.from_numpy(target))
    for key in ("sum_score", "total"):
        assert torch.equal(getattr(eager, key), getattr(captured, key))
    info = captured._jitted_update.cache_info()
    assert info["misses"] == 1 and info["hits"] == 2


# ------------------------------------------------------------------------ SRMR


def _srmr_close(got, want) -> None:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=SRMR_RTOL, atol=0)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("fs, n", [(16000, 12000), (8000, 8000)])
def test_srmr_equals_jax(fs, n, norm, fast):
    _, clean = _speech(fs + norm + 2 * fast, (2, n), fs)
    got = tf.speech_reverberation_modulation_energy_ratio(torch.from_numpy(clean), fs, norm=norm, fast=fast)
    _srmr_close(got, _jax_srmr(jnp.asarray(clean), fs, 23, 125, 4, None, norm, fast))


def test_srmr_of_int16_audio_and_1d_input_equals_jax():
    _, clean = _speech(3, (8000,), 8000)
    audio = np.round(clean / np.abs(clean).max() * 20000).astype(np.int16)
    got = tf.speech_reverberation_modulation_energy_ratio(torch.from_numpy(audio), 8000)
    assert tuple(got.shape) == (1,)
    _srmr_close(got, _jax_srmr(audio, 8000, 23, 125, 4, None, False, False))
    loud = clean * 3.0  # peaks above 1 are normalised away
    _srmr_close(tf.speech_reverberation_modulation_energy_ratio(torch.from_numpy(loud), 8000, min_cf=8, max_cf=100),
                _jax_srmr(jnp.asarray(loud), 8000, 23, 125, 8, 100, False, False))


def test_the_srmr_helpers_equal_jax():
    from torchmetrics_tpu.functional.audio import srmr as jsrmr
    from torchmetrics_tpu_torch.functional.audio import srmr as tsrmr

    rng = np.random.RandomState(5)
    for t in (1000, 1001):  # the Hilbert weights of even and odd lengths
        x = rng.randn(2, 3, t).astype(np.float32)
        np.testing.assert_allclose(_np(tsrmr._hilbert_env(torch.from_numpy(x))),
                                   _np(jsrmr._hilbert_env(jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    mod = rng.rand(2, 3, 8, 1500).astype(np.float32)
    for w_length, w_inc, frames in ((256, 64, 20), (103, 26, 54), (512, 128, 1)):
        np.testing.assert_allclose(_np(tsrmr._frame_energies(torch.from_numpy(mod), w_length, w_inc, frames)),
                                   _np(jsrmr._frame_energies(jnp.asarray(mod), w_length, w_inc, frames)),
                                   rtol=1e-5, atol=0)


def test_srmr_messages_equal_jax():
    x = np.zeros(8000, np.float32)
    for kwargs in ({"fs": 0}, {"fs": 8000, "n_cochlear_filters": 0}, {"fs": 8000, "low_freq": -1},
                   {"fs": 8000, "min_cf": 0}, {"fs": 8000, "max_cf": -2}, {"fs": 8000, "norm": 1},
                   {"fs": 8000, "fast": "yes"}):
        got = _message(lambda: tf.speech_reverberation_modulation_energy_ratio(torch.from_numpy(x), **kwargs),
                       ValueError)
        assert got == _message(lambda: jf.speech_reverberation_modulation_energy_ratio(jnp.asarray(x), **kwargs),
                               ValueError)
        assert _message(lambda: ta.SpeechReverberationModulationEnergyRatio(device="cpu", **kwargs),
                        ValueError) == got
    short = np.zeros(40, np.float32)
    got = _message(lambda: tf.speech_reverberation_modulation_energy_ratio(torch.from_numpy(short), 8000, fast=True),
                   ValueError)
    assert got == _message(lambda: jf.speech_reverberation_modulation_energy_ratio(jnp.asarray(short), 8000,
                                                                                   fast=True), ValueError)


@pytest.mark.parametrize("fast", [False, True])
def test_srmr_class_over_batches_equals_jax(fast):
    port = ta.SpeechReverberationModulationEnergyRatio(8000, fast=fast, device="cpu")
    jax_metric = ja.SpeechReverberationModulationEnergyRatio(8000, fast=fast)
    for i in range(3):
        _, clean = _speech(50 + i, (2, 6000), 8000)
        _srmr_close(port(torch.from_numpy(clean)), jax_metric(jnp.asarray(clean)))
    assert int(port.total) == int(jax_metric.total) == 6
    _srmr_close(port.compute(), jax_metric.compute())
    assert port._compute_group_params() == jax_metric._compute_group_params()


def test_srmr_clamps_k_star_to_5_where_the_reference_raises():
    """A 130 Hz tone, its energy in cochlear channels whose ERB stays below the 5th
    modulation band's left cutoff at ``min_cf=40``: the upstream reference raises, JAX and
    the port clamp K* to 5 and agree."""
    from torchmetrics_tpu_torch.functional.audio import srmr as tsrmr

    fs = 8000
    t = np.arange(fs) / fs
    tone = (np.sin(2 * np.pi * 130 * t) * (1 + 0.5 * np.sin(2 * np.pi * 60 * t))).astype(np.float32)
    centres = tsrmr._centre_freqs(fs, 23, 125.0)
    cutoff_5 = tsrmr._modulation_fir(fs, 40.0, 128.0)[1][4]
    assert tsrmr._erbs(fs, 23, 125.0)[centres < 300].max() < cutoff_5
    _srmr_close(tf.speech_reverberation_modulation_energy_ratio(torch.from_numpy(tone), fs, min_cf=40),
                jf.speech_reverberation_modulation_energy_ratio(jnp.asarray(tone), fs, min_cf=40))
