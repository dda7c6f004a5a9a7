"""Native SRMR (speech-to-reverberation modulation energy ratio).

Counterpart of ``torchmetrics_tpu/functional/audio/srmr.py``, the JAX package's
redesign of the published algorithm (Falk, Zheng & Chan, IEEE TASLP 2010):

1. **Filter design on the host** (float64 numpy and scipy, cached): the Slaney ERB
   gammatone cascade and the 8-channel Q=2 modulation bank, each IIR materialised as
   its impulse response and truncated where the tail energy falls below 1e-12.
2. **Filtering as batched FFT convolution** (``torch.fft``): the filters' transforms
   are computed on the host and kept per (design, FFT length, device), made at the
   first call outside a CUDA graph capture.
3. The Hilbert envelope by FFT; the Hamming-windowed energies of each modulation band
   as one full-float32 product of the squared signal's blocks with the window's
   (``utils/compute._matmul_full_float32``: no convolution, so no cuDNN and no TF32);
   the adaptive upper band K* chosen branch-free.

``fast=True`` is the gammatonegram approximation: a magnitude spectrogram weighted by
the gammatone responses at a 400 Hz envelope rate. Where the reference raises because
the 90 % bandwidth falls below the 5th modulation band's left cutoff, K* clamps to 5,
as in the JAX package. Integer input scales by its dtype's largest value.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.image.utils import _on_device
from torchmetrics_tpu_torch.utils.compute import _matmul_full_float32

Tensor = torch.Tensor

_EAR_Q = 9.26449  # Glasberg & Moore parameters (as the reference's _calc_erbs)
_MIN_BW = 24.7
_TAIL_ENERGY = 1e-12  # impulse-response truncation threshold (fraction of total)


def _centre_freqs(fs: int, n_filters: int, cutoff: float) -> np.ndarray:
    """Slaney ERB-spaced centre frequencies, descending from ~fs/2 to ``cutoff``."""
    c = _EAR_Q * _MIN_BW
    return -c + np.exp(
        np.arange(1, n_filters + 1) * (-np.log(fs / 2 + c) + np.log(cutoff + c)) / n_filters
    ) * (fs / 2 + c)


def _erbs(fs: int, n_filters: int, low_freq: float) -> np.ndarray:
    """Equivalent rectangular bandwidths of the cochlear channels (descending)."""
    return _centre_freqs(fs, n_filters, low_freq) / _EAR_Q + _MIN_BW


def _np_biquad(b: np.ndarray, a: np.ndarray, x: np.ndarray) -> np.ndarray:
    from scipy.signal import lfilter

    return lfilter(b, a, x)


def _trim_impulse(h: np.ndarray) -> np.ndarray:
    """Truncate where the remaining tail energy < _TAIL_ENERGY of the total."""
    tail = np.cumsum((h**2)[:, ::-1], axis=-1)[:, ::-1]
    total = tail[:, :1]
    mask = tail < _TAIL_ENERGY * total
    # a row whose tail never decays below the threshold keeps its full length
    keep_i = np.where(mask.any(-1), np.argmax(mask, -1), h.shape[-1])
    keep = max(int(np.max(keep_i)), 16)
    return h[:, : math.ceil(keep / 16) * 16]


def _slaney_coefs(fs: int, n_filters: int, low_freq: float) -> dict:
    """Slaney ERB gammatone pole/zero/gain coefficients, shared by the FIR cascade and
    the FFT weights of the fast path."""
    cfs = _centre_freqs(fs, n_filters, low_freq)
    T = 1.0 / fs
    B = 1.019 * 2 * np.pi * _erbs(fs, n_filters, low_freq)
    arg = 2 * cfs * np.pi * T
    ebt = np.exp(B * T)
    rt_pos = np.sqrt(3 + 2**1.5)
    rt_neg = np.sqrt(3 - 2**1.5)
    a11 = -(2 * T * np.cos(arg) / ebt + 2 * rt_pos * T * np.sin(arg) / ebt) / 2
    a12 = -(2 * T * np.cos(arg) / ebt - 2 * rt_pos * T * np.sin(arg) / ebt) / 2
    a13 = -(2 * T * np.cos(arg) / ebt + 2 * rt_neg * T * np.sin(arg) / ebt) / 2
    a14 = -(2 * T * np.cos(arg) / ebt - 2 * rt_neg * T * np.sin(arg) / ebt) / 2
    z = np.exp(4j * cfs * np.pi * T)
    zb = np.exp(-(B * T) + 2j * cfs * np.pi * T)
    gain = np.abs(
        (-2 * z * T + 2 * zb * T * (np.cos(arg) - rt_neg * np.sin(arg)))
        * (-2 * z * T + 2 * zb * T * (np.cos(arg) + rt_neg * np.sin(arg)))
        * (-2 * z * T + 2 * zb * T * (np.cos(arg) - rt_pos * np.sin(arg)))
        * (-2 * z * T + 2 * zb * T * (np.cos(arg) + rt_pos * np.sin(arg)))
        / (-2 / np.exp(2 * B * T) - 2 * z + 2 * (1 + z) / ebt) ** 4
    )
    return {
        "cfs": cfs, "T": T, "B": B, "arg": arg, "ebt": ebt,
        "a11": a11, "a12": a12, "a13": a13, "a14": a14, "gain": gain,
    }


@functools.lru_cache(maxsize=32)
def _gammatone_fir(fs: int, n_filters: int, low_freq: float) -> np.ndarray:
    """Impulse responses [n_filters, L] of the Slaney ERB gammatone cascade (4 biquad
    sections sharing one denominator, divided by the analytic gain)."""
    c = _slaney_coefs(fs, n_filters, low_freq)
    T, B, arg, ebt = c["T"], c["B"], c["arg"], c["ebt"]
    a11, a12, a13, a14, gain = c["a11"], c["a12"], c["a13"], c["a14"], c["gain"]
    a0, a2 = T, 0.0
    b0, b1, b2 = 1.0, -2 * np.cos(arg) / ebt, np.exp(-2 * B * T)
    length = max(int(0.25 * fs), 64)
    impulse = np.zeros(length, dtype=np.float64)
    impulse[0] = 1.0
    h = np.empty((n_filters, length), dtype=np.float64)
    for k in range(n_filters):
        a = np.array([b0, b1[k], b2[k]])
        y = _np_biquad(np.array([a0, a11[k], a2]), a, impulse)
        y = _np_biquad(np.array([a0, a12[k], a2]), a, y)
        y = _np_biquad(np.array([a0, a13[k], a2]), a, y)
        y = _np_biquad(np.array([a0, a14[k], a2]), a, y)
        h[k] = y / gain[k]
    return _trim_impulse(h).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _modulation_fir(mfs: int, min_cf: float, max_cf: float, n: int = 8, q: int = 2) -> Tuple[np.ndarray, np.ndarray]:
    """(impulse responses [n, L], left 3 dB cutoffs [n]) of the modulation bank: a
    second-order bandpass bank with Q=2 and log-spaced centre frequencies."""
    spacing = (max_cf / min_cf) ** (1.0 / (n - 1))
    cfs = min_cf * spacing ** np.arange(n, dtype=np.float64)
    w0 = 2 * np.pi * cfs / mfs
    W0 = np.tan(w0 / 2)
    b0 = W0 / q
    # impulse length: the narrowest (lowest-cf) filter decays slowest; size for it
    decay = np.min(b0 / (1 + b0 + W0**2))  # ~pole-radius deficit per sample
    length = max(int(np.log(1e7) / max(decay, 1e-9)), 64)
    impulse = np.zeros(length, dtype=np.float64)
    impulse[0] = 1.0
    h = np.empty((n, length), dtype=np.float64)
    for k in range(n):
        b = np.array([b0[k], 0.0, -b0[k]])
        a = np.array([1 + b0[k] + W0[k] ** 2, 2 * W0[k] ** 2 - 2, 1 - b0[k] + W0[k] ** 2])
        h[k] = _np_biquad(b, a, impulse)
    cutoffs_left = cfs - b0 * mfs / (2 * np.pi)
    return _trim_impulse(h).astype(np.float32), cutoffs_left


@functools.lru_cache(maxsize=32)
def _fft_gt_weights(fs: int, nfft: int, n_filters: int, low_freq: float) -> np.ndarray:
    """FFT-bin gammatone weighting matrix [n_filters, nfft//2 + 1] (Ellis 2009): the
    4th-order gammatone magnitude response sampled on the rfft bin circle."""
    c = _slaney_coefs(fs, n_filters, low_freq)
    T, B, arg, gain = c["T"], c["B"], c["arg"], c["gain"]
    r = np.exp(-B * T)
    pole = (r * np.exp(1j * arg))[:, None]  # [N, 1]
    zros = -np.stack([c["a11"], c["a12"], c["a13"], c["a14"]]) / T  # [4, N]
    ucirc = np.exp(2j * np.pi * np.arange(nfft // 2 + 1) / nfft)[None, :]  # [1, bins]
    wts = (T**4 / gain[:, None]) * np.abs(ucirc - zros[0][:, None]) * np.abs(ucirc - zros[1][:, None]) \
        * np.abs(ucirc - zros[2][:, None]) * np.abs(ucirc - zros[3][:, None]) \
        * np.abs((pole - ucirc) * (pole.conj() - ucirc)) ** (-4.0)
    return wts.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _matlab_hanning(n: int) -> np.ndarray:
    """MATLAB's hanning(n): symmetric, endpoints dropped — what specgram uses."""
    return np.hanning(n + 2)[1:-1].astype(np.float32)


@functools.lru_cache(maxsize=None)
def _hilbert_weight(n: int) -> np.ndarray:
    """The analytic signal's spectral weights for an ``n``-point FFT."""
    weight = np.zeros(n, dtype=np.float32)
    if n % 2 == 0:
        weight[0] = weight[n // 2] = 1
        weight[1 : n // 2] = 2
    else:
        weight[0] = 1
        weight[1 : (n + 1) // 2] = 2
    return weight


@functools.lru_cache(maxsize=None)
def _energy_window(w_length: int, w_inc: int) -> np.ndarray:
    """The squared periodic Hamming window cut into rows of gcd(w_length, w_inc) taps."""
    w2 = (np.hamming(w_length + 1)[:-1] ** 2).astype(np.float32)
    return w2.reshape(-1, math.gcd(w_length, w_inc))


@functools.lru_cache(maxsize=None)
def _ascending_erbs(fs: int, n_filters: int, low_freq: float) -> np.ndarray:
    return np.ascontiguousarray(_erbs(fs, n_filters, low_freq)[::-1]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _upper_cutoffs(mfs: int, min_cf: float, max_cf: float) -> np.ndarray:
    """The left cutoffs of modulation bands 6 to 8, which K* is chosen against."""
    return _modulation_fir(mfs, min_cf, max_cf)[1][5:8].astype(np.float32)


def _fft_gtgram(x: Tensor, fs: int, n_filters: int, low_freq: float) -> Tensor:
    """[B, T] -> gammatonegram envelope [B, n_filters, frames] at 400 Hz: a magnitude
    spectrogram (10 ms window, 2.5 ms hop) weighted by :func:`_fft_gt_weights`."""
    window_time, hop_time = 0.010, 0.0025
    nfft = int(2 ** np.ceil(np.log2(2 * window_time * fs)))
    nwin = int(round(window_time * fs))
    nhop = int(round(hop_time * fs))
    t = x.shape[-1]
    if t < nwin:
        raise ValueError(
            f"SRMR fast=True needs at least one {window_time * 1e3:.0f} ms spectrogram window"
            f" ({nwin} samples at fs={fs}), got {t} samples"
        )
    n_frames = (t - (nwin - nhop)) // nhop
    frames = x.unfold(-1, nwin, nhop)[:, :n_frames] * _on_device(_matlab_hanning, (nwin,), x.device)
    mag = torch.abs(torch.fft.rfft(frames, n=nfft, dim=-1))  # [B, frames, bins]
    wts = _on_device(_fft_gt_weights, (fs, nfft, n_filters, float(low_freq)), x.device)
    return _matmul_full_float32(mag, wts.T).transpose(1, 2) / nfft


_HF_CACHE: Dict[tuple, Tensor] = {}  # (design, fft length, device) -> the filters' rfft there


def _fft_conv(x: Tensor, h: np.ndarray, cache_key: tuple) -> Tensor:
    """Causal FFT convolution of ``x [..., T]`` with a filter bank ``h [F, L]``.

    Returns ``[..., F, T]``: the first T samples of the full convolution, what a
    recursive ``lfilter`` pass would produce. The filter bank's transform is computed
    on the host and kept per (design, FFT length, device); it is made outside a CUDA
    graph capture, whose warm run comes first.
    """
    t = x.shape[-1]
    n = 1 << ((t + h.shape[-1] - 1) - 1).bit_length()
    key = (cache_key, n, x.device)
    hf = _HF_CACHE.get(key)
    if hf is None:
        if x.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"SRMR: the filter transform {key} must be made before a CUDA graph capture")
        hf = torch.from_numpy(np.fft.rfft(np.asarray(h, dtype=np.float64), n=n).astype(np.complex64)).to(x.device)
        _HF_CACHE[key] = hf
    xf = torch.fft.rfft(x[..., None, :], n=n)
    return torch.fft.irfft(xf * hf, n=n)[..., :t]


def _hilbert_env(x: Tensor) -> Tensor:
    """|analytic signal| along the last axis."""
    t = x.shape[-1]
    n = math.ceil(t / 16) * 16
    xf = torch.fft.fft(x, n=n, dim=-1)
    weight = _on_device(_hilbert_weight, (n,), x.device)
    return torch.abs(torch.fft.ifft(xf * weight, dim=-1)[..., :t])


def _frame_energies(mod: Tensor, w_length: int, w_inc: int, num_frames: int) -> Tensor:
    """Hamming-windowed energies ``sum((frame * w)^2)`` of the first ``num_frames``
    frames (stride ``w_inc``, zeros past the end) of ``mod [..., T]``.

    Each frame's sum is ``sum(mod^2 * w^2)``. With g = gcd(w_length, w_inc), the squared
    signal's blocks of g samples times the window's blocks of g taps is one product
    ``P[block, k]``; frame f adds ``P[f*w_inc/g + k, k]`` over the window's blocks k.
    """
    g = math.gcd(w_length, w_inc)
    span = (num_frames - 1) * w_inc + w_length
    sq = mod**2
    t = sq.shape[-1]
    sq = torch.nn.functional.pad(sq, (0, span - t)) if span > t else sq[..., :span]
    w2 = _on_device(_energy_window, (w_length, w_inc), mod.device)  # [w_length/g, g]
    part = _matmul_full_float32(sq.reshape(*sq.shape[:-1], span // g, g), w2.T)  # [..., blocks, w_length/g]
    k = torch.arange(w2.shape[0], device=mod.device)
    rows = torch.arange(num_frames, device=mod.device)[:, None] * (w_inc // g) + k
    return part[..., rows, k].sum(dim=-1)


def _normalize_energy(energy: Tensor, drange: float = 30.0) -> Tensor:
    """Clamp energies into a 30 dB dynamic range below the mean-channel peak."""
    peak = torch.amax(torch.mean(energy, dim=1, keepdim=True), dim=(2, 3), keepdim=True)
    floor = peak * 10.0 ** (-drange / 10.0)
    return torch.minimum(torch.maximum(energy, floor), peak)


def _srmr_arg_validate(fs, n_cochlear_filters, low_freq, min_cf, max_cf, norm, fast) -> None:
    """The JAX package's argument checks and messages."""
    if not (isinstance(fs, int) and fs > 0):
        raise ValueError(f"Expected argument `fs` to be an int larger than 0, but got {fs}")
    if not (isinstance(n_cochlear_filters, int) and n_cochlear_filters > 0):
        raise ValueError(
            f"Expected argument `n_cochlear_filters` to be an int larger than 0, but got {n_cochlear_filters}"
        )
    if not (isinstance(low_freq, (float, int)) and low_freq > 0):
        raise ValueError(f"Expected argument `low_freq` to be a float larger than 0, but got {low_freq}")
    if not (isinstance(min_cf, (float, int)) and min_cf > 0):
        raise ValueError(f"Expected argument `min_cf` to be a float larger than 0, but got {min_cf}")
    if max_cf is not None and not (isinstance(max_cf, (float, int)) and max_cf > 0):
        raise ValueError(f"Expected argument `max_cf` to be a float larger than 0, but got {max_cf}")
    if not isinstance(norm, bool):
        raise ValueError("Expected argument `norm` to be a bool value")
    if not isinstance(fast, bool):
        raise ValueError("Expected argument `fast` to be a bool value")


def speech_reverberation_modulation_energy_ratio(
    preds: Tensor,
    fs: int,
    n_cochlear_filters: int = 23,
    low_freq: float = 125,
    min_cf: float = 4,
    max_cf: Optional[float] = None,
    norm: bool = False,
    fast: bool = False,
) -> Tensor:
    """Speech-to-reverberation modulation energy ratio, on the input's device.

    Args:
        preds: shape ``(..., time)``
        fs: sampling rate
        n_cochlear_filters: number of gammatone channels
        low_freq: lowest gammatone centre frequency
        min_cf: centre frequency of the first modulation filter
        max_cf: centre frequency of the last modulation filter; defaults to 30 Hz
            when ``norm`` else 128 Hz (as the reference)
        norm: clamp modulation energies into a 30 dB dynamic range
        fast: use the gammatonegram envelope approximation (400 Hz envelope rate,
            spectrogram and weights product) instead of the full filterbank

    Returns:
        SRMR value(s) with shape ``(...)`` (shape ``(1,)`` for 1-D input, as the
        reference).

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.audio import speech_reverberation_modulation_energy_ratio
        >>> preds = torch.randn(8000, generator=torch.Generator().manual_seed(0))
        >>> score = speech_reverberation_modulation_energy_ratio(preds, 8000)
        >>> score.shape == (1,) and bool(score > 0)
        True
    """
    _srmr_arg_validate(fs, n_cochlear_filters, low_freq, min_cf, max_cf, norm, fast)
    if max_cf is None:
        max_cf = 30 if norm else 128
    preds = torch.as_tensor(preds)
    shape = preds.shape
    x = preds.reshape(1, -1) if preds.ndim == 1 else preds.reshape(-1, shape[-1])
    if not (x.is_floating_point() or x.is_complex() or x.dtype == torch.bool):
        x = x.to(torch.float32) / float(torch.iinfo(preds.dtype).max)
    x = x.to(torch.float32)
    # normalize into [-1, 1]
    max_vals = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    x = x / torch.where(max_vals > 1, max_vals, 1.0)

    if fast:
        # the gammatonegram envelope at 400 Hz: one rfft and one product
        mfs = 400
        gt_env = _fft_gtgram(x, fs, n_cochlear_filters, float(low_freq))
    else:
        mfs = fs
        gt_key = ("gt", fs, n_cochlear_filters, float(low_freq))
        gt_env = _hilbert_env(_fft_conv(x, _gammatone_fir(fs, n_cochlear_filters, float(low_freq)), gt_key))

    time = gt_env.shape[-1]
    w_length = math.ceil(0.256 * mfs)
    w_inc = math.ceil(0.064 * mfs)
    mod_fir, _ = _modulation_fir(mfs, float(min_cf), float(max_cf))
    mod_out = _fft_conv(gt_env, mod_fir, ("mod", mfs, float(min_cf), float(max_cf)))  # [B, N, 8, time]

    num_frames = max(int(1 + (time - w_length) // w_inc), 1)
    energy = _frame_energies(mod_out, w_length, w_inc, num_frames)
    if norm:
        energy = _normalize_energy(energy)

    avg_energy = torch.mean(energy, dim=-1)  # [B, N, 8]
    total_energy = torch.sum(avg_energy, dim=(1, 2))
    ac_energy = torch.sum(avg_energy, dim=2)  # [B, N]
    ac_perc = ac_energy * 100 / torch.clamp(total_energy[:, None], min=1e-20)
    # the 90 % cumulative-energy bandwidth, counted from the lowest cochlear channel
    cum = torch.cumsum(torch.flip(ac_perc, dims=(-1,)), dim=-1)
    k90_idx = torch.argmax((cum > 90).to(torch.int32), dim=-1)
    bw = _on_device(_ascending_erbs, (fs, n_cochlear_filters, float(low_freq)), x.device)[k90_idx]
    # adaptive upper band K*: 5..8 by which left cutoff the bandwidth reaches
    # (branch-free; where the reference raises, bw below cutoffs[4], K* clamps to 5)
    cutoffs = _on_device(_upper_cutoffs, (mfs, float(min_cf), float(max_cf)), x.device)
    kstar = 5 + (bw[:, None] >= cutoffs).sum(dim=-1)
    band = torch.arange(8, device=x.device)
    denom_mask = (band[None, :] >= 4) & (band[None, :] < kstar[:, None])
    numerator = torch.sum(avg_energy[:, :, :4], dim=(1, 2))
    denominator = torch.sum(avg_energy * denom_mask[:, None, :], dim=(1, 2))
    score = numerator / torch.clamp(denominator, min=1e-20)
    return score.reshape(shape[:-1]) if len(shape) > 1 else score
