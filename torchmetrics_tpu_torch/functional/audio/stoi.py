"""Native STOI and ESTOI.

Counterpart of ``torchmetrics_tpu/functional/audio/stoi.py``: the JAX package's
static-shape algorithm (STOI, Taal et al. 2011; ESTOI, Jensen & Taal 2016) with a
leading batch axis where JAX maps the core over the batch:

1. polyphase resample to 10 kHz: scipy's ``firwin`` designs the filter on the host
   (cached, and copied to each device once); the zero-stuffed signal goes through one
   strided convolution, a depthwise one on the card (``functional/image/utils.py``'s
   ``_conv2d``), so no cuDNN algorithm and no TF32 touches it;
2. the 40 dB VAD on the clean signal: the kept frames are compacted by a scatter-add
   at their cumulative positions, so no shape depends on the data;
3. the 512-point STFT and the one-third-octave band energies, one full-float32 product
   (``utils/compute._matmul_full_float32``);
4. the 30-frame segments' clipped correlations (STOI) or row- and column-normalised
   inner products (ESTOI), averaged over the valid segments.

No step reads a value back to the host, so an update captures into a CUDA graph.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from torchmetrics_tpu_torch.functional.image.utils import _conv2d, _on_device
from torchmetrics_tpu_torch.utils.compute import _matmul_full_float32

Tensor = torch.Tensor

_FS = 10000
_N_FRAME = 256
_HOP = _N_FRAME // 2
_NFFT = 512
_NUM_BANDS = 15
_MIN_FREQ = 150.0
_N_SEG = 30  # 384 ms
_BETA = -15.0  # lower SDR bound (dB)
_DYN_RANGE = 40.0  # VAD dynamic range (dB)
_EPS = np.finfo(np.float32).eps


@functools.lru_cache(maxsize=None)
def _hann_window(framelen: int) -> np.ndarray:
    """pystoi's window: hanning(N+2) with the zero endpoints dropped."""
    return np.hanning(framelen + 2)[1:-1].astype(np.float32)


@functools.lru_cache(maxsize=None)
def _third_octave_matrix(fs: int, nfft: int, num_bands: int, min_freq: float) -> np.ndarray:
    """One-third-octave band matrix (num_bands, nfft//2+1): 0/1 rows selecting the
    rfft bins between each band's lower and upper edge (edges snapped to the nearest
    bin, as in the published MATLAB/pystoi construction)."""
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands, dtype=np.float64)
    freq_low = min_freq * np.power(2.0, (2 * k - 1) / 6)
    freq_high = min_freq * np.power(2.0, (2 * k + 1) / 6)
    obm = np.zeros((num_bands, len(f)), dtype=np.float32)
    for i in range(num_bands):
        lo = int(np.argmin(np.square(f - freq_low[i])))
        hi = int(np.argmin(np.square(f - freq_high[i])))
        obm[i, lo:hi] = 1.0
    return obm


@functools.lru_cache(maxsize=None)
def _resample_filter(up: int, down: int) -> np.ndarray:
    """Kaiser-windowed FIR for polyphase resampling (scipy.signal.resample_poly's
    default design: numtaps = 20*max(up,down)+1, cutoff 1/max, kaiser beta 5.0)."""
    from scipy.signal import firwin

    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = firwin(2 * half_len + 1, 1.0 / max_rate, window=("kaiser", 5.0))
    return (h * up).astype(np.float32)


def resample_poly(x: Tensor, fs_in: int, fs_out: int) -> Tensor:
    """Polyphase resample (B, T) -> (B, ceil(T*up/down)) by one strided convolution of
    the zero-stuffed signal.

    Shared by STOI (to 10 kHz) and, once ported, DNSMOS (to 16 kHz).
    """
    g = math.gcd(fs_out, fs_in)
    up, down = fs_out // g, fs_in // g
    h = _on_device(_resample_filter, (up, down), x.device)
    taps = h.shape[0]
    batch, n_in = x.shape
    n_out = -(-n_in * up // down)
    # the full convolution of the zero-stuffed signal starts at pad (taps-1); sampling the
    # centred output lattice, offset (taps-1)//2, with stride `down` gives
    # scipy.signal.upfirdn's trimmed output
    offset = (taps - 1) // 2
    pad_left = taps - 1 - offset
    dilated_len = (n_in - 1) * up + 1
    pad_right = max(0, (n_out - 1) * down + taps - dilated_len - pad_left)
    stuffed = x.new_zeros(batch, pad_left + dilated_len + pad_right)
    stuffed[:, pad_left : pad_left + dilated_len : up] = x
    out = _conv2d(stuffed[:, None, None, :], h.reshape(1, 1, 1, taps), stride=(1, down))
    return out[:, 0, 0, :n_out]


def _frames(x: Tensor, framelen: int, hop: int, n_frames: int) -> Tensor:
    """(B, T) -> (B, n_frames, framelen) sliding windows at ``hop``."""
    return x.unfold(-1, framelen, hop)[:, :n_frames]


def _remove_silent_frames(x: Tensor, y: Tensor, framelen: int, hop: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Static-shape VAD compaction (pystoi ``utils.remove_silent_frames``), per row.

    Frames of the *clean* signal ``x`` whose energy is within 40 dB of the row's loudest
    frame are kept; both signals are rebuilt by overlap-adding the kept windowed frames
    contiguously. Returns ``(x_sil, y_sil, n_kept)``: buffers of the worst-case length,
    of which the first ``(n_kept-1)*hop + framelen`` samples of a row are meaningful.
    """
    batch, length = x.shape
    n_frames = max(1, -(-(length - framelen) // hop))
    w = _on_device(_hann_window, (framelen,), x.device)
    x_frames = _frames(x, framelen, hop, n_frames) * w
    y_frames = _frames(y, framelen, hop, n_frames) * w

    energies = 20.0 * torch.log10(torch.linalg.vector_norm(x_frames, dim=-1) + _EPS)
    mask = energies > (energies.amax(dim=-1, keepdim=True) - _DYN_RANGE)
    n_kept = mask.sum(dim=-1)

    # compact the kept frames to the front: frame j overlap-adds at slot cumsum(mask)-1
    pos = torch.clamp(torch.cumsum(mask, dim=-1) - 1, min=0)
    idx = (pos[..., None] * hop + torch.arange(framelen, device=x.device)).reshape(batch, -1)
    buf_len = (n_frames - 1) * hop + framelen
    maskf = mask[..., None].to(x_frames.dtype)
    x_sil = x.new_zeros(batch, buf_len).scatter_add_(1, idx, (x_frames * maskf).reshape(batch, -1))
    y_sil = y.new_zeros(batch, buf_len).scatter_add_(1, idx, (y_frames * maskf).reshape(batch, -1))
    return x_sil, y_sil, n_kept


def _stft_tob(x: Tensor, n_frames: int, obm_t: Tensor) -> Tensor:
    """Windowed 512-point rfft over 256/128 frames, then the square root of the band
    energies: (B, T) -> (B, num_bands, n_frames)."""
    w = _on_device(_hann_window, (_N_FRAME,), x.device)
    spec = torch.fft.rfft(_frames(x, _N_FRAME, _HOP, n_frames) * w, n=_NFFT, dim=-1)  # (B, M, 257)
    power = spec.real**2 + spec.imag**2
    return torch.sqrt(_matmul_full_float32(power, obm_t)).transpose(1, 2)


def _segment_windows(tob: Tensor, n_segments: int) -> Tensor:
    """(B, J, M) -> (B, n_segments, J, N_SEG) sliding 30-frame segments (stride 1).
    A row of fewer than 30 frames is padded with zeros: its segments are all invalid."""
    short = _N_SEG - tob.shape[-1]
    if short > 0:
        tob = torch.nn.functional.pad(tob, (0, short))
    return tob.unfold(-1, _N_SEG, 1)[:, :, :n_segments].transpose(1, 2)


def _stoi_core(x10k: Tensor, y10k: Tensor, extended: bool) -> Tensor:
    """STOI of each row of a pair of (B, T) 10 kHz signals (static shapes throughout)."""
    x_sil, y_sil, n_kept = _remove_silent_frames(x10k, y10k, _N_FRAME, _HOP)

    # the compacted signal of k kept frames spans (k-1)*hop + framelen samples and
    # therefore yields exactly k-1 STFT frames; frames past that hold zeros
    n_frames_max = max(1, -(-(x_sil.shape[-1] - _N_FRAME) // _HOP))
    obm = _on_device(_third_octave_matrix, (_FS, _NFFT, _NUM_BANDS, _MIN_FREQ), x10k.device)
    x_tob = _stft_tob(x_sil, n_frames_max, obm.T)
    y_tob = _stft_tob(y_sil, n_frames_max, obm.T)

    n_segments_max = max(1, n_frames_max - _N_SEG + 1)
    x_seg = _segment_windows(x_tob, n_segments_max)  # (B, S, J, N)
    y_seg = _segment_windows(y_tob, n_segments_max)

    # segment s uses frames [s, s+N); all must be < the n_kept-1 valid frames
    n_valid_frames = n_kept - 1
    seg_valid = (torch.arange(n_segments_max, device=x10k.device) + _N_SEG) <= n_valid_frames[:, None]
    n_valid_seg = seg_valid.sum(dim=-1)

    def norm(v: Tensor, dim: int) -> Tensor:
        return torch.linalg.vector_norm(v, dim=dim, keepdim=True)

    if not extended:
        # per-(segment, band) clipped correlation over the 30-frame time axis
        norm_const = norm(x_seg, -1) / (norm(y_seg, -1) + _EPS)
        y_prime = torch.minimum(y_seg * norm_const, x_seg * (1 + 10 ** (-_BETA / 20)))
        xc = x_seg - torch.mean(x_seg, dim=-1, keepdim=True)
        yc = y_prime - torch.mean(y_prime, dim=-1, keepdim=True)
        xc = xc / (norm(xc, -1) + _EPS)
        yc = yc / (norm(yc, -1) + _EPS)
        corr = torch.sum(xc * yc, dim=-1)  # (B, S, J)
        d_sum = torch.sum(torch.where(seg_valid[..., None], corr, 0.0), dim=(1, 2))
        denom = _NUM_BANDS * torch.clamp(n_valid_seg, min=1)
    else:
        # ESTOI: normalise each band's time series (rows), then each frame's band
        # vector (columns), inner-product per segment / N
        def row_col_normalize(seg: Tensor) -> Tensor:
            rn = seg - torch.mean(seg, dim=-1, keepdim=True)
            rn = rn / (norm(rn, -1) + _EPS)
            cn = rn - torch.mean(rn, dim=2, keepdim=True)
            return cn / (norm(cn, 2) + _EPS)

        d_seg = torch.sum(row_col_normalize(x_seg) * row_col_normalize(y_seg), dim=(2, 3)) / _N_SEG  # (B, S)
        d_sum = torch.sum(torch.where(seg_valid, d_seg, 0.0), dim=-1)
        denom = torch.clamp(n_valid_seg, min=1)

    d = d_sum / denom
    # pystoi's degenerate-input behaviour: too few non-silent frames -> 1e-5
    return torch.where(n_valid_seg > 0, d, 1e-5)


def short_time_objective_intelligibility(
    preds: Tensor,
    target: Tensor,
    fs: int,
    extended: bool = False,
    keep_same_device: bool = False,
) -> Tensor:
    """Compute STOI (or ESTOI with ``extended=True``) on the inputs' device.

    ``keep_same_device`` is accepted for signature parity; the result is on the
    inputs' device either way.

    Args:
        preds: processed/degraded speech, shape ``(..., time)``.
        target: clean reference speech, same shape.
        fs: sampling rate of the input signals (resampled to 10 kHz internally).
        extended: compute ESTOI instead of STOI.
        keep_same_device: accepted for reference-signature parity.

    Returns:
        STOI value(s) with shape ``preds.shape[:-1]``.

    Example:
        >>> import torch
        >>> from torchmetrics_tpu_torch.functional.audio import short_time_objective_intelligibility
        >>> speech = torch.randn(8000, generator=torch.Generator().manual_seed(0))
        >>> float(short_time_objective_intelligibility(speech, speech, fs=10000)) > 0.999
        True
    """
    preds = torch.as_tensor(preds).to(torch.float32)
    target = torch.as_tensor(target).to(device=preds.device, dtype=torch.float32)
    if preds.shape != target.shape:
        raise ValueError(
            "Expected `preds` and `target` to have the same shape, but got"
            f" {tuple(preds.shape)} and {tuple(target.shape)}."
        )
    if fs <= 0:
        raise ValueError(f"Expected argument `fs` to be a positive integer, but got {fs}")
    batch_shape = preds.shape[:-1]
    n = int(np.prod(batch_shape)) if batch_shape else 1
    x = target.reshape(n, -1)
    y = preds.reshape(n, -1)
    if fs != _FS:
        x = resample_poly(x, fs, _FS)
        y = resample_poly(y, fs, _FS)
    if x.shape[-1] < _N_FRAME + _HOP:
        raise ValueError(
            "Signals are too short to compute STOI: need at least"
            f" {int(np.ceil((_N_FRAME + _HOP) * fs / _FS))} samples at fs={fs}, got {preds.shape[-1]}."
        )
    out = _stoi_core(x, y, extended)
    return out.reshape(batch_shape) if batch_shape else out[0]
