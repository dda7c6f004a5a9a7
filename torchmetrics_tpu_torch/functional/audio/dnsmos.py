"""DNSMOS computed on the device from converted ONNX checkpoints.

Counterpart of ``torchmetrics_tpu/functional/audio/dnsmos.py``. The DNS-challenge
ONNX checkpoints run through the port's executor (``convert/onnx_torch.py``), an
``nn.Module`` per graph; the mel spectrogram (n_fft=321, hop=160, 120 slaney-normed
mel bands, power-to-dB with the reference max of each hop's batch and (dB+40)/40
scaling) is a reflect pad, framing, a periodic Hann window, an rfft and one
full-float32 product with the filterbank, which is built in float64 on the host as
JAX builds it; all hops of all batch rows run as one batched forward per model; the
polynomial calibration runs in float64 on the host.

Model discovery: ``$TORCHMETRICS_TPU_DNSMOS_DIR`` or ``<repo>/weights/dnsmos``, holding
converted directories (``model_v8``, ``sig_bak_ovr``, ``p_sig_bak_ovr``, in the format
both packages write) or the raw ``.onnx`` drops (the reference layout
``DNSMOS/model_v8.onnx``, ``DNSMOS/sig_bak_ovr.onnx``, ``pDNSMOS/sig_bak_ovr.onnx`` is
accepted too), which convert on first use.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Union

import numpy as np
import torch

from torchmetrics_tpu_torch.utils.compute import _matmul_full_float32

Tensor = torch.Tensor

SAMPLING_RATE = 16000
INPUT_LENGTH = 9.01  # seconds per scored segment (reference dnsmos.py:37)
_N_FFT = 321
_HOP = 160
_N_MELS = 120


# ------------------------------------------------------------- mel spectrogram
def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney mel scale (linear below 1 kHz, log above) — librosa's default."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    above = f >= min_log_hz
    return np.where(above, min_log_hz / f_sp + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep, mel)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


@functools.lru_cache(maxsize=8)
def _mel_filterbank(sr: int, n_fft: int, n_mels: int) -> np.ndarray:
    """[n_mels, 1 + n_fft//2] triangular slaney-normalized filterbank, on the rfft bin
    grid ``k * sr / n_fft`` (librosa's), built in float64 and rounded to float32."""
    fftfreqs = np.fft.rfftfreq(n_fft, 1.0 / sr)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1][:, None]
    upper = ramps[2:] / fdiff[1:][:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])  # slaney area norm
    return (weights * enorm[:, None]).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _hann(n: int) -> np.ndarray:
    # librosa.stft builds its window with fftbins=True (periodic): 0.5-0.5cos(2πk/n)
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _on_device(name: str, device: torch.device) -> Tensor:
    """The Hann window or the (transposed) mel filterbank on ``device``, made once."""
    arr = _hann(_N_FFT) if name == "hann" else _mel_filterbank(SAMPLING_RATE, _N_FFT, _N_MELS).T.copy()
    return torch.from_numpy(arr).to(device)


def _melspec_db(x: Tensor, sr: int = SAMPLING_RATE) -> Tensor:
    """[B, T] -> [B, frames, n_mels]: power mel spectrogram in the reference's dB
    scaling — ``(power_to_db(S, ref=S.max()) + 40) / 40`` with the max taken over the
    whole call (the reference normalizes across the batch, not per row)."""
    pad = _N_FFT // 2
    xp = torch.nn.functional.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = xp.unfold(-1, _N_FFT, _HOP) * _on_device("hann", x.device)  # [B, frames, n_fft]
    spec = torch.abs(torch.fft.rfft(frames, dim=-1)) ** 2  # [B, frames, 161]
    if sr == SAMPLING_RATE:
        fb = _on_device("mel", x.device)
    else:
        fb = torch.from_numpy(_mel_filterbank(sr, _N_FFT, _N_MELS).T.copy()).to(x.device)
    mel = _matmul_full_float32(spec, fb)  # [B, frames, 120]
    amin = 1e-10
    log_spec = 10.0 * torch.log10(torch.clamp(mel, min=amin))
    log_spec = log_spec - 10.0 * torch.log10(torch.clamp(torch.amax(mel), min=amin))
    log_spec = torch.maximum(log_spec, torch.amax(log_spec) - 80.0)  # top_db=80
    return (log_spec + 40.0) / 40.0


# ------------------------------------------------------------ model resolution
_RAW_LAYOUTS = {
    "model_v8": ("model_v8.onnx", os.path.join("DNSMOS", "model_v8.onnx")),
    "sig_bak_ovr": ("sig_bak_ovr.onnx", os.path.join("DNSMOS", "sig_bak_ovr.onnx")),
    "p_sig_bak_ovr": ("p_sig_bak_ovr.onnx", os.path.join("pDNSMOS", "sig_bak_ovr.onnx")),
}


def _dnsmos_root() -> Optional[str]:
    explicit = os.environ.get("TORCHMETRICS_TPU_DNSMOS_DIR")
    if explicit and os.path.isdir(explicit):
        return explicit
    repo_weights = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))),
        "weights", "dnsmos",
    )
    return repo_weights if os.path.isdir(repo_weights) else None


def _find_raw(root: str, key: str) -> Optional[str]:
    for rel in _RAW_LAYOUTS[key]:
        raw = os.path.join(root, rel)
        if os.path.isfile(raw):
            return raw
    return None


def _resolve_model(root: str, key: str) -> Optional[str]:
    """Converted dir for ``key``, converting a raw .onnx drop if present.

    Records the raw source path so :func:`_load_model` can purge and re-convert a
    corrupted converted cache; with no raw drop to rebuild from, corruption raises at
    load instead of running a half-loaded graph.
    """
    from torchmetrics_tpu_torch.convert.onnx_torch import convert_onnx_flax

    converted = os.path.join(root, key)
    raw = _find_raw(root, key)
    if not os.path.isfile(os.path.join(converted, "graph.json")):
        if raw is None:
            return None
        convert_onnx_flax(raw, converted)
    if raw is not None:
        _RAW_SOURCE[converted] = raw
    return converted


# converted-dir -> raw .onnx it can be rebuilt from (populated by _resolve_model)
_RAW_SOURCE: dict = {}


@functools.lru_cache(maxsize=8)
def _load_model(model_dir: str, device: torch.device = torch.device("cpu")):
    """The converted graph of ``model_dir`` as an ``OnnxGraph`` module on ``device``."""
    from torchmetrics_tpu_torch.convert.onnx_torch import OnnxGraph, convert_onnx_flax, load_onnx_graph
    from torchmetrics_tpu_torch.robust.retry import load_with_cache_recovery

    raw = _RAW_SOURCE.get(model_dir)
    rebuild = (lambda: convert_onnx_flax(raw, model_dir)) if raw is not None else None
    spec, params = load_with_cache_recovery(
        model_dir,
        load_onnx_graph,
        rebuild=rebuild,
        description=f"converted DNSMOS model cache {model_dir!r}",
    )
    return OnnxGraph(spec, params, device)


# --------------------------------------------------------------------- scoring
def _polyfit_coeffs(personalized: bool) -> np.ndarray:
    """Published DNSMOS polynomial calibrations (reference dnsmos.py:121-145).

    Rows are (sig, bak, ovr); columns are descending-power coefficients padded to cubic.
    """
    if personalized:
        return np.asarray(
            [
                [-0.01019296, 0.02751166, 1.19576786, -0.24348726],  # sig
                [-0.04976499, 0.44276479, -0.1644611, 0.96883132],  # bak
                [-0.00533021, 0.005101, 1.18058466, -0.11236046],  # ovr
            ]
        )
    return np.asarray(
        [
            [0.0, -0.08397278, 1.22083953, 0.0052439],
            [0.0, -0.13166888, 1.60915514, -0.39604546],
            [0.0, -0.06766283, 1.11546468, 0.04602535],
        ]
    )


def deep_noise_suppression_mean_opinion_score(
    preds: Tensor,
    fs: int,
    personalized: bool,
    device: Optional[Union[str, torch.device]] = None,
    num_threads: Optional[int] = None,
    op_times: Optional[dict] = None,
) -> Tensor:
    """DNSMOS ``[p808_mos, mos_sig, mos_bak, mos_ovr]`` per waveform.

    Args:
        preds: shape ``(..., time)``
        fs: sampling frequency of ``preds``
        personalized: penalize interfering speakers (uses the pDNSMOS head)
        device: where the graphs run (default: the device of ``preds``)
        num_threads: accepted for reference signature parity
        op_times: where given, each executor op type's milliseconds are added to it

    Returns:
        float32 tensor of shape ``(..., 4)`` on the device the graphs ran on

    Raises:
        ModuleNotFoundError: when no converted/raw DNSMOS checkpoints are found.
    """
    root = _dnsmos_root()
    p808_dir = _resolve_model(root, "model_v8") if root else None
    sbo_dir = _resolve_model(root, "p_sig_bak_ovr" if personalized else "sig_bak_ovr") if root else None
    if p808_dir is None or sbo_dir is None:
        raise ModuleNotFoundError(
            "DNSMOS requires the Microsoft DNS-challenge ONNX checkpoints. Drop the"
            " .onnx files (or converted directories) under $TORCHMETRICS_TPU_DNSMOS_DIR"
            " or <repo>/weights/dnsmos — e.g. DNSMOS/model_v8.onnx, DNSMOS/sig_bak_ovr.onnx,"
            " pDNSMOS/sig_bak_ovr.onnx — or convert explicitly with"
            " `python -m torchmetrics_tpu.convert onnx-flax <model.onnx> -o <dir>`."
        )

    preds = torch.as_tensor(preds)
    run_on = torch.device(device) if device is not None else preds.device
    shape = preds.shape
    x = preds.reshape(1, -1) if preds.ndim == 1 else preds.reshape(-1, shape[-1])
    x = x.to(device=run_on, dtype=torch.float32)
    if fs != SAMPLING_RATE:
        from torchmetrics_tpu_torch.functional.audio.stoi import resample_poly

        x = resample_poly(x, fs, SAMPLING_RATE)

    len_samples = int(INPUT_LENGTH * SAMPLING_RATE)
    while x.shape[-1] < len_samples:
        x = torch.cat([x, x], dim=-1)  # reference tiles short clips (dnsmos.py:199-201)

    num_hops = int(np.floor(x.shape[-1] / SAMPLING_RATE) - INPUT_LENGTH) + 1
    hop = SAMPLING_RATE
    b = x.shape[0]
    segs = torch.stack([x[:, i * hop : i * hop + len_samples] for i in range(num_hops)])  # [H, B, L]
    # the dB reference max is per *hop* (the reference loops hops, each call taking
    # ref=np.max over that hop's batch), so mel features are normalized hop by hop
    # before the fold into one batched forward
    mel = torch.stack([_melspec_db(segs[h, :, :-_HOP]) for h in range(num_hops)])  # [H, B, F, M]

    p808_forward = _load_model(p808_dir, run_on)
    sbo_forward = _load_model(sbo_dir, run_on)
    p808 = p808_forward(mel.reshape(num_hops * b, *mel.shape[2:]), op_times=op_times)[0]  # [H*B, 1]
    sbo = sbo_forward(segs.reshape(num_hops * b, len_samples), op_times=op_times)[0]  # [H*B, 3] raw

    raw = torch.cat([p808.reshape(-1, 1), sbo.reshape(-1, 3)], dim=-1).cpu().numpy().astype(np.float64)
    coeffs = _polyfit_coeffs(personalized)
    for k in range(3):
        raw[:, 1 + k] = np.polyval(coeffs[k], raw[:, 1 + k])
    mos = raw.reshape(num_hops, b, 4).mean(axis=0)
    out = mos.reshape((*shape[:-1], 4)) if len(shape) > 1 else mos.reshape(4)
    return torch.from_numpy(out.astype(np.float32)).to(run_on)
