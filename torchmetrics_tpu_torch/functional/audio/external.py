"""Dependency-gated audio metrics: PESQ, pystoi's STOI and srmrpy's SRMR.

Counterpart of ``torchmetrics_tpu/functional/audio/external.py``. Each wraps an
external CPU library: the signals go to the host, the library scores them, and the
scores come back on the inputs' device. Where the library is missing, the gate raises
the JAX package's install hint. The port's own STOI and SRMR (``stoi.py``,
``srmr.py``) need none of them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from torchmetrics_tpu_torch.utils.imports import _package_available

Tensor = torch.Tensor

_PESQ_AVAILABLE = _package_available("pesq")
_PYSTOI_AVAILABLE = _package_available("pystoi")
_SRMRPY_AVAILABLE = _package_available("srmrpy")


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, Tensor) else np.asarray(x)


def _scores(values, shape, like) -> Tensor:
    device = like.device if isinstance(like, Tensor) else None
    return torch.as_tensor(np.asarray(values, dtype=np.float32), device=device).reshape(shape)


def perceptual_evaluation_speech_quality(
    preds: Tensor,
    target: Tensor,
    fs: int,
    mode: str,
    keep_same_device: bool = False,
    n_processes: int = 1,
) -> Tensor:
    """Compute PESQ with the external ``pesq`` library (on the host).

    Raises:
        ModuleNotFoundError: If ``pesq`` is not installed.
    """
    if not _PESQ_AVAILABLE:
        raise ModuleNotFoundError(
            "PESQ metric requires that pesq is installed. Either install as `pip install torchmetrics[audio]`"
            " or `pip install pesq`."
        )
    import pesq as pesq_backend

    if fs not in (8000, 16000):
        raise ValueError(f"Expected argument `fs` to either be 8000 or 16000 but got {fs}")
    if mode not in ("wb", "nb"):
        raise ValueError(f"Expected argument `mode` to either be 'wb' or 'nb' but got {mode}")

    preds_np, target_np = _host(preds), _host(target)
    if preds_np.ndim == 1:
        return _scores(pesq_backend.pesq(fs, target_np, preds_np, mode), (), preds)
    vals = [
        pesq_backend.pesq(fs, t, p, mode)
        for p, t in zip(preds_np.reshape(-1, preds_np.shape[-1]), target_np.reshape(-1, target_np.shape[-1]))
    ]
    return _scores(vals, preds_np.shape[:-1], preds)


def short_time_objective_intelligibility(
    preds: Tensor,
    target: Tensor,
    fs: int,
    extended: bool = False,
    keep_same_device: bool = False,
) -> Tensor:
    """Compute STOI with the external ``pystoi`` library (on the host).

    Not the public entry point: the port's STOI is ``functional/audio/stoi.py``, which
    needs no library. This gate is kept for cross-checking where ``pystoi`` is installed.

    Raises:
        ModuleNotFoundError: If ``pystoi`` is not installed.
    """
    if not _PYSTOI_AVAILABLE:
        raise ModuleNotFoundError(
            "STOI metric requires that `pystoi` is installed. Either install as `pip install torchmetrics[audio]`"
            " or `pip install pystoi`."
        )
    from pystoi import stoi as stoi_backend

    preds_np, target_np = _host(preds), _host(target)
    if preds_np.ndim == 1:
        return _scores(stoi_backend(target_np, preds_np, fs, extended), (), preds)
    vals = [
        stoi_backend(t, p, fs, extended)
        for p, t in zip(preds_np.reshape(-1, preds_np.shape[-1]), target_np.reshape(-1, target_np.shape[-1]))
    ]
    return _scores(vals, preds_np.shape[:-1], preds)


def _srmr_srmrpy(
    preds: Tensor,
    fs: int,
    n_cochlear_filters: int = 23,
    low_freq: float = 125,
    min_cf: float = 4,
    max_cf: Optional[float] = None,
    norm: bool = False,
    fast: bool = False,
) -> Tensor:
    """SRMR with the external ``srmrpy`` library (on the host), for cross-checking the
    port's own ``functional/audio/srmr.py``.

    Raises:
        ModuleNotFoundError: If ``srmrpy`` is not installed.
    """
    if not _SRMRPY_AVAILABLE:
        raise ModuleNotFoundError(
            "speech_reverberation_modulation_energy_ratio requires that srmrpy is installed."
            " Install it with `pip install srmrpy`."
        )
    import srmrpy

    srmr_kwargs = dict(
        n_cochlear_filters=n_cochlear_filters, low_freq=low_freq, min_cf=min_cf,
        max_cf=max_cf, fast=fast, norm=norm,
    )
    preds_np = _host(preds)
    if preds_np.ndim == 1:
        # shape (1,) for 1-D input: the same contract as the native path
        return _scores([srmrpy.srmr(preds_np, fs, **srmr_kwargs)[0]], (1,), preds)
    vals = [srmrpy.srmr(p, fs, **srmr_kwargs)[0] for p in preds_np.reshape(-1, preds_np.shape[-1])]
    return _scores(vals, preds_np.shape[:-1], preds)
