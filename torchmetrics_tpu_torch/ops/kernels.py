"""The port's hand-written CUDA kernels: wrappers, plain PyTorch versions, launch counts.

Each wrapper takes the plain version for tensors on the CPU, and only then. For
tensors on the card it launches its kernel (``csrc/*.cu``, built at first use by
``_build``) or raises: there is no fallback and no size gate. After each launch it
checks the ``cudaGetLastError()`` that the C function returns. ``LAUNCHES`` counts
the launches of each kernel, so a run can show that its path went through them.

- ``confusion_matrix`` replaces ``confusion_matrix_pallas``
  (``torchmetrics_tpu/ops/pallas_kernels.py:70``).
- ``binned_curve_counts`` replaces ``binned_curve_counts_pallas``
  (``torchmetrics_tpu/ops/pallas_kernels.py:140``).
- ``weighted_bincount`` replaces ``weighted_bincount_pallas``
  (``torchmetrics_tpu/ops/pallas_kernels.py:205``).
- ``bincount`` replaces ``bincount_pallas``
  (``torchmetrics_tpu/ops/pallas_kernels.py:267``); its masked form is the K=1 case
  of ``weighted_bincount``, as on the TPU.

All but ``weighted_bincount`` count in int32, exactly. ``weighted_bincount`` sums in
float64 and rounds to float32 once, on the card and in its plain version alike.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional

import torch

from torchmetrics_tpu_torch.ops import _build

Tensor = torch.Tensor

LAUNCHES: Dict[str, int] = {"confusion_matrix": 0, "binned_curve_counts": 0, "weighted_bincount": 0, "bincount": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_ARGTYPES = {
    "confusion_matrix": (
        "tm_confusion_matrix",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p],
    ),
    "binned_curve_counts": (
        "tm_binned_curve_counts",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
    ),
    "weighted_bincount": (
        "tm_weighted_bincount",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p],
    ),
    "bincount": ("tm_bincount", [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]),
}
_ENTRY_POINTS: Dict[str, Callable[..., int]] = {}


def _entry_point(name: str) -> Callable[..., int]:
    fn = _ENTRY_POINTS.get(name)
    if fn is None:
        symbol, argtypes = _ARGTYPES[name]
        fn = getattr(_build.library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRY_POINTS[name] = fn
    return fn


def _launch(name: str, device: torch.device, *args) -> None:
    """Launch on the current stream. The caller's tensors may be freed right after:
    PyTorch's allocator hands their memory only to work queued later on that stream."""
    fn = _entry_point(name)
    if device.index is not None and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        message = _build.library(name).tm_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {message} ({rc})")
    LAUNCHES[name] += 1


def _on_card(*tensors: Tensor) -> bool:
    """True for tensors on one CUDA device, False for CPU tensors; raises on anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"Expected all inputs on one device, got {sorted(str(d) for d in devices)}")
    device = devices.pop()
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"The CUDA kernels take CUDA or CPU tensors, got a tensor on {device}")
    return True


def _mask_bytes(valid: Tensor) -> Tensor:
    return valid.reshape(-1).to(torch.bool).contiguous().view(torch.uint8)


# ------------------------------------------------------------------ confusion matrix


def confusion_matrix_plain(preds: Tensor, target: Tensor, valid: Tensor, num_classes: int) -> Tensor:
    """Plain PyTorch version of the confusion-matrix kernel: int32 [C, C], rows = target.

    A pair that is invalid, or with a label outside ``[0, C)``, counts nowhere.
    """
    c = num_classes
    preds = preds.reshape(-1).to(torch.int64)
    target = target.reshape(-1).to(torch.int64)
    keep = valid.reshape(-1).to(torch.bool) & (preds >= 0) & (preds < c) & (target >= 0) & (target < c)
    counts = torch.bincount((target * c + preds)[keep], minlength=c * c)
    return counts.to(torch.int32).reshape(c, c)


def confusion_matrix(preds: Tensor, target: Tensor, valid: Tensor, num_classes: int) -> Tensor:
    """int32 [C, C] counts of (target=row, pred=col) pairs where ``valid``."""
    if not _on_card(preds, target, valid):
        return confusion_matrix_plain(preds, target, valid, num_classes)
    preds = preds.reshape(-1).to(torch.int32).contiguous()
    target = target.reshape(-1).to(torch.int32).contiguous()
    mask = _mask_bytes(valid)
    n = preds.numel()
    if target.numel() != n or mask.numel() != n:
        raise ValueError(f"Expected preds, target and valid of one length, got {n}, {target.numel()}, {mask.numel()}")
    out = torch.zeros((num_classes, num_classes), dtype=torch.int32, device=preds.device)
    if n:
        _launch(
            "confusion_matrix", preds.device,
            preds.data_ptr(), target.data_ptr(), mask.data_ptr(), n, num_classes, out.data_ptr(),
        )
    return out


# ---------------------------------------------------------------- binned curve counts


def binned_curve_counts_plain(scores: Tensor, labels: Tensor, valid: Tensor, thresholds: Tensor) -> Tensor:
    """Plain PyTorch version of the binned-curve kernel: int32 [T, 2] of (tp, fp).

    ``tp[t]`` counts valid samples with a non-zero label and ``score >= thr[t]``,
    ``fp[t]`` valid samples with label 0; a NaN score counts nowhere. The [N, T]
    compare runs in chunks of samples to bound its memory.
    """
    scores = scores.reshape(-1).to(torch.float32)
    thr = thresholds.reshape(-1).to(torch.float32)
    valid = valid.reshape(-1).to(torch.bool)
    positive = labels.reshape(-1) != 0
    pos = (valid & positive)[:, None]
    neg = (valid & ~positive)[:, None]
    out = torch.zeros((thr.shape[0], 2), dtype=torch.int64, device=scores.device)
    chunk = max(1, (1 << 24) // max(1, thr.shape[0]))
    for s in range(0, scores.shape[0], chunk):
        above = scores[s:s + chunk, None] >= thr[None, :]
        out[:, 0] += (above & pos[s:s + chunk]).sum(dim=0)
        out[:, 1] += (above & neg[s:s + chunk]).sum(dim=0)
    return out.to(torch.int32)


def binned_curve_counts(scores: Tensor, labels: Tensor, valid: Tensor, thresholds: Tensor) -> Tensor:
    """int32 [T, 2] (tp, fp) per threshold, thresholds in any order."""
    if not _on_card(scores, labels, valid, thresholds):
        return binned_curve_counts_plain(scores, labels, valid, thresholds)
    scores = scores.reshape(-1).to(torch.float32).contiguous()
    labels = labels.reshape(-1).to(torch.int32).contiguous()
    mask = _mask_bytes(valid)
    thr = thresholds.reshape(-1).to(torch.float32).contiguous()
    n = scores.numel()
    if labels.numel() != n or mask.numel() != n:
        raise ValueError(f"Expected scores, labels and valid of one length, got {n}, {labels.numel()}, {mask.numel()}")
    out = torch.zeros((thr.numel(), 2), dtype=torch.int32, device=scores.device)
    if n and thr.numel():
        _launch(
            "binned_curve_counts", scores.device,
            scores.data_ptr(), labels.data_ptr(), mask.data_ptr(), n, thr.data_ptr(), thr.numel(), out.data_ptr(),
        )
    return out


# ------------------------------------------------------------------ weighted bincount


def weighted_bincount_plain(x: Tensor, weights: Tensor, minlength: int) -> Tensor:
    """Plain PyTorch version of the weighted-bincount kernel: float32 [K, C].

    ``out[k, c] = sum_i weights[k, i] * [x[i] == c]``, summed in float64 and rounded
    once. An index outside ``[0, C)`` counts nowhere. As in the one-hot contraction of
    the TPU kernel, where ``0 * NaN`` and ``0 * inf`` are NaN, a non-finite weight of
    row k makes every bin of row k that it does not land in NaN.
    """
    x = x.reshape(-1).to(torch.int64)
    w = weights.to(torch.float64)
    k = w.shape[0]
    keep = (x >= 0) & (x < minlength)
    idx, w_kept = x[keep], w[:, keep]
    sums = torch.zeros((k, minlength), dtype=torch.float64, device=w.device).index_add_(1, idx, w_kept)
    bad = ~torch.isfinite(w)
    bad_here = torch.zeros((k, minlength), dtype=torch.int64, device=w.device)
    bad_here.index_add_(1, idx, bad[:, keep].to(torch.int64))
    poisoned = bad.sum(dim=1, keepdim=True) > bad_here
    return torch.where(poisoned, torch.full_like(sums, float("nan")), sums).to(torch.float32)


def weighted_bincount(x: Tensor, weights: Tensor, minlength: int) -> Tensor:
    """float32 [K, C] weighted bincounts of the int indices ``x`` [N] by ``weights`` [K, N]."""
    if not _on_card(x, weights):
        return weighted_bincount_plain(x, weights, minlength)
    x = x.reshape(-1).to(torch.int32).contiguous()
    w = weights.to(torch.float32).contiguous()
    if w.ndim != 2 or w.shape[1] != x.numel():
        raise ValueError(f"Expected weights of shape [K, {x.numel()}], got {tuple(w.shape)}")
    k, n = w.shape
    if n == 0 or k == 0 or minlength == 0:
        return torch.zeros((k, minlength), dtype=torch.float32, device=w.device)
    sums = torch.zeros((k, minlength), dtype=torch.float64, device=w.device)
    nonfinite = torch.zeros(k + k * minlength, dtype=torch.int32, device=w.device)
    out = torch.empty((k, minlength), dtype=torch.float32, device=w.device)
    _launch(
        "weighted_bincount", w.device,
        x.data_ptr(), w.data_ptr(), n, k, minlength, sums.data_ptr(), nonfinite.data_ptr(), out.data_ptr(),
    )
    return out


# --------------------------------------------------------------------------- bincount


def bincount_plain(x: Tensor, minlength: int) -> Tensor:
    """Plain PyTorch version of the bincount kernel: int32 [C]; an index outside ``[0, C)`` counts nowhere."""
    x = x.reshape(-1).to(torch.int64)
    return torch.bincount(x[(x >= 0) & (x < minlength)], minlength=minlength).to(torch.int32)


def bincount(x: Tensor, valid: Optional[Tensor], minlength: int) -> Tensor:
    """int32 [C] counts of the int indices ``x`` [N], over the samples where ``valid``.

    With ``valid`` this is the K=1 case of ``weighted_bincount`` cast to int32, as the
    TPU kernel routes it; without, the bincount kernel reads only the indices.
    """
    if valid is not None:
        counts = weighted_bincount(x, valid.reshape(1, -1).to(torch.float32), minlength)
        return counts[0].to(torch.int32)
    if not _on_card(x):
        return bincount_plain(x, minlength)
    x = x.reshape(-1).to(torch.int32).contiguous()
    out = torch.zeros(minlength, dtype=torch.int32, device=x.device)
    if x.numel() and minlength:
        _launch("bincount", x.device, x.data_ptr(), x.numel(), minlength, out.data_ptr())
    return out
