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
- ``ssim_moments`` replaces ``ssim_moments_pallas``
  (``torchmetrics_tpu/ops/pallas_kernels.py:334``). It is differentiable: a
  ``torch.autograd.Function`` whose forward launches the kernel and whose backward
  applies the adjoint of the separable window in plain PyTorch.

A wrapper's launch can be captured in a CUDA graph (``core/jit.py``): its scratch is
kept per (device, stream), so a warm call on the capture stream makes it before the
capture, and a replay of K2's and K3's ticketed launches leaves it zero as an eager
call does. ``LAUNCHES`` counts where a wrapper launches, so the capture cache adds a
variant's counts at each replay.

Every kernel and plain version takes an int64 label or index by its low 32 bits, as
the JAX package (64-bit types off) converts it to int32 on entry. The counting kernels
count in int32, exactly. ``weighted_bincount`` sums in float64 and rounds to float32
once, on the card and in its plain version alike. ``ssim_moments`` sums in float32,
in the TPU kernel's order.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from torchmetrics_tpu_torch.ops import _build

Tensor = torch.Tensor

LAUNCHES: Dict[str, int] = {
    "confusion_matrix": 0, "binned_curve_counts": 0, "weighted_bincount": 0, "bincount": 0, "ssim_moments": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


_ARGTYPES = {
    "confusion_matrix": (
        "tm_confusion_matrix",
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p],
    ),
    "binned_curve_counts": (
        "tm_binned_curve_counts",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p],
    ),
    "weighted_bincount": (
        "tm_weighted_bincount",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p],
    ),
    "bincount": (
        "tm_bincount",
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
         ctypes.c_void_p, ctypes.c_void_p],
    ),
    "ssim_moments": (
        "tm_ssim_moments",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
    ),
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


# the current stream's raw handle, without building a torch.cuda.Stream object
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _raw_stream(index: int) -> int:
    if _RAW_STREAM is None:
        return torch.cuda.current_stream(index).cuda_stream
    return _RAW_STREAM(index)


def _launch(name: str, index: int, *args, stream: Optional[int] = None) -> None:
    """Launch on CUDA device ``index``'s current stream (or on ``stream``, its raw
    handle). The caller's tensors may be freed right after: PyTorch's allocator hands
    their memory only to work queued later on that stream."""
    fn = _entry_point(name)
    if stream is None:
        stream = _raw_stream(index)
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            rc = fn(*args, stream)
    else:
        rc = fn(*args, stream)
    if rc != 0:
        message = _build.library(name).tm_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {message} ({rc})")
    LAUNCHES[name] += 1


def _on_card(*tensors: Tensor) -> bool:
    """True for tensors on one CUDA device, False for CPU tensors; raises on anything else."""
    index = tensors[0].get_device()  # -1 on the CPU
    if index >= 0 and all(t.is_cuda and t.get_device() == index for t in tensors):
        return True
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"Expected all inputs on one device, got {sorted(str(d) for d in devices)}")
    device = devices.pop()
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"The CUDA kernels take CUDA or CPU tensors, got a tensor on {device}")
    return True


def _as_jax_takes_it(a: Tensor) -> Tensor:
    """``a`` as the JAX package receives it with 64-bit types off: an int64 tensor by
    its low 32 bits (int32), any other as it is."""
    return a.to(torch.int32) if a.dtype == torch.int64 else a




# ------------------------------------------------------------------ confusion matrix


def confusion_matrix_plain(preds: Tensor, target: Tensor, valid: Tensor, num_classes: int) -> Tensor:
    """Plain PyTorch version of the confusion-matrix kernel: int32 [C, C], rows = target.

    Labels and mask are taken as JAX takes them (an int64 by its low 32 bits). A pair
    that is invalid, or with a label outside ``[0, C)``, counts nowhere.
    """
    c = num_classes
    preds = _as_jax_takes_it(preds.reshape(-1)).to(torch.int64)
    target = _as_jax_takes_it(target.reshape(-1)).to(torch.int64)
    keep = _as_jax_takes_it(valid.reshape(-1)).to(torch.bool)
    keep = keep & (preds >= 0) & (preds < c) & (target >= 0) & (target < c)
    counts = torch.bincount((target * c + preds)[keep], minlength=c * c)
    return counts.to(torch.int32).reshape(c, c)


# what the confusion-matrix wrapper takes: integer or bool labels and mask
_CONFUSION_DTYPES = frozenset({torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64})
# the labels that the kernel reads as they are, by their item size
_LABEL_BYTES = {torch.int32: 4, torch.int64: 8}
# C * C must fit an int32 cell index
_MAX_CLASSES = 46340
# The slots of the kernel's grid in its shared-memory modes, one scratch per (device
# index, raw stream): launches on two streams may run at once.
_CONFUSION_SCRATCH: Dict[Tuple[int, int], Tensor] = {}
_SM_COUNTS: Dict[int, int] = {}


def _grid_slots_bytes(index: int, n: int, bins: int) -> int:
    """An int32 [bins] slot for each block of a grid of one 1024-thread block per SM at
    most, none idle (the grid of confusion_matrix.cu's and bincount.cu's shared-memory
    modes)."""
    sms = _SM_COUNTS.get(index)
    if sms is None:
        sms = _SM_COUNTS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return min(-(-n // 1024), sms) * bins * 4


def _confusion_slots_bytes(index: int, n: int, c: int) -> int:
    """The scratch one call needs (confusion_matrix.cu): past N = 8192 (kSingleBlockMax)
    and within C * C = 12288 bins (kBlockBins), a slot of C * C bins for each block of
    the grid; else none."""
    if n <= 8192 or c * c > 12288:
        return 0
    return _grid_slots_bytes(index, n, c * c)


# The raw handles of the streams that CUDA graphs are captured on (``core/jit.py``'s
# capture streams). A graph keeps the address of the scratch its capture used, so a
# scratch of such a stream that grows is retired, never freed.
GRAPH_STREAMS: set = set()
_RETIRED_SCRATCH: list = []


def _stream_scratch(cache: Dict[Tuple[int, int], Tensor], index: int, stream: int, nbytes: int,
                    zero: bool) -> Tensor:
    """At least ``nbytes`` of device scratch kept in ``cache`` for (device ``index``, raw
    ``stream``), grown on demand; zeroed when made if ``zero``. Launches on one stream
    run in order and may share it, launches on two streams may not."""
    scratch = cache.get((index, stream))
    if scratch is None or scratch.numel() < nbytes:
        if scratch is not None and stream in GRAPH_STREAMS:
            # a captured graph may hold the old scratch's address: it must outlive it
            _RETIRED_SCRATCH.append(scratch)
        # allocated while `stream` is current, so the allocator ties it to that stream
        make = torch.zeros if zero else torch.empty
        scratch = make(max(nbytes, 4096), dtype=torch.uint8, device=torch.device("cuda", index))
        cache[(index, stream)] = scratch
    return scratch


def _label_operand(a: Tensor) -> Tensor:
    """int32 and int64 labels as they are; other integer types and bool cast to int32;
    a copy where they are not contiguous."""
    if a.dtype not in _LABEL_BYTES:
        a = a.to(torch.int32)
    return a if a.is_contiguous() else a.contiguous()


def _mask_operand(valid: Tensor) -> Tensor:
    """A bool mask as it is; a mask of another type compared with 0 (an int64 by its low
    32 bits); a copy where it is not contiguous. The kernels read its bytes."""
    if valid.dtype != torch.bool:
        valid = _as_jax_takes_it(valid) != 0
    return valid if valid.is_contiguous() else valid.contiguous()


def confusion_matrix(preds: Tensor, target: Tensor, valid: Tensor, num_classes: int) -> Tensor:
    """int32 [C, C] counts of (target=row, pred=col) pairs where ``valid``.

    ``preds``, ``target`` and ``valid`` hold N elements each, in any shape, of integer
    or bool type. On the card: one kernel launch and one allocation (the output) per
    call. The kernel reads int32 and int64 labels and a contiguous bool mask in place;
    other label types are cast to int32, a mask of another type is compared with 0,
    and what is not contiguous is copied.
    """
    if preds.dtype not in _CONFUSION_DTYPES or target.dtype not in _CONFUSION_DTYPES \
            or valid.dtype not in _CONFUSION_DTYPES:
        raise TypeError(
            f"Expected integer or bool preds, target and valid, got {preds.dtype}, {target.dtype}, {valid.dtype}"
        )
    n = preds.numel()
    if target.numel() != n or valid.numel() != n:
        raise ValueError(f"Expected preds, target and valid of one length, got {n}, {target.numel()}, {valid.numel()}")
    if not 0 <= num_classes <= _MAX_CLASSES:
        raise ValueError(f"Expected num_classes in [0, {_MAX_CLASSES}], got {num_classes}")
    if not _on_card(preds, target, valid):
        return confusion_matrix_plain(preds, target, valid, num_classes)
    preds, target, valid = _label_operand(preds), _label_operand(target), _mask_operand(valid)
    out = preds.new_empty((num_classes, num_classes), dtype=torch.int32)
    if num_classes:
        index = preds.get_device()
        stream = _raw_stream(index)
        need = _confusion_slots_bytes(index, n, num_classes)
        slots = _stream_scratch(_CONFUSION_SCRATCH, index, stream, need, zero=False).data_ptr() if need else None
        _launch(
            "confusion_matrix", index,
            preds.data_ptr(), _LABEL_BYTES[preds.dtype], target.data_ptr(), _LABEL_BYTES[target.dtype],
            valid.data_ptr(), n, num_classes, slots, need, out.data_ptr(), stream=stream,
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
    valid = _as_jax_takes_it(valid.reshape(-1)).to(torch.bool)
    positive = _as_jax_takes_it(labels.reshape(-1)) != 0
    pos = (valid & positive)[:, None]
    neg = (valid & ~positive)[:, None]
    out = torch.zeros((thr.shape[0], 2), dtype=torch.int64, device=scores.device)
    chunk = max(1, (1 << 24) // max(1, thr.shape[0]))
    for s in range(0, scores.shape[0], chunk):
        above = scores[s:s + chunk, None] >= thr[None, :]
        out[:, 0] += (above & pos[s:s + chunk]).sum(dim=0)
        out[:, 1] += (above & neg[s:s + chunk]).sum(dim=0)
    return out.to(torch.int32)


# The binned curve's scratch (int32 [2 (T + 1)] bucket sums and a ticket), zeroed once
# and left zero by every launch, one per (device index, raw stream).
_CURVE_SCRATCH: Dict[Tuple[int, int], Tensor] = {}


def _curve_scratch_bytes(t: int) -> int:
    return 8 * (t + 1) + 4  # tm_binned_curve_counts_scratch_bytes


def binned_curve_counts(scores: Tensor, labels: Tensor, valid: Tensor, thresholds: Tensor) -> Tensor:
    """int32 [T, 2] (tp, fp) per threshold, thresholds in any order.

    ``scores``, ``labels`` and ``valid`` hold N elements each, in any shape. On the card:
    one kernel launch and one allocation (the output) per call. The kernel reads float32
    scores and thresholds, int32 and int64 labels and a bool mask in place; other float
    types are cast to float32 (float64 rounds as JAX rounds it with 64-bit types off),
    other label types to int32, a mask of another type is compared with 0, and what is
    not contiguous is copied.
    """
    n = scores.numel()
    if labels.numel() != n or valid.numel() != n:
        raise ValueError(f"Expected scores, labels and valid of one length, got {n}, {labels.numel()}, {valid.numel()}")
    if not _on_card(scores, labels, valid, thresholds):
        return binned_curve_counts_plain(scores, labels, valid, thresholds)
    scores, thr = _contiguous_float32(scores), _contiguous_float32(thresholds)
    labels, valid = _label_operand(labels), _mask_operand(valid)
    t = thr.numel()
    out = scores.new_empty((t, 2), dtype=torch.int32)
    if n == 0:  # nothing to count
        return out.zero_()
    if t:
        index = scores.get_device()
        stream = _raw_stream(index)
        need = _curve_scratch_bytes(t)
        scratch = _stream_scratch(_CURVE_SCRATCH, index, stream, need, zero=True)
        _launch(
            "binned_curve_counts", index,
            scores.data_ptr(), labels.data_ptr(), _LABEL_BYTES[labels.dtype], valid.data_ptr(), n, thr.data_ptr(), t,
            scratch.data_ptr(), need, out.data_ptr(), stream=stream,
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
    x = _as_jax_takes_it(x.reshape(-1)).to(torch.int64)
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


# The weighted bincount's scratch (float64 sums, per-row trackers, a ticket), zeroed
# once and left zero by every launch, one per (device index, raw stream).
_WEIGHTED_SCRATCH: Dict[Tuple[int, int], Tensor] = {}


def _weighted_scratch_bytes(k: int, c: int) -> int:
    return k * c * 8 + 2 * k * 4 + 4  # tm_weighted_bincount_scratch_bytes


def weighted_bincount(x: Tensor, weights: Tensor, minlength: int) -> Tensor:
    """float32 [K, C] weighted bincounts of the int indices ``x`` [N] by ``weights`` [K, N].

    On the card: one kernel launch and one allocation (the output) per call.
    """
    if not _on_card(x, weights):
        return weighted_bincount_plain(x, weights, minlength)
    if x.dim() != 1:
        x = x.reshape(-1)
    if x.dtype != torch.int32:
        x = x.to(torch.int32)
    if not x.is_contiguous():
        x = x.contiguous()
    w = weights if weights.dtype == torch.float32 else weights.to(torch.float32)
    if not w.is_contiguous():
        w = w.contiguous()
    if w.ndim != 2 or w.shape[1] != x.numel():
        raise ValueError(f"Expected weights of shape [K, {x.numel()}], got {tuple(w.shape)}")
    k, n = w.shape
    if n == 0 or k == 0 or minlength == 0:
        return w.new_zeros((k, minlength))
    out = w.new_empty((k, minlength))
    index = w.get_device()
    stream = _raw_stream(index)
    scratch = _stream_scratch(_WEIGHTED_SCRATCH, index, stream, _weighted_scratch_bytes(k, minlength), zero=True)
    _launch(
        "weighted_bincount", index,
        x.data_ptr(), w.data_ptr(), n, k, minlength, scratch.data_ptr(), out.data_ptr(), stream=stream,
    )
    return out


# --------------------------------------------------------------------------- bincount


def bincount_plain(x: Tensor, minlength: int) -> Tensor:
    """Plain PyTorch version of the bincount kernel: int32 [C]. An index is taken as JAX
    takes it (an int64 by its low 32 bits); one outside ``[0, C)`` counts nowhere."""
    x = _as_jax_takes_it(x.reshape(-1)).to(torch.int64)
    return torch.bincount(x[(x >= 0) & (x < minlength)], minlength=minlength).to(torch.int32)


# The bincount kernel's slots (bincount.cu), one scratch per (device index, raw stream).
_BINCOUNT_SCRATCH: Dict[Tuple[int, int], Tensor] = {}
# bincount.cu's kSingleBlockMax and kBlockBins: one block up to this N; shared memory
# (and the grid's slots past one block) up to this C
_BINCOUNT_SINGLE_BLOCK_MAX = 8192
_BINCOUNT_BLOCK_BINS = (227 * 1024 - 1024) // 4


def _bincount_slots_bytes(index: int, n: int, c: int) -> int:
    """The scratch one call needs (bincount.cu): past one block's N and within shared
    memory's C, a slot of C bins rounded up to 4 for each block of the grid; else none."""
    if n <= _BINCOUNT_SINGLE_BLOCK_MAX or c > _BINCOUNT_BLOCK_BINS:
        return 0
    return _grid_slots_bytes(index, n, -(-c // 4) * 4)


def bincount(x: Tensor, valid: Optional[Tensor], minlength: int) -> Tensor:
    """int32 [C] counts of the int indices ``x`` [N], over the samples where ``valid``.

    With ``valid`` this is the K=1 case of ``weighted_bincount`` cast to int32, as the
    TPU kernel routes it; without, the bincount kernel reads only the indices. On the
    card: one kernel launch and one allocation (the output) per call, none for N = 0 or
    C = 0. The kernel reads int32 and int64 indices in place; other types are cast to
    int32, and what is not contiguous is copied.
    """
    if valid is not None:
        counts = weighted_bincount(x, _as_jax_takes_it(valid).reshape(1, -1).to(torch.float32), minlength)
        return counts[0].to(torch.int32)
    if not _on_card(x):
        return bincount_plain(x, minlength)
    x = _label_operand(x)  # contiguous: its N elements in order, whatever its shape
    n = x.numel()
    if n == 0 or minlength == 0:
        return x.new_zeros(minlength, dtype=torch.int32)
    if minlength >= 1 << 31:
        raise ValueError(f"Expected minlength below 2^31 (the kernel's bins are an int), got {minlength}")
    out = x.new_empty(minlength, dtype=torch.int32)
    index = x.get_device()
    stream = _raw_stream(index)
    need = _bincount_slots_bytes(index, n, minlength)
    slots = _stream_scratch(_BINCOUNT_SCRATCH, index, stream, need, zero=False).data_ptr() if need else None
    _launch("bincount", index, x.data_ptr(), _LABEL_BYTES[x.dtype], n, minlength, slots, need, out.data_ptr(),
            stream=stream)
    return out


# ------------------------------------------------------------------------ SSIM moments


def _separable_window_plain(planes: Tensor, window_h: Tensor, window_w: Tensor) -> Tensor:
    """VALID separable window over the last two dims: the rows pass over ``window_h``,
    then the columns pass over ``window_w``, each a shift-and-add in tap order."""
    kh, kw = window_h.numel(), window_w.numel()
    ho, wo = planes.shape[-2] - kh + 1, planes.shape[-1] - kw + 1
    rows = window_h[0] * planes[..., 0:ho, :]
    for k in range(1, kh):
        rows = rows + window_h[k] * planes[..., k:k + ho, :]
    cols = window_w[0] * rows[..., 0:wo]
    for k in range(1, kw):
        cols = cols + window_w[k] * rows[..., k:k + wo]
    return cols


def _ssim_moments_shapes(preds: Tensor, target: Tensor, window_h: Tensor, window_w: Tensor) -> None:
    shape = preds.shape
    if len(shape) != 3 or shape != target.shape:
        raise ValueError(
            f"Expected preds and target of one shape [P, Hp, Wp], got {tuple(preds.shape)} and {tuple(target.shape)}"
        )
    kh, kw = window_h.numel(), window_w.numel()
    if kh < 1 or kw < 1:
        raise ValueError("Expected non-empty windows")
    if shape[1] < kh or shape[2] < kw:
        raise ValueError(
            f"The window {window_h.numel()}x{window_w.numel()} is larger than the padded planes"
            f" {preds.shape[1]}x{preds.shape[2]}"
        )


def ssim_moments_plain(preds: Tensor, target: Tensor, window_h: Tensor, window_w: Tensor) -> Tensor:
    """Plain PyTorch version of the SSIM moments kernel: float32 [P, 5, Ho, Wo].

    ``preds`` and ``target`` are padded planes [P, Hp, Wp]; ``window_h`` [Kh] and
    ``window_w`` [Kw] the two 1D factors of the window. The moments, in order, are
    E[p], E[t], E[p^2], E[t^2] and E[pt] under the window, Ho = Hp - Kh + 1 and
    Wo = Wp - Kw + 1. Differentiable by autograd.
    """
    _ssim_moments_shapes(preds, target, window_h, window_w)
    p, t = preds.to(torch.float32), target.to(torch.float32)
    planes = torch.stack((p, t, p * p, t * t, p * t), dim=1)
    return _separable_window_plain(
        planes, window_h.reshape(-1).to(torch.float32), window_w.reshape(-1).to(torch.float32)
    )


def _ssim_moments_backward(
    preds: Tensor, target: Tensor, window_h: Tensor, window_w: Tensor, grad: Tensor
) -> Tuple[Tensor, Tensor]:
    """Gradients of the moments' inputs: the adjoint of the separable window (the same
    two passes with the windows flipped, over the cotangent planes zero-padded by the
    window's reach), then the chain rule through the products."""
    kh, kw = window_h.numel(), window_w.numel()
    padded = F.pad(grad, (kw - 1, kw - 1, kh - 1, kh - 1))
    g0, g1, g2, g3, g4 = _separable_window_plain(padded, window_h.flip(0), window_w.flip(0)).unbind(1)
    return g0 + 2 * preds * g2 + target * g4, g1 + 2 * target * g3 + preds * g4


def _ssim_moments_forward(preds: Tensor, target: Tensor, window_h: Tensor, window_w: Tensor) -> Tensor:
    if not _on_card(preds, target, window_h, window_w):
        return ssim_moments_plain(preds, target, window_h, window_w)
    p_planes, hp, wp = preds.shape
    kh, kw = window_h.numel(), window_w.numel()
    out = preds.new_empty((p_planes, 5, hp - kh + 1, wp - kw + 1))
    if p_planes:
        _launch(
            "ssim_moments", preds.get_device(),
            preds.data_ptr(), target.data_ptr(), window_h.data_ptr(), window_w.data_ptr(), p_planes, hp, wp, kh, kw,
            out.data_ptr(),
        )
    return out


class _SsimMoments(torch.autograd.Function):
    """The kernel (or, for CPU tensors, its plain version) forward; the adjoint backward."""

    @staticmethod
    def forward(ctx, preds: Tensor, target: Tensor, window_h: Tensor, window_w: Tensor) -> Tensor:
        ctx.save_for_backward(preds, target, window_h, window_w)
        return _ssim_moments_forward(preds, target, window_h, window_w)

    @staticmethod
    def backward(ctx, grad: Tensor):
        preds, target, window_h, window_w = ctx.saved_tensors
        d_preds, d_target = _ssim_moments_backward(preds, target, window_h, window_w, grad)
        return (
            d_preds if ctx.needs_input_grad[0] else None,
            d_target if ctx.needs_input_grad[1] else None,
            None,
            None,
        )


def ssim_moments(preds: Tensor, target: Tensor, window_h: Tensor, window_w: Tensor) -> Tensor:
    """float32 [P, 5, Ho, Wo] window moments (E[p], E[t], E[p^2], E[t^2], E[pt]) of the
    padded planes [P, Hp, Wp] under the separable window ``window_h`` x ``window_w``.

    Any window size and plane size: the kernel tiles the planes. Gradients flow to
    ``preds`` and ``target``, not to the windows.
    """
    _ssim_moments_shapes(preds, target, window_h, window_w)
    args = (
        _contiguous_float32(preds), _contiguous_float32(target),
        _contiguous_float32(window_h if window_h.dim() == 1 else window_h.reshape(-1)),
        _contiguous_float32(window_w if window_w.dim() == 1 else window_w.reshape(-1)),
    )
    if torch.is_grad_enabled() and (args[0].requires_grad or args[1].requires_grad):
        return _SsimMoments.apply(*args)
    return _ssim_moments_forward(*args)  # nothing to differentiate: skip the autograd node


def _contiguous_float32(a: Tensor) -> Tensor:
    if a.dtype is not torch.float32:
        a = a.to(torch.float32)
    return a if a.is_contiguous() else a.contiguous()
