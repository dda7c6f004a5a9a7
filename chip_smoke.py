#!/usr/bin/env python3
"""Drive the PyTorch port (``torchmetrics_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one JSON line (a failure raises and exits non-zero):

1. ``device``: the card's name and power limit (``nvidia-smi``) and the CUDA version.
2. ``build``: compile the CUDA kernels from ``torchmetrics_tpu_torch/ops/csrc/``.
3. ``kernels``: each kernel against its plain PyTorch version on a CPU copy, at stress
   shapes and at the shapes the main path gives it, with its time, its bound, the
   plain version's time, where one PyTorch call computes the same function that
   call's time, and the launches the check and timing made. Counts must be equal;
   the weighted bincount's float rows must agree within WEIGHTED_RTOL, the SSIM
   moments within MOMENTS_ATOL (with NaN where the plain version has it). Each
   weighted-bincount record also counts the device kernels one call runs
   (torch.profiler; it must be one) and splits a call's host µs into its steps; each
   SSIM-moments record gives the GB/s its bytes make at its time and its bound's share
   of that time.
4. ``imagenet_eval``: an ImageNet-1k validation pass, 50,000 samples, 1000 classes,
   batch 500: top-1 and macro accuracy, macro F1, macro precision and recall, the
   confusion matrix, macro Jaccard, Matthews, Cohen's kappa, calibration error
   (15 bins), AUROC (100 thresholds) and the micro-averaged PR curve (200 thresholds).
5. ``binary_eval``: a CTR-style pass, 2^22 scores in 16 batches with 1% of targets
   ignored: AUROC and average precision (1000 thresholds), accuracy, F1, the
   confusion matrix, Matthews, Jaccard and calibration error (15 bins).
6. ``retrieval_grouping``: ``_flexible_bincount`` over the query ids of a top-1000
   reranking evaluation at MS MARCO passage dev-small's size, 6,980 queries x 1000
   candidates (6.98 M int32 ids) in a seeded order, through the bincount kernel.
7. ``image_restoration_eval``: a super-resolution validation pass at the size of the
   DIV2K validation set, 100 RGB images of 1356 x 2040, batch 4, 25 steps: SSIM,
   MS-SSIM, PSNR, UQI, sliding-window RMSE (window 8) and the total variation of the
   predictions. It requires 6 launches of the SSIM moments kernel per step (1 for
   SSIM, 5 for the MS-SSIM scales), then holds the card against the CPU on the first
   8 images with fresh metrics on both sides. It reports the kernel's device ms per
   warm step inside the loop (profile) beside its main-path shapes timed alone.
8. ``ssim_gradient``: ``structural_similarity_index_measure(...).backward()`` on one
   2 x 3 x 256 x 256 pair, on the card and on the CPU.

Both eval phases run the same loop again with ``device="cpu"`` and require equal
integer states and floats within 1e-5; the calibration ``bins`` state, whose sums
reach 10^3 where a float32 ulp is 10^-4, within 1e-5 plus a relative 1e-6. Each
phase requires its kernels to have launched. Each eval phase then profiles a few
warm steps on fresh metrics (``torch.profiler``): the device time per step, the
device's busy share of the wall clock and the kernels that take most of it. The
retrieval phase requires the CPU's counts to be equal.
The image phase compares floats within 1e-5 plus 1e-6 of the CPU's value (sums over
images), and the states that sum over pixels (PSNR's squared error, UQI's sum, the
total variation) within 1e-5 relative: float32 sums of ~10^7 terms in another order.
Every phase line carries its wall time; the last four lines are the script's total
wall time, the ``nvidia-smi`` line, a JSON line with every kernel, and
``{"ok": true, "device": {...}}``. Times come from CUDA events over many launches
(inputs warm in L2) or from the host clock around work that ends in a synchronise.
Without a card the script exits non-zero before printing any result.

    python3 chip_smoke.py --kernel-times

builds the kernels and prints only one JSON line: the weighted bincount and the SSIM
moments timed through their public wrappers at the shapes of the ``kernels`` phase
(and three larger SSIM windows), each checked against its plain version on the card,
with the host µs and device kernels per weighted-bincount call and a digest of each
SSIM output. The two wrappers' interfaces have not changed since they were ported, so a
copy of this script run from the root of an earlier revision's checkout times that
revision: running earlier, this, this, earlier in one session compares two revisions.

``bound_ms`` is the larger of the bytes a kernel must move over the memory rate and
its operations over the float32 rate of the data sheet. That rate counts a fused
multiply-add as two operations; the binned-curve kernel's compare and add are one
instruction each, so the card's issue rate for them is about half of it and its
true floor is up to twice ``bound_ms``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores (an FMA counts two)
FLOAT_ATOL = 1e-5
# the calibration state: float32 per-bin sums of up to ~10^3, each step summed in
# float64 and rounded once on the card and on the CPU alike
BINS_RTOL = 1e-6
# the weighted bincount's float rows against its plain version: both sum in float64 and
# round once, so they differ by at most about one float32 ulp whatever the atomics' order
WEIGHTED_RTOL = 1e-6
KERNEL_SOURCES = {
    "confusion_matrix": ("torchmetrics_tpu_torch/ops/csrc/confusion_matrix.cu", "torchmetrics_tpu/ops/pallas_kernels.py:70"),
    "binned_curve_counts": (
        "torchmetrics_tpu_torch/ops/csrc/binned_curve_counts.cu",
        "torchmetrics_tpu/ops/pallas_kernels.py:140",
    ),
    "weighted_bincount": (
        "torchmetrics_tpu_torch/ops/csrc/weighted_bincount.cu",
        "torchmetrics_tpu/ops/pallas_kernels.py:205",
    ),
    "bincount": ("torchmetrics_tpu_torch/ops/csrc/bincount.cu", "torchmetrics_tpu/ops/pallas_kernels.py:267"),
    "ssim_moments": ("torchmetrics_tpu_torch/ops/csrc/ssim_moments.cu", "torchmetrics_tpu/ops/pallas_kernels.py:334"),
}
# the SSIM moments kernel against its plain version, inputs in [0, 1]: float32 window
# sums of up to 71 taps per pass in the same order, the card fusing each multiply-add
MOMENTS_ATOL = 1e-5
# the library yardstick (a float32 convolution, TF32 off) against the plain
# version: another summation order over up to 71 x 71 taps; TF32 would miss by ~1e-3
LIBRARY_CONV_ATOL = 1e-4
# image_restoration_eval: float states that sum over images get 1e-6 of the CPU's
# value on top of FLOAT_ATOL; those that sum over ~10^7 pixels get PIXEL_SUM_RTOL
IMAGE_RTOL = 1e-6
PIXEL_SUM_RTOL = 1e-5
PIXEL_SUMS = ("state.psnr.sum_squared_error", "state.uqi.sum_uqi", "state.tv_preds.score", "value.uqi",
              "value.tv_preds")
# PSNR = 10 log10(range^2 / mse): a relative error e of the squared error moves it by
# 10 / ln(10) * e dB
PSNR_ATOL = FLOAT_ATOL + 10 / 2.302585092994046 * PIXEL_SUM_RTOL
# the SSIM gradient on the card against the CPU: 1e-5 absolute, and 1e-4 of the
# largest gradient, since the gradient of a mean over 3 * 256^2 pixels is ~1e-5
GRAD_ATOL = 1e-5
GRAD_RTOL_OF_MAX = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` back-to-back calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, calls: int = 2000) -> float:
    """Mean host wall time of ``fn()`` in µs over ``calls`` calls, the card drained before and after."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def device_kernels_per_call(fn, trials: int = 5) -> dict:
    """Device kernels (and memsets) that one warm call of ``fn()`` runs, from torch.profiler.

    A trace can miss a kernel, never add one, so the largest count of ``trials``
    single-call traces is the one reported."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = {}
    for _ in range(trials):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and e.count:
                names[e.key[:80]] = names.get(e.key[:80], 0) + e.count
        if sum(names.values()) > sum(best.values()):
            best = names
    return {"per_call": sum(best.values()), "names": best}


# ----------------------------------------------------------------------- kernels


def confusion_matrix_case(n: int, c: int, seed: int, device: str = "cuda"):
    """Labels with 20% invalid samples and about 1% out-of-range preds and targets."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    preds = torch.randint(0, c, (n,), generator=g, device=device, dtype=torch.int32)
    target = torch.randint(0, c, (n,), generator=g, device=device, dtype=torch.int32)
    valid = torch.rand(n, generator=g, device=device) >= 0.2
    bad = torch.rand(n, generator=g, device=device) < 0.01
    preds = torch.where(bad, torch.where(preds % 2 == 0, c, -1), preds).to(torch.int32)
    bad = torch.rand(n, generator=g, device=device) < 0.01
    target = torch.where(bad, torch.where(target % 2 == 0, c + 5, -3), target).to(torch.int32)
    return preds, target, valid


def curve_case(n: int, t: int, seed: int, unsorted_ties: bool = False, device: str = "cuda"):
    """Scores, labels, 20% invalid, and the default grid (or a shuffled grid with exact ties)."""
    import torch

    from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _linspace_thresholds

    g = torch.Generator(device=device).manual_seed(seed)
    thresholds = _linspace_thresholds(t).to(device)
    scores = torch.rand(n, generator=g, device=device)
    if unsorted_ties:
        thresholds = thresholds[torch.randperm(t, generator=g, device=device)]
        tie = torch.rand(n, generator=g, device=device) < 0.5
        pick = torch.randint(0, t, (n,), generator=g, device=device)
        scores = torch.where(tie, thresholds[pick], scores)
    labels = torch.randint(0, 2, (n,), generator=g, device=device, dtype=torch.int32)
    valid = torch.rand(n, generator=g, device=device) >= 0.2
    return scores, labels, valid, thresholds


def kernel_record_confusion_matrix(n: int, c: int, seed: int, main_path: bool) -> dict:
    import torch

    from torchmetrics_tpu_torch.ops import kernels

    preds, target, valid = confusion_matrix_case(n, c, seed)
    before = kernels.LAUNCHES["confusion_matrix"]
    got = kernels.confusion_matrix(preds, target, valid, c)
    torch.cuda.synchronize()
    want = kernels.confusion_matrix_plain(preds.cpu(), target.cpu(), valid.cpu(), c)
    err = int((got.cpu().to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got.cpu(), want):
        raise AssertionError(f"confusion_matrix kernel != plain at N={n}, C={c}: max abs err {err}")
    keep = valid & (preds >= 0) & (preds < c) & (target >= 0) & (target < c)
    code = torch.where(keep, target.long() * c + preds.long(), torch.zeros_like(preds, dtype=torch.long))
    weight = keep.to(torch.float32)
    library = torch.bincount(code, weights=weight, minlength=c * c).reshape(c, c)
    if not torch.equal(library.cpu().to(torch.int32), want):
        raise AssertionError("the torch.bincount yardstick disagrees with the plain version")
    record = {
        "kernel": "confusion_matrix", "n": n, "classes": c, "main_path": main_path, "max_abs_err": err,
        "kernel_ms": time_ms(lambda: kernels.confusion_matrix(preds, target, valid, c)),
        "plain_ms": time_ms(lambda: kernels.confusion_matrix_plain(preds, target, valid, c)),
        "library_ms": time_ms(lambda: torch.bincount(code, weights=weight, minlength=c * c)),
        "bound_ms": (n * (4 + 4 + 1) + c * c * 4) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
    }
    return {**record, "launches": kernels.LAUNCHES["confusion_matrix"] - before}


def kernel_record_curve(n: int, t: int, seed: int, main_path: bool, unsorted_ties: bool = False) -> dict:
    import torch

    from torchmetrics_tpu_torch.ops import kernels

    scores, labels, valid, thresholds = curve_case(n, t, seed, unsorted_ties)
    before = kernels.LAUNCHES["binned_curve_counts"]
    got = kernels.binned_curve_counts(scores, labels, valid, thresholds)
    torch.cuda.synchronize()
    want = kernels.binned_curve_counts_plain(scores.cpu(), labels.cpu(), valid.cpu(), thresholds.cpu())
    err = int((got.cpu().to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got.cpu(), want):
        raise AssertionError(f"binned_curve_counts kernel != plain at N={n}, T={t}: max abs err {err}")
    byte_ms = (n * (4 + 4 + 1) + t * 4 + t * 2 * 4) / HBM_BYTES_PER_S * 1e3
    op_ms = 2.0 * n * t / FP32_OPS_PER_S * 1e3
    record = {
        "kernel": "binned_curve_counts", "n": n, "thresholds": t, "unsorted_ties": unsorted_ties,
        "main_path": main_path, "max_abs_err": err,
        "kernel_ms": time_ms(lambda: kernels.binned_curve_counts(scores, labels, valid, thresholds)),
        "plain_ms": time_ms(lambda: kernels.binned_curve_counts_plain(scores, labels, valid, thresholds), reps=3),
        "library_ms": None,
        "bound_ms": max(byte_ms, op_ms),
        "bound_by": "operations" if op_ms >= byte_ms else "bytes",
    }
    return {**record, "launches": kernels.LAUNCHES["binned_curve_counts"] - before}


def weighted_case(n: int, k: int, c: int, seed: int, device: str = "cuda"):
    """Indices with about 1% outside [0, C); K weight rows, the last a 0/1 count row and
    the others floats in [0, 1), each with 20% zeros (calibration's rows are
    confidence * valid, accuracy * valid and valid)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(0, c, (n,), generator=g, device=device, dtype=torch.int32)
    bad = torch.rand(n, generator=g, device=device) < 0.01
    x = torch.where(bad, torch.where(x % 2 == 0, c + 7, -1), x).to(torch.int32)
    keep = (torch.rand((k, n), generator=g, device=device) >= 0.2).to(torch.float32)
    w = torch.rand((k, n), generator=g, device=device) * keep
    w[-1] = keep[-1]
    return x, w


def kernel_record_weighted_bincount(n: int, k: int, c: int, seed: int, main_path: bool) -> dict:
    """Also: the device kernels one call runs (torch.profiler; it must be one) and the
    host µs of each step of a call."""
    import torch

    from torchmetrics_tpu_torch.ops import kernels

    x, w = weighted_case(n, k, c, seed)
    before = kernels.LAUNCHES["weighted_bincount"]
    got = kernels.weighted_bincount(x, w, c)
    torch.cuda.synchronize()
    got = got.cpu()
    want = kernels.weighted_bincount_plain(x.cpu(), w.cpu(), c)
    err = float((got.to(torch.float64) - want.to(torch.float64)).abs().max())
    if not torch.equal(got[-1], want[-1]):
        raise AssertionError(f"weighted_bincount count row != plain at N={n}, K={k}, C={c}")
    torch.testing.assert_close(got, want, rtol=WEIGHTED_RTOL, atol=0)
    # the yardstick: one index_add_ over the same function's in-range samples (an index
    # outside [0, C) would fail it on the card)
    in_range = (x >= 0) & (x < c)
    x_lib = torch.where(in_range, x, torch.zeros_like(x))
    w_lib = w * in_range
    library = torch.zeros((k, c), device=w.device).index_add_(1, x_lib, w_lib)
    torch.testing.assert_close(library.cpu(), want, rtol=1e-3, atol=1e-2)  # float32 atomics, in any order
    record = {
        "kernel": "weighted_bincount", "n": n, "rows": k, "bins": c, "main_path": main_path, "max_abs_err": err,
        "kernel_ms": time_ms(lambda: kernels.weighted_bincount(x, w, c)),
        "plain_ms": time_ms(lambda: kernels.weighted_bincount_plain(x, w, c)),
        "library_ms": time_ms(lambda: torch.zeros((k, c), device=w.device).index_add_(1, x_lib, w_lib)),
        "bound_ms": (n * (4 + 4 * k) + k * c * 4) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
    }
    kernels_per_call = device_kernels_per_call(lambda: kernels.weighted_bincount(x, w, c))
    if kernels_per_call["per_call"] != 1 or any("weighted_bincount_kernel" not in name
                                                for name in kernels_per_call["names"]):
        raise AssertionError(f"weighted_bincount ran {kernels_per_call} device kernels per call, not one")
    record["device_kernels_per_call"] = kernels_per_call["per_call"]
    record["device_kernels"] = kernels_per_call["names"]
    record["host_us"] = weighted_host_breakdown(x, w, c, calls=500)
    return {**record, "launches": kernels.LAUNCHES["weighted_bincount"] - before}


def weighted_host_breakdown(x, w, c: int, calls: int = 2000) -> dict:
    """Host µs per call of each step of ``kernels.weighted_bincount`` on these inputs,
    each step timed alone over ``calls`` calls, and of the whole call."""
    import torch

    from torchmetrics_tpu_torch.ops import kernels

    index = w.get_device()
    k, n = w.shape
    stream = kernels._raw_stream(index)
    scratch = kernels._weighted_scratch(index, stream, k, c)
    out = w.new_empty((k, c))
    fn = kernels._entry_point("weighted_bincount")
    args = (x.data_ptr(), w.data_ptr(), n, k, c, scratch.data_ptr(), out.data_ptr(), stream)
    return {
        "checks_and_casts": host_us(lambda: (kernels._on_card(x, w), x.dim() != 1, x.dtype != torch.int32,
                                             x.is_contiguous(), w.dtype != torch.float32, w.is_contiguous(),
                                             w.ndim != 2 or w.shape[1] != x.numel()), calls),
        "empty_out": host_us(lambda: w.new_empty((k, c)), calls),
        "stream_lookup": host_us(lambda: (w.get_device(), torch.cuda.current_device(), kernels._raw_stream(index)),
                                 calls),
        "scratch_lookup": host_us(lambda: kernels._weighted_scratch(index, stream, k, c), calls),
        "ctypes_call_and_launch": host_us(lambda: fn(*args), calls),
        "whole_call": host_us(lambda: kernels.weighted_bincount(x, w, c), calls),
    }


def query_ids(queries: int = 6980, candidates: int = 1000, seed: int = 9, device: str = "cuda"):
    """int32 query ids of a top-``candidates`` reranking run, ``candidates`` per query,
    in a seeded order."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    ids = torch.arange(queries, device=device, dtype=torch.int32).repeat_interleave(candidates)
    return ids[torch.randperm(ids.numel(), generator=g, device=device)]


def kernel_record_bincount(n: int, c: int, seed: int, main_path: bool) -> dict:
    import torch

    from torchmetrics_tpu_torch.ops import kernels

    if main_path:
        x = query_ids(c, n // c, seed)
    else:
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randint(0, c, (n,), generator=g, device="cuda", dtype=torch.int32)
    before = kernels.LAUNCHES["bincount"]
    got = kernels.bincount(x, None, c)
    torch.cuda.synchronize()
    want = kernels.bincount_plain(x.cpu(), c)
    err = int((got.cpu().to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got.cpu(), want):
        raise AssertionError(f"bincount kernel != plain at N={n}, C={c}: max abs err {err}")
    if not torch.equal(torch.bincount(x, minlength=c).cpu().to(torch.int32), want):
        raise AssertionError("the torch.bincount yardstick disagrees with the plain version")
    record = {
        "kernel": "bincount", "n": n, "bins": c, "main_path": main_path, "max_abs_err": err,
        "kernel_ms": time_ms(lambda: kernels.bincount(x, None, c)),
        "plain_ms": time_ms(lambda: kernels.bincount_plain(x, c)),
        "library_ms": time_ms(lambda: torch.bincount(x, minlength=c)),
        "bound_ms": (n * 4 + c * 4) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
    }
    return {**record, "launches": kernels.LAUNCHES["bincount"] - before}


def _window(kind: str, size: int, sigma: float, device: str = "cuda"):
    """A 1D SSIM window: the port's cached gaussian, or a uniform one."""
    import torch

    from torchmetrics_tpu_torch.functional.image.utils import _gaussian

    if kind == "uniform":
        return torch.full((size,), 1.0 / size, device=device)
    return _gaussian(size, sigma, torch.float32, device)[0]


def kernel_record_ssim_moments(planes: int, hp: int, wp: int, window_h: tuple, window_w: tuple, seed: int,
                               main_path: bool, nan: bool = False) -> dict:
    """Padded planes in [0, 1] (one NaN pixel with ``nan``); the yardstick is the grouped
    convolution of the JAX package's conv branch over the stacked products, timed alone."""
    import torch
    import torch.nn.functional as F

    from torchmetrics_tpu_torch.functional.image.utils import _full_float32
    from torchmetrics_tpu_torch.ops import kernels

    g = torch.Generator(device="cuda").manual_seed(seed)
    p = torch.rand(planes, hp, wp, generator=g, device="cuda")
    t = torch.rand(planes, hp, wp, generator=g, device="cuda")
    if nan:
        p[0, hp // 2, wp // 3] = float("nan")
    wh, ww = _window(*window_h), _window(*window_w)
    kh, kw = wh.numel(), ww.numel()
    ho, wo = hp - kh + 1, wp - kw + 1
    before = kernels.LAUNCHES["ssim_moments"]
    got = kernels.ssim_moments(p, t, wh, ww)
    torch.cuda.synchronize()
    got = got.cpu()
    want = kernels.ssim_moments_plain(p.cpu(), t.cpu(), wh.cpu(), ww.cpu())
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise AssertionError(f"ssim_moments kernel spreads NaN unlike the plain version at P={planes}, {hp}x{wp}")
    if nan:  # E[p], E[p^2] and E[pt] are NaN at every output whose window reads the pixel
        y, x = hp // 2, wp // 3
        reach = (min(y, ho - 1) - max(0, y - kh + 1) + 1) * (min(x, wo - 1) - max(0, x - kw + 1) + 1)
        if int(torch.isnan(want).sum()) != 3 * reach:
            raise AssertionError("the NaN pixel did not reach the moments whose windows read it")
    err = float(torch.nan_to_num((got - want).abs(), nan=0.0).max())
    if err > MOMENTS_ATOL:
        raise AssertionError(f"ssim_moments kernel != plain at P={planes}, {hp}x{wp}, {kh}x{kw}: max abs err {err}")

    channels = 3 if planes % 3 == 0 else 1
    stacked = torch.stack((p, t, p * p, t * t, p * t)).reshape(5 * planes // channels, channels, hp, wp)
    kernel2d = (wh[:, None] * ww[None, :]).expand(channels, 1, kh, kw).contiguous()

    def library():
        with _full_float32():
            return F.conv2d(stacked, kernel2d, groups=channels)

    lib = library().reshape(5, planes, ho, wo).transpose(0, 1).cpu()
    finite = ~torch.isnan(want)
    library_err = float((lib - want).abs()[finite].max())
    if library_err > LIBRARY_CONV_ATOL:
        raise AssertionError(f"the float32 convolution yardstick disagrees with the plain version: {library_err}")
    big = planes * hp * wp > 1 << 24
    byte_ms = (2 * planes * hp * wp + planes * 5 * ho * wo + kh + kw) * 4 / HBM_BYTES_PER_S * 1e3
    op_ms = (2 * planes * 5 * (ho * wp * kh + ho * wo * kw) + 3 * planes * hp * wp) / FP32_OPS_PER_S * 1e3
    kernel_ms = time_ms(lambda: kernels.ssim_moments(p, t, wh, ww), reps=10 if big else 20)
    record = {
        "kernel": "ssim_moments", "planes": planes, "hp": hp, "wp": wp, "kh": kh, "kw": kw, "nan": nan,
        "main_path": main_path, "max_abs_err": err, "library_max_abs_err": library_err,
        "kernel_ms": kernel_ms,
        "plain_ms": time_ms(lambda: kernels.ssim_moments_plain(p, t, wh, ww), reps=3, warmup=1),
        "library_ms": time_ms(library, reps=5 if big else 20, warmup=1),
        "library": "F.conv2d over the stacked products, groups=C, TF32 off, the convolution alone",
        "bound_ms": max(byte_ms, op_ms),
        "bound_by": "operations" if op_ms >= byte_ms else "bytes",
        # the bytes it must move over its time, and its bound over its time
        "gb_per_s": byte_ms / kernel_ms * HBM_BYTES_PER_S / 1e9,
        "bound_share": max(byte_ms, op_ms) / kernel_ms,
    }
    return {**record, "launches": kernels.LAUNCHES["ssim_moments"] - before}


# -------------------------------------------------------------------------- evals


def imagenet_metrics(device: str) -> dict:
    from torchmetrics_tpu_torch import classification as tc

    c = 1000
    kw = {"validate_args": False, "device": device}
    return {
        "accuracy_top1": tc.MulticlassAccuracy(c, average="micro", **kw),
        "accuracy_macro": tc.MulticlassAccuracy(c, average="macro", **kw),
        "f1_macro": tc.MulticlassF1Score(c, average="macro", **kw),
        "precision_macro": tc.MulticlassPrecision(c, average="macro", **kw),
        "recall_macro": tc.MulticlassRecall(c, average="macro", **kw),
        "confusion_matrix": tc.MulticlassConfusionMatrix(c, **kw),
        "jaccard_macro": tc.MulticlassJaccardIndex(c, average="macro", **kw),
        "matthews": tc.MulticlassMatthewsCorrCoef(c, **kw),
        "cohen_kappa": tc.MulticlassCohenKappa(c, **kw),
        "calibration_error_b15": tc.MulticlassCalibrationError(c, n_bins=15, **kw),
        "auroc_t100": tc.MulticlassAUROC(c, thresholds=100, **kw),
        "pr_curve_micro_t200": tc.MulticlassPrecisionRecallCurve(c, average="micro", thresholds=200, **kw),
    }


def imagenet_data(n: int = 50_000, c: int = 1000, seed: int = 0, device: str = "cuda"):
    """Seeded logits with a signal on the true class; the metrics get their softmax.

    The softmax runs once, on the card, as a model's head would: the card's run and
    the CPU run then score the same probability bits.
    """
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    target = torch.randint(0, c, (n,), generator=g, device=device)
    logits = torch.randn(n, c, generator=g, device=device)
    logits[torch.arange(n, device=device), target] += 3.0
    return torch.softmax(logits, dim=1), target


def binary_metrics(device: str) -> dict:
    from torchmetrics_tpu_torch import classification as tc

    kw = {"validate_args": False, "device": device, "ignore_index": -1}
    return {
        "auroc_t1000": tc.BinaryAUROC(thresholds=1000, **kw),
        "accuracy": tc.BinaryAccuracy(**kw),
        "f1": tc.BinaryF1Score(**kw),
        "confusion_matrix": tc.BinaryConfusionMatrix(**kw),
        "average_precision_t1000": tc.BinaryAveragePrecision(thresholds=1000, **kw),
        "matthews": tc.BinaryMatthewsCorrCoef(**kw),
        "jaccard": tc.BinaryJaccardIndex(**kw),
        "calibration_error_b15": tc.BinaryCalibrationError(n_bins=15, **kw),
    }


def binary_data(n: int = 1 << 22, seed: int = 1, device: str = "cuda"):
    """Click labels, 1% ignored (-1), and the sigmoid of seeded logits as scores."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    target = torch.randint(0, 2, (n,), generator=g, device=device)
    logits = torch.randn(n, generator=g, device=device) + 1.2 * target - 0.6
    target = torch.where(torch.rand(n, generator=g, device=device) < 0.01, -1, target)
    return torch.sigmoid(logits), target


def run_loop(metrics: dict, preds, target, batch: int):
    """Update every metric batch by batch, then compute; returns (values, states, seconds)."""
    import torch

    cuda = preds.is_cuda
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for start in range(0, preds.shape[0], batch):
        p, t = preds[start:start + batch], target[start:start + batch]
        for m in metrics.values():
            m.update(p, t)
    values = {name: m.compute() for name, m in metrics.items()}
    if cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    states = {name: m.state_dict(persistent_only=False) for name, m in metrics.items()}
    return values, states, seconds


def _classification_tolerance(where: str):
    return FLOAT_ATOL, BINS_RTOL if where.endswith(".bins") else 0.0


def compare(card, cpu, where: str, tolerance=_classification_tolerance) -> float:
    """Integers (and thresholds) equal, floats within ``tolerance(where)`` = (atol, rtol of
    the CPU's value): FLOAT_ATOL, plus BINS_RTOL for a calibration ``bins`` state, in the
    classification phases. Returns the largest float gap."""
    import torch

    if isinstance(card, dict):
        return max([compare(card[k], cpu[k], f"{where}.{k}", tolerance) for k in card] or [0.0])
    if isinstance(card, (list, tuple)):
        return max([compare(a, b, f"{where}[{i}]", tolerance)
                    for i, (a, b) in enumerate(zip(card, cpu, strict=True))] or [0.0])
    a, b = card.cpu(), cpu
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{where}: card {tuple(a.shape)} {a.dtype} vs cpu {tuple(b.shape)} {b.dtype}")
    if not a.is_floating_point():
        if not torch.equal(a, b):
            raise AssertionError(f"{where}: integer state differs between the card and the CPU")
        return 0.0
    if not a.numel():
        return 0.0
    both_nan = torch.isnan(a) & torch.isnan(b)
    diff = torch.where(both_nan, torch.zeros_like(a), (a - b).abs())
    atol, rtol = tolerance(where)
    excess = diff - (atol + rtol * b.abs())
    if not bool((excess <= 0).all()):
        raise AssertionError(f"{where}: float gap {float(diff.max())} over {atol} + {rtol} * |cpu|")
    return float(diff.max())


def eval_phase(name: str, metrics_fn, data, batch: int, required: tuple, profile_steps: int) -> dict:
    """Drive the main path on the card with fresh launch counts, then the same loop on the CPU."""
    from torchmetrics_tpu_torch.ops import kernels

    preds, target = data
    steps = -(-preds.shape[0] // batch)
    card_metrics = metrics_fn("cuda")
    kernels.reset_launch_counts()
    card_values, card_states, seconds = run_loop(card_metrics, preds, target, batch)
    launches = dict(kernels.LAUNCHES)
    for kernel in required:
        if launches[kernel] <= 0:
            raise AssertionError(f"{name}: kernel {kernel} was never launched on the main path")

    cpu_values, cpu_states, cpu_seconds = run_loop(metrics_fn("cpu"), preds.cpu(), target.cpu(), batch)
    gaps = {
        metric: {"state": compare(card_states[metric], cpu_states[metric], f"state.{metric}"),
                 "value": compare(card_values[metric], cpu_values[metric], f"value.{metric}")}
        for metric in card_states
    }
    summary = {}
    for metric, value in card_values.items():
        if isinstance(value, tuple):  # a curve: report its size
            summary[metric] = {"points": int(value[0].numel())}
        elif value.numel() == 1:
            summary[metric] = float(value)
        else:
            summary[metric] = {"shape": list(value.shape), "sum": int(value.sum())}
    return {
        "phase": name, "samples": int(preds.shape[0]), "batch": batch, "steps": steps,
        "wall_s": seconds, "us_per_step": seconds / steps * 1e6, "launches": launches,
        "cpu_compared_steps": steps, "cpu_wall_s": cpu_seconds, "max_float_gap": max(max(g.values()) for g in gaps.values()),
        "float_gaps": {metric: g for metric, g in gaps.items() if any(g.values())}, "values": summary,
        "profile": profile_loop(metrics_fn("cuda"), preds, target, batch, profile_steps),
    }


class PredsOnly:
    """Feeds a one-input metric (total variation) the predictions of an eval loop."""

    def __init__(self, metric):
        self.metric = metric

    def update(self, preds, target) -> None:
        self.metric.update(preds)

    def compute(self):
        return self.metric.compute()

    def state_dict(self, persistent_only: bool = True) -> dict:
        return self.metric.state_dict(persistent_only=persistent_only)


def image_metrics(device: str) -> dict:
    from torchmetrics_tpu_torch import image as ti

    kw = {"device": device}
    return {
        "ssim": ti.StructuralSimilarityIndexMeasure(data_range=1.0, **kw),
        "ms_ssim": ti.MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, **kw),
        "psnr": ti.PeakSignalNoiseRatio(data_range=1.0, **kw),
        "uqi": ti.UniversalImageQualityIndex(**kw),
        "rmse_sw": ti.RootMeanSquaredErrorUsingSlidingWindow(window_size=8, **kw),
        "tv_preds": PredsOnly(ti.TotalVariation(**kw)),
    }


def image_data(n: int = 100, height: int = 1356, width: int = 2040, seed: int = 21, device: str = "cuda"):
    """A seeded smooth RGB field in [0, 1] (bicubic over a coarse random grid) as the
    target, and the target plus gaussian noise of sigma 0.05, clipped, as the output
    of a restoration model. Made on the card in bulk: about 3.3 GB per tensor."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device=device).manual_seed(seed)
    coarse = torch.rand(n, 3, height // 40, width // 40, generator=g, device=device)
    target = F.interpolate(coarse, size=(height, width), mode="bicubic", align_corners=False).clamp_(0, 1)
    noise = torch.randn(target.shape, generator=g, device=device)
    preds = noise.mul_(0.05).add_(target).clamp_(0, 1)
    return preds, target


def _image_tolerance(where: str):
    if where in PIXEL_SUMS:
        return FLOAT_ATOL, PIXEL_SUM_RTOL
    if where == "value.psnr":
        return PSNR_ATOL, 0.0
    return FLOAT_ATOL, IMAGE_RTOL


# padded planes of MS-SSIM's scales 3 to 5 at the DIV2K size (1356 x 2040 halved, then
# padded by 5 on each side)
MS_SSIM_SMALL_SCALES = ((349, 520), (179, 265), (94, 137))


def k5_ms_per_step_alone(records: list) -> float:
    """K5's device ms per step of the image loop, from its main-path shapes timed alone:
    the full-size planes twice (SSIM and MS-SSIM's first scale), each smaller scale once."""
    full = [r for r in records if r["kernel"] == "ssim_moments" and r["main_path"]]
    return 2 * full[0]["kernel_ms"] + sum(r["kernel_ms"] for r in full[1:])


def image_phase(batch: int = 4, cpu_images: int = 8, profile_steps: int = 3,
                ssim_alone_ms: float | None = None) -> dict:
    """The restoration eval loop on the card, then the card against the CPU on the first images.
    Reports K5's device ms per warm step in the loop (profile) beside ``ssim_alone_ms``."""
    import torch

    from torchmetrics_tpu_torch.ops import kernels

    preds, target = image_data()
    steps = -(-preds.shape[0] // batch)
    card_metrics = image_metrics("cuda")
    kernels.reset_launch_counts()
    card_values, _, seconds = run_loop(card_metrics, preds, target, batch)
    launches = dict(kernels.LAUNCHES)
    if launches["ssim_moments"] != 6 * steps:
        raise AssertionError(f"image_restoration_eval: {launches['ssim_moments']} ssim_moments launches, "
                             f"expected 6 per step over {steps} steps")
    for name, value in card_values.items():
        if not bool(torch.isfinite(value).all()):
            raise AssertionError(f"image_restoration_eval: {name} is not finite: {value}")
    if not 0.0 < float(card_values["ssim"]) <= 1.0 or not 0.0 < float(card_values["ms_ssim"]) <= 1.0:
        raise AssertionError("image_restoration_eval: SSIM or MS-SSIM outside (0, 1]")

    # a trace can drop a launch now and then: K5's time per step in the loop is taken
    # from a trace that holds all 6 per step, retried up to three times
    for _ in range(3):
        profile = profile_loop(image_metrics("cuda"), preds, target, batch, profile_steps,
                               track="ssim_moments_kernel")
        if profile["tracked"]["calls"] == 6 * profile_steps:
            break
    p8, t8 = preds[:cpu_images], target[:cpu_images]
    card8_values, card8_states, _ = run_loop(image_metrics("cuda"), p8, t8, batch)
    cpu_values, cpu_states, cpu_seconds = run_loop(image_metrics("cpu"), p8.cpu(), t8.cpu(), batch)
    gaps = {}
    for metric in card8_states:
        for key, value in card8_states[metric].items():
            where = f"state.{metric}.{key}"
            gaps[where] = compare(value, cpu_states[metric][key], where, _image_tolerance)
        where = f"value.{metric}"
        gaps[where] = compare(card8_values[metric], cpu_values[metric], where, _image_tolerance)
    return {
        "phase": "image_restoration_eval", "images": int(preds.shape[0]), "image_shape": list(preds.shape[1:]),
        "batch": batch, "steps": steps, "wall_s": seconds, "us_per_step": seconds / steps * 1e6,
        "launches": launches, "values": {name: float(v) for name, v in card_values.items()},
        "cpu_compared_images": cpu_images, "cpu_wall_s": cpu_seconds, "gaps": gaps,
        "values_first_images": {name: float(v) for name, v in cpu_values.items()},
        "profile": profile,
        # null unless the trace held every launch of its steps
        "k5_ms_per_step_in_loop": (profile["tracked"]["ms_per_step"]
                                   if profile["tracked"]["calls"] == 6 * profile_steps else None),
        "k5_launches_traced": profile["tracked"]["calls"], "k5_launches_run": 6 * profile_steps,
        "k5_ms_per_step_alone": ssim_alone_ms,
    }


def gradient_phase() -> dict:
    """``structural_similarity_index_measure(...).backward()`` on the card and on the CPU."""
    import torch

    from torchmetrics_tpu_torch.functional.image import structural_similarity_index_measure
    from torchmetrics_tpu_torch.ops import kernels

    preds, target = image_data(n=2, height=256, width=256, seed=31)
    grads, values = [], []
    before = kernels.LAUNCHES["ssim_moments"]
    for device in ("cuda", "cpu"):
        x = preds.detach().to(device).requires_grad_()
        value = structural_similarity_index_measure(x, target.to(device), data_range=1.0)
        value.backward()
        grads.append(x.grad.cpu())
        values.append(float(value.detach()))
    launches = kernels.LAUNCHES["ssim_moments"] - before
    if launches != 1:
        raise AssertionError(f"ssim_gradient: expected one ssim_moments launch, got {launches}")
    gap = float((grads[0] - grads[1]).abs().max())
    largest = float(grads[1].abs().max())
    if not bool(torch.isfinite(grads[0]).all()) or gap > GRAD_ATOL or gap > GRAD_RTOL_OF_MAX * largest:
        raise AssertionError(f"ssim_gradient: card vs CPU gap {gap} (largest gradient {largest})")
    return {"phase": "ssim_gradient", "shape": list(preds.shape), "ssim_card": values[0], "ssim_cpu": values[1],
            "max_grad_gap": gap, "max_abs_grad": largest, "launches": launches}


def retrieval_phase() -> dict:
    """Group the query ids of a reranking run with ``_flexible_bincount`` on the card and on the CPU."""
    import torch

    from torchmetrics_tpu_torch.ops import kernels
    from torchmetrics_tpu_torch.utils.data import _flexible_bincount

    ids = query_ids()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts = _flexible_bincount(ids)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if launches["bincount"] <= 0:
        raise AssertionError("retrieval_grouping: kernel bincount was never launched on the main path")
    t0 = time.perf_counter()
    cpu_counts = _flexible_bincount(ids.cpu())
    cpu_seconds = time.perf_counter() - t0
    if not torch.equal(counts.cpu(), cpu_counts):
        raise AssertionError("retrieval_grouping: the card's counts differ from the CPU's")
    if counts.numel() != 6980 or not bool((counts == 1000).all()):
        raise AssertionError("retrieval_grouping: expected 6,980 groups of 1000 candidates")
    warm = []
    for _ in range(5):  # the same call again, with the card's allocator and sort warm
        t0 = time.perf_counter()
        _flexible_bincount(ids)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    return {
        "phase": "retrieval_grouping", "ids": int(ids.numel()), "groups": int(counts.numel()),
        "wall_s": seconds, "warm_wall_s_min": min(warm), "cpu_wall_s": cpu_seconds, "launches": launches,
    }


def profile_loop(metrics: dict, preds, target, batch: int, steps: int, track: str | None = None) -> dict:
    """Device time by kernel over ``steps`` warm steps of an eval loop, from torch.profiler.
    With ``track``, also the device ms per step and the traced calls of the kernels whose
    name holds it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def loop(n):
        for i in range(n):
            p, t = preds[i * batch:(i + 1) * batch], target[i * batch:(i + 1) * batch]
            for m in metrics.values():
                m.update(p, t)
        torch.cuda.synchronize()

    loop(2)  # warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop(steps)
        wall = time.perf_counter() - t0
    kernels_by_time = {}
    for e in prof.key_averages():
        device_us = getattr(e, "self_device_time_total", 0) or 0
        if device_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            kernels_by_time[e.key] = (device_us, e.count)
    total_device_us = sum(us for us, _ in kernels_by_time.values())
    top = sorted(kernels_by_time.items(), key=lambda kv: -kv[1][0])[:10]
    result = {
        "steps": steps, "wall_ms_per_step": wall / steps * 1e3,
        "device_ms_per_step": total_device_us / steps / 1e3,
        "device_busy_share": total_device_us / 1e6 / wall if wall else None,
        "top_kernels": [{"name": k[:90], "ms_per_step": us / steps / 1e3, "calls": n} for k, (us, n) in top],
    }
    if track:
        mine = [v for k, v in kernels_by_time.items() if track in k]
        result["tracked"] = {"name": track, "ms_per_step": sum(us for us, _ in mine) / steps / 1e3,
                             "calls": sum(n for _, n in mine)}
    return result


# ------------------------------------------------------------------ kernel times

WEIGHTED_SHAPES = [(500, 3, 15), (1 << 18, 3, 15)] + [(1 << 20, k, c) for c in (15, 1000, 8192) for k in (1, 3)]
GAUSS11 = ("gauss", 11, 1.5)
SSIM_SHAPES = [(12, 1366, 2050, GAUSS11, GAUSS11), (12, 688, 1030, GAUSS11, GAUSS11),
               (12, 349, 520, GAUSS11, GAUSS11), (12, 179, 265, GAUSS11, GAUSS11), (12, 94, 137, GAUSS11, GAUSS11),
               (12, 522, 534, GAUSS11, ("gauss", 23, 3.0)), (3, 326, 326, ("gauss", 71, 10.0), ("gauss", 71, 10.0)),
               (2, 90, 400, ("gauss", 5, 1.0), ("gauss", 151, 21.5))]


def kernel_times() -> dict:
    """The weighted bincount and the SSIM moments through their public wrappers only."""
    import hashlib

    import torch

    from torchmetrics_tpu_torch.ops import kernels

    weighted = []
    for n, k, c in WEIGHTED_SHAPES:
        x, w = weighted_case(n, k, c, seed=13 + k + c)
        got = kernels.weighted_bincount(x, w, c).cpu()
        want = kernels.weighted_bincount_plain(x.cpu(), w.cpu(), c)
        if not torch.equal(got[-1], want[-1]):
            raise AssertionError(f"weighted_bincount count row != plain at N={n}, K={k}, C={c}")
        torch.testing.assert_close(got, want, rtol=WEIGHTED_RTOL, atol=0)
        weighted.append({
            "n": n, "rows": k, "bins": c, "kernel_ms": time_ms(lambda: kernels.weighted_bincount(x, w, c), reps=200),
            "host_us_per_call": host_us(lambda: kernels.weighted_bincount(x, w, c)),
            "device_kernels_per_call": device_kernels_per_call(lambda: kernels.weighted_bincount(x, w, c)),
        })
    # what the steps of a wrapper cost alone at the ImageNet step's shape: the casts, a
    # float64 and an int32 zero fill, an empty output and a torch.cuda.Stream object
    x, w = weighted_case(500, 3, 15, seed=11)
    device = w.device
    torch_steps_us = {
        "casts": host_us(lambda: (x.reshape(-1).to(torch.int32).contiguous(), w.to(torch.float32).contiguous())),
        "zeros_float64_k_c": host_us(lambda: torch.zeros((3, 15), dtype=torch.float64, device=device)),
        "zeros_int32_k_plus_k_c": host_us(lambda: torch.zeros(3 + 3 * 15, dtype=torch.int32, device=device)),
        "empty_float32_k_c": host_us(lambda: torch.empty((3, 15), dtype=torch.float32, device=device)),
        "current_stream_object": host_us(lambda: torch.cuda.current_stream(device).cuda_stream),
    }
    ssim = []
    for planes, hp, wp, window_h, window_w in SSIM_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(hp)
        p = torch.rand(planes, hp, wp, generator=g, device="cuda")
        t = torch.rand(planes, hp, wp, generator=g, device="cuda")
        wh, ww = _window(*window_h), _window(*window_w)
        got = kernels.ssim_moments(p, t, wh, ww)
        err = float((got - kernels.ssim_moments_plain(p, t, wh, ww)).abs().max())
        if err > MOMENTS_ATOL:
            raise AssertionError(f"ssim_moments != plain at P={planes}, {hp}x{wp}: max abs err {err}")
        big = planes * hp * wp > 1 << 24
        ssim.append({
            "planes": planes, "hp": hp, "wp": wp, "kh": wh.numel(), "kw": ww.numel(), "max_abs_err": err,
            "kernel_ms": time_ms(lambda: kernels.ssim_moments(p, t, wh, ww), reps=10 if big else 20),
            "sha256_16": hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16],
        })
        del got
    return {"phase": "kernel_times", "weighted_bincount": weighted, "torch_steps_us": torch_steps_us,
            "ssim_moments": ssim}


# --------------------------------------------------------------------------- main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torchmetrics_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "cuda": torch.version.cuda, "torch": torch.__version__})

    script_t0 = time.perf_counter()
    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "sources": {
        name: {"seconds": rec["seconds"], "ptxas": [line.strip() for line in rec["log"].splitlines() if "Used" in line]}
        for name, rec in _build.BUILD_LOG.items()
    }})
    if "--kernel-times" in sys.argv[1:]:
        emit({**kernel_times(), "card": smi, "root": os.path.dirname(os.path.abspath(__file__))})
        return 0
    t0 = time.perf_counter()
    records = [kernel_record_confusion_matrix(1 << 20, c, seed=c, main_path=False) for c in (10, 100, 1000)]
    records.append(kernel_record_confusion_matrix(500, 1000, seed=7, main_path=True))
    records.append(kernel_record_confusion_matrix(1 << 18, 2, seed=8, main_path=True))
    records += [kernel_record_curve(1 << 20, t, seed=t, main_path=False) for t in (100, 1000)]
    records.append(kernel_record_curve(1 << 20, 200, seed=3, main_path=False, unsorted_ties=True))
    records.append(kernel_record_curve(500 * 1000, 200, seed=4, main_path=True))
    records.append(kernel_record_curve(1 << 18, 1000, seed=5, main_path=True))
    records.append(kernel_record_weighted_bincount(500, 3, 15, seed=11, main_path=True))
    records.append(kernel_record_weighted_bincount(1 << 18, 3, 15, seed=12, main_path=True))
    records += [kernel_record_weighted_bincount(1 << 20, k, c, seed=13 + k + c, main_path=False)
                for c in (15, 1000, 8192) for k in (1, 3)]
    records.append(kernel_record_bincount(6980 * 1000, 6980, seed=9, main_path=True))
    records += [kernel_record_bincount(1 << 20, c, seed=c, main_path=False) for c in (100, 8192, 1 << 16)]
    # main path: 4 DIV2K validation images (12 planes) padded by 5, then the first MS-SSIM scale
    records.append(kernel_record_ssim_moments(12, 1366, 2050, GAUSS11, GAUSS11, seed=51, main_path=True))
    records.append(kernel_record_ssim_moments(12, 688, 1030, GAUSS11, GAUSS11, seed=52, main_path=True))
    # the three smaller MS-SSIM scales, for K5's time per step of the image loop timed alone
    records += [kernel_record_ssim_moments(12, hp, wp, GAUSS11, GAUSS11, seed=60 + i, main_path=True)
                for i, (hp, wp) in enumerate(MS_SSIM_SMALL_SCALES)]
    records += [
        kernel_record_ssim_moments(3, 42, 42, ("uniform", 7, 0.0), ("uniform", 7, 0.0), seed=53, main_path=False),
        kernel_record_ssim_moments(48, 266, 266, GAUSS11, GAUSS11, seed=54, main_path=False),
        kernel_record_ssim_moments(12, 522, 534, GAUSS11, ("gauss", 23, 3.0), seed=55, main_path=False),
        kernel_record_ssim_moments(3, 326, 326, ("gauss", 71, 10.0), ("gauss", 71, 10.0), seed=56, main_path=False),
        kernel_record_ssim_moments(2, 90, 400, ("gauss", 5, 1.0), ("gauss", 151, 21.5), seed=57, main_path=False),
        kernel_record_ssim_moments(5, 77, 101, GAUSS11, GAUSS11, seed=58, main_path=False),
        kernel_record_ssim_moments(1, 266, 266, GAUSS11, GAUSS11, seed=59, main_path=False, nan=True),
    ]
    emit({"phase": "kernels", "card": smi, "l2": "warm below 50 MB of inputs", "wall_s": time.perf_counter() - t0,
          "records": records})

    phases = []
    for name, metrics_fn, data_fn, batch, profile_steps in (
        ("imagenet_eval", imagenet_metrics, imagenet_data, 500, 10),
        ("binary_eval", binary_metrics, binary_data, 1 << 18, 4),
    ):
        t0 = time.perf_counter()
        phase = eval_phase(name, metrics_fn, data_fn(), batch=batch, profile_steps=profile_steps,
                           required=("confusion_matrix", "binned_curve_counts", "weighted_bincount"))
        phases.append(phase)
        emit({**phase, "card": smi, "phase_wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    retrieval = retrieval_phase()
    phases.append(retrieval)
    emit({**retrieval, "card": smi, "phase_wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    image = image_phase(ssim_alone_ms=k5_ms_per_step_alone(records))
    phases.append(image)
    emit({**image, "card": smi, "phase_wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    emit({**gradient_phase(), "card": smi, "phase_wall_s": time.perf_counter() - t0})

    line = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        mine = [r for r in records if r["kernel"] == name]
        main = next(r for r in mine if r["main_path"])  # the first main-path shape of each kernel
        line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(phase["launches"][name] for phase in phases),
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main["kernel_ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": {k: main[k] for k in ("n", "classes", "thresholds", "rows", "bins", "planes", "hp", "wp", "kh",
                                           "kw") if k in main},
        })
    emit({"total_wall_s": time.perf_counter() - script_t0})
    print(smi)
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
