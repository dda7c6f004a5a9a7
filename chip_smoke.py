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
   confusion-matrix and weighted-bincount record also splits a call's host µs into its
   steps, and each of those and each binned-curve and bincount record, once every
   record is timed, counts the device operations of one of its calls (torch.profiler:
   one kernel, else the run fails) and their device µs. A confusion-matrix,
   binned-curve or bincount record names its label or index dtypes (the ImageNet
   step's preds are int64, as argmax gives them) and bounds the bytes those dtypes
   make; a binned-curve record also times the composed library sequence
   (searchsorted, bincount, flip-cumsum-flip) and keeps the compare's operations bound
   of the first port beside its bytes bound. Each SSIM-moments record gives the GB/s
   its bytes make at its time and its bound's share of that time.
4. ``imagenet_eval``: an ImageNet-1k validation pass, 50,000 samples, 1000 classes,
   batch 500: top-1 and macro accuracy, macro F1, macro precision and recall, the
   confusion matrix, macro Jaccard, Matthews, Cohen's kappa, calibration error
   (15 bins), AUROC (100 thresholds) and the micro-averaged PR curve (200 thresholds).
5. ``binary_eval``: a CTR-style pass, 2^22 scores in 16 batches with 1% of targets
   ignored: AUROC and average precision (1000 thresholds), accuracy, F1, the
   confusion matrix, Matthews, Jaccard and calibration error (15 bins).
6. ``collection_eval``: both eval loops again, each metric set as one
   ``MetricCollection`` with compute groups, against the same metrics updated one by
   one on the card: the groups, the launches per step of the confusion-matrix,
   binned-curve and weighted-bincount kernels on both sides, µs per step from
   alternating (per metric, grouped) pairs in one process with no profiler in
   between, then one profile of each grouped loop. Integer states and every value of a
   group of two or more must be bitwise the per-metric loop's; other floats within
   the classification tolerance.
7. ``pipeline_eval``: both eval loops' grouped collections three ways, in three
   alternating rounds: the collection's eager loop, ``MetricPipeline`` with ``fuse=1``
   (one CUDA-graph replay a step) and with ``fuse=8`` (one replay a chunk of 8; K1,
   K2 and K3 inside the graph), each captured by its warmup before the clock starts.
   It prints µs per step, graph replays and host dispatches per batch, K1/K2/K3
   launches per step counted through replays, the captured variants and capture
   seconds of each pipeline, the peak device memory of the fused ImageNet run, and
   after every timing a profile's device busy share of each. It fails unless both
   pipelines' profiles hold as many K1, K2 and K3 device kernels as their replays
   counted (launches per step times the profiled steps; a trace short of one is taken
   again, twice at most), both
   pipelines equal the eager loop on the card (integers exactly, floats within the
   classification tolerance), the fused one equals its CPU run on a prefix of 12
   ImageNet and 5 CTR batches, the replays equal the chunks with no capture, degraded
   chunk or eager batch in the loop, and a fault run (NaN put into ImageNet batches
   13 and 42 under the ``quarantine`` policy) quarantines exactly those update
   indices, replays their two chunks per batch and equals the eager loop without them.
8. ``session_eval``: both grouped collections as tenant sessions (``imagenet``,
   ``ctr``) of ``MetricPipeline(fuse=8)`` with an alert engine (a non-finite and an
   out-of-bounds rule, evaluated at every commit) and ``CheckpointPolicy(every_batches=16,
   full_every=4, keep=4)``: µs per step with and without the policy and the engine,
   in three alternating rounds; then the session migrated — the origin folds 48
   ImageNet / 6 CTR batches, holds 2 behind its cursor, drains and checkpoints with
   them as the tail — and restored in a spawned process on cuda:0 that replays the
   tail, folds the rest and computes; then the origin's epoch fenced, its next bundle
   refused; then a crashed session beside a torn ``bundle-*.tmp.*`` directory restored
   from ``latest_valid_bundle`` with its gap re-fed; then a NaN in one batch. It prints
   bundle bytes (full and delta), seconds to write, verify and restore a bundle, the
   restored process's capture seconds and K1/K2/K3 launches per step, and the peak
   device memory of the rounds. It fails unless the migrated and the crash-recovered
   sessions are bitwise the control, the restored process launched K1/K2/K3 at
   ``pipeline_eval``'s fuse=8 counts per step (ImageNet 2/1/1, CTR 1/1/1), its registry
   row, report and value timelines continue the origin's, the fenced bundle raises
   ``FencedBundleError``, no alert fires on clean data and the NaN fires the non-finite
   rule with one flight dump.
9. ``collection_sync``: two ranks in one gloo world on the one card
   (``torch.multiprocessing`` spawn, a timeout on the rendezvous and on each
   collective, one on the whole world). Each rank makes the full seeded data, updates
   a grouped and an ungrouped collection with every other batch on ``cuda:0`` and
   calls ``compute``, which syncs: once untimed, then in turns with the value cache
   off. It reports the backend, whether a collective stages the CUDA tensors through
   host memory (gloo gathers CPU tensors), the ``all_gather`` calls per ``compute``
   grouped and ungrouped, the ms per synced ``compute`` and the ms of the sync alone
   (``sync_state`` of the leaders' states). Both ranks' synced values and states must equal the single-process
   collection's over all the data (integers exactly, floats within the
   classification tolerance); a rank that fails or hangs fails the run.
10. ``retrieval_grouping``: ``_flexible_bincount`` over the query ids of a top-1000
   reranking evaluation at MS MARCO passage dev-small's size, 6,980 queries x 1000
   candidates (6.98 M int32 ids) in a seeded order, through the bincount kernel.
11. ``image_restoration_eval``: a super-resolution validation pass at the size of the
   DIV2K validation set, 100 RGB images of 1356 x 2040, batch 4, 25 steps: SSIM,
   MS-SSIM, PSNR, UQI, sliding-window RMSE (window 8) and the total variation of the
   predictions. It requires 6 launches of the SSIM moments kernel per step (1 for
   SSIM, 5 for the MS-SSIM scales), then holds the card against the CPU on the first
   8 images with fresh metrics on both sides. It reports the kernel's device ms per
   warm step inside the loop (profile) beside its main-path shapes timed alone.
12. ``ssim_gradient``: ``structural_similarity_index_measure(...).backward()`` on one
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

builds the kernels and prints only one JSON line: the confusion matrix and the binned
curve at their five shapes, the weighted bincount, the bincount and the SSIM moments
timed through their public wrappers at the shapes of the ``kernels`` phase (and three
larger SSIM windows), each checked against its plain version on the card, with the
host µs, device kernels and device µs per confusion-matrix, binned-curve,
weighted-bincount and bincount call, the library call's time beside the confusion
matrix and the bincount, the composed library sequence's time beside the binned curve
and a digest of each SSIM output. The five wrappers' interfaces have not changed
since they were ported, so a copy of this script run from the root of an earlier
revision's checkout times that revision: running earlier, this, this, earlier on one
card compares two revisions.

    python3 chip_smoke.py --pipeline-eval

builds the kernels and prints only the ``pipeline_eval`` phase's line (its checks
included), so that two revisions of the capture cache and the pipeline are compared
the same way: earlier, this, this, earlier on one card.

    python3 chip_smoke.py --session-eval

builds the kernels and prints only the ``session_eval`` phase's line (its checks
included).

``bound_ms`` is the larger of the bytes a kernel must move over the memory rate and
its operations over the float32 rate of the data sheet (an FMA counting two).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import warnings

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
    """Device kernels (and memsets) that one warm call of ``fn()`` runs, from torch.profiler,
    and their device µs in that trace.

    A trace can miss a kernel, never add one, so the largest count of ``trials``
    single-call traces is the one reported."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best, best_us = {}, 0.0
    for _ in range(trials):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names, device_us = {}, 0.0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and e.count:
                names[e.key[:80]] = names.get(e.key[:80], 0) + e.count
                device_us += getattr(e, "self_device_time_total", 0) or 0
        if sum(names.values()) > sum(best.values()):
            best, best_us = names, device_us
    return {"per_call": sum(best.values()), "names": best, "device_us": best_us}


# ----------------------------------------------------------------------- kernels


def confusion_matrix_case(n: int, c: int, seed: int, device: str = "cuda", preds_dtype=None, target_dtype=None,
                          high_bits: bool = False):
    """Labels with 20% invalid samples and about 1% out-of-range preds and targets, int32
    unless a dtype is given. With ``high_bits`` the int64 labels also carry multiples of
    2^32, which the kernel drops as JAX's conversion to int32 does."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    preds = torch.randint(0, c, (n,), generator=g, device=device, dtype=torch.int32)
    target = torch.randint(0, c, (n,), generator=g, device=device, dtype=torch.int32)
    valid = torch.rand(n, generator=g, device=device) >= 0.2
    bad = torch.rand(n, generator=g, device=device) < 0.01
    preds = torch.where(bad, torch.where(preds % 2 == 0, c, -1), preds).to(preds_dtype or torch.int32)
    bad = torch.rand(n, generator=g, device=device) < 0.01
    target = torch.where(bad, torch.where(target % 2 == 0, c + 5, -3), target).to(target_dtype or torch.int32)
    if high_bits:
        preds = preds + (torch.randint(-2, 3, (n,), generator=g, device=device) << 32).to(preds.dtype)
        target = target + (torch.randint(-2, 3, (n,), generator=g, device=device) << 32).to(target.dtype)
    return preds, target, valid


def curve_case(n: int, t: int, seed: int, unsorted_ties: bool = False, device: str = "cuda", label_dtype=None):
    """Scores, labels (int32 unless a dtype is given), 20% invalid, and the default grid
    (or a shuffled grid with exact ties)."""
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
    labels = torch.randint(0, 2, (n,), generator=g, device=device, dtype=torch.int32).to(label_dtype or torch.int32)
    valid = torch.rand(n, generator=g, device=device) >= 0.2
    return scores, labels, valid, thresholds


def curve_bound_ms(labels, t: int) -> float:
    """The bytes the binned curve must move over the memory rate: each score, label (at
    its own width) and mask byte read once, the thresholds read, int32 [T, 2] written.
    The search's N * ceil(log2(T + 1)) compares take far less."""
    n = labels.numel()
    return (n * (4 + labels.element_size() + 1) + t * 12) / HBM_BYTES_PER_S * 1e3


def curve_compare_bound_ms(n: int, t: int) -> float:
    """The bound of the earlier O(N * T) compare design: its 2 * N * T operations."""
    return 2.0 * n * t / FP32_OPS_PER_S * 1e3


def curve_library(scores, labels, valid, thresholds):
    """The composed library sequence (no single PyTorch call computes the binned curve):
    ``torch.searchsorted`` over the sorted thresholds, the masked bucket code,
    ``torch.bincount``, then flip, ``cumsum``, flip. The thresholds are sorted before the
    returned call; an unsorted list is scattered back in its order. A reference only: no
    NaN among the scores (searchsorted puts NaN after every threshold)."""
    import torch

    t = thresholds.numel()
    sorted_thr, order = torch.sort(thresholds)
    identity = bool((order == torch.arange(t, device=order.device)).all())
    positive = labels.to(torch.int32) != 0

    def call():
        pos = torch.searchsorted(sorted_thr, scores, right=True)
        code = torch.where(valid, 2 * pos + (~positive), 2 * (t + 1))
        hist = torch.bincount(code, minlength=2 * t + 3)[: 2 * (t + 1)].view(t + 1, 2)
        counts = hist.flip(0).cumsum(0).flip(0)[1:]
        return counts if identity else torch.empty_like(counts).index_copy_(0, order, counts)

    return call


def confusion_matrix_bound_ms(preds, target, c: int) -> float:
    """The bytes the kernel must move over the memory rate: each label read at its own
    width, the bool mask, and the int32 [C, C] output written."""
    n = preds.numel()
    return (n * (preds.element_size() + target.element_size() + 1) + c * c * 4) / HBM_BYTES_PER_S * 1e3


def confusion_matrix_library(preds, target, valid, c: int):
    """The yardstick's inputs: one torch.bincount over the codes of the pairs that count,
    weighted 0 or 1, labels taken by their low 32 bits as the kernel takes them."""
    import torch

    p, t = preds.to(torch.int32).long(), target.to(torch.int32).long()
    keep = valid & (p >= 0) & (p < c) & (t >= 0) & (t < c)
    code = torch.where(keep, t * c + p, torch.zeros_like(p))
    return code, keep.to(torch.float32)


def kernel_record_confusion_matrix(n: int, c: int, seed: int, main_path: bool, preds_dtype=None, target_dtype=None,
                                   high_bits: bool = False) -> dict:
    """Also: the host µs of each step of a call. The record's ``_trace`` counts the device
    operations of one call once every timing is done (``trace_records``)."""
    import torch

    from torchmetrics_tpu_torch.ops import kernels

    preds, target, valid = confusion_matrix_case(n, c, seed, preds_dtype=preds_dtype, target_dtype=target_dtype,
                                                 high_bits=high_bits)
    before = kernels.LAUNCHES["confusion_matrix"]
    got = kernels.confusion_matrix(preds, target, valid, c)
    torch.cuda.synchronize()
    want = kernels.confusion_matrix_plain(preds.cpu(), target.cpu(), valid.cpu(), c)
    err = int((got.cpu().to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got.cpu(), want):
        raise AssertionError(f"confusion_matrix kernel != plain at N={n}, C={c}: max abs err {err}")
    code, weight = confusion_matrix_library(preds, target, valid, c)
    library = torch.bincount(code, weights=weight, minlength=c * c).reshape(c, c)
    if not torch.equal(library.cpu().to(torch.int32), want):
        raise AssertionError("the torch.bincount yardstick disagrees with the plain version")
    call = lambda: kernels.confusion_matrix(preds, target, valid, c)  # noqa: E731
    record = {
        "kernel": "confusion_matrix", "n": n, "classes": c, "preds_dtype": str(preds.dtype),
        "target_dtype": str(target.dtype), "high_bits": high_bits, "main_path": main_path, "max_abs_err": err,
        "kernel_ms": time_ms(call),
        "plain_ms": time_ms(lambda: kernels.confusion_matrix_plain(preds, target, valid, c)),
        "library_ms": time_ms(lambda: torch.bincount(code, weights=weight, minlength=c * c)),
        "bound_ms": confusion_matrix_bound_ms(preds, target, c),
        "bound_by": "bytes",
        "host_us": confusion_host_breakdown(preds, target, valid, c, calls=500),
    }
    record["_trace"] = lambda: confusion_trace(call)
    return {**record, "launches": kernels.LAUNCHES["confusion_matrix"] - before}


def confusion_trace(call) -> dict:
    """The device operations of one call (torch.profiler): one kernel and nothing else."""
    ran = device_kernels_per_call(call)
    kernel_names = [name for name in ran["names"] if "confusion_matrix" in name]
    if len(kernel_names) != 1 or ran["names"][kernel_names[0]] != 1 or ran["per_call"] != 1:
        raise AssertionError(f"confusion_matrix ran {ran} device operations per call, expected one kernel")
    return {"device_kernels_per_call": ran["per_call"], "device_kernels": ran["names"],
            "device_us_per_call": ran["device_us"]}


def confusion_host_breakdown(preds, target, valid, c: int, calls: int = 2000) -> dict:
    """Host µs per call of each step of ``kernels.confusion_matrix`` on these inputs,
    each step timed alone over ``calls`` calls, and of the whole call."""
    import torch

    from torchmetrics_tpu_torch.ops import kernels

    index = preds.get_device()
    stream = kernels._raw_stream(index)
    n = preds.numel()

    def scratch():
        need = kernels._confusion_slots_bytes(index, n, c)
        return kernels._stream_scratch(kernels._CONFUSION_SCRATCH, index, stream, need, zero=False) if need else None

    slots, need = scratch(), kernels._confusion_slots_bytes(index, n, c)
    out = preds.new_empty((c, c), dtype=torch.int32)
    fn = kernels._entry_point("confusion_matrix")
    args = (preds.data_ptr(), preds.element_size(), target.data_ptr(), target.element_size(), valid.data_ptr(), n, c,
            None if slots is None else slots.data_ptr(), need, out.data_ptr(), stream)
    accepted = kernels._CONFUSION_DTYPES
    return {
        "checks": host_us(lambda: (preds.dtype not in accepted, target.dtype not in accepted, valid.dtype not in accepted,
                                   preds.numel(), target.numel(), valid.numel(), 0 <= c <= kernels._MAX_CLASSES), calls),
        "on_card": host_us(lambda: kernels._on_card(preds, target, valid), calls),
        "operands": host_us(lambda: (kernels._label_operand(preds), kernels._label_operand(target),
                                     valid.dtype != torch.bool, valid.is_contiguous()), calls),
        "empty_out": host_us(lambda: preds.new_empty((c, c), dtype=torch.int32), calls),
        "stream_lookup": host_us(lambda: (preds.get_device(), torch.cuda.current_device(), kernels._raw_stream(index)),
                                 calls),
        "scratch_lookup": host_us(scratch, calls),
        "ctypes_call_and_launch": host_us(lambda: fn(*args), calls),
        "whole_call": host_us(lambda: kernels.confusion_matrix(preds, target, valid, c), calls),
    }


def kernel_record_curve(n: int, t: int, seed: int, main_path: bool, unsorted_ties: bool = False,
                        label_dtype=None) -> dict:
    """Also: the composed library sequence's time (``curve_library``), the host µs of a
    whole call, and the earlier compare design's operations bound beside the bytes
    bound. The record's ``_trace`` counts the device operations of one call once every
    timing is done (``trace_records``)."""
    import torch

    from torchmetrics_tpu_torch.ops import kernels

    scores, labels, valid, thresholds = curve_case(n, t, seed, unsorted_ties, label_dtype=label_dtype)
    before = kernels.LAUNCHES["binned_curve_counts"]
    got = kernels.binned_curve_counts(scores, labels, valid, thresholds)
    torch.cuda.synchronize()
    want = kernels.binned_curve_counts_plain(scores.cpu(), labels.cpu(), valid.cpu(), thresholds.cpu())
    err = int((got.cpu().to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got.cpu(), want):
        raise AssertionError(f"binned_curve_counts kernel != plain at N={n}, T={t}: max abs err {err}")
    library = curve_library(scores, labels, valid, thresholds)
    if not torch.equal(library().cpu().to(torch.int32), want):
        raise AssertionError("the composed searchsorted + bincount + cumsum yardstick disagrees with the plain version")
    call = lambda: kernels.binned_curve_counts(scores, labels, valid, thresholds)  # noqa: E731
    record = {
        "kernel": "binned_curve_counts", "n": n, "thresholds": t, "unsorted_ties": unsorted_ties,
        "labels_dtype": str(labels.dtype), "main_path": main_path, "max_abs_err": err,
        "kernel_ms": time_ms(call),
        "plain_ms": time_ms(lambda: kernels.binned_curve_counts_plain(scores, labels, valid, thresholds), reps=3),
        "library_ms": None,
        "composed_library_ms": time_ms(library),
        "composed_library": "searchsorted(sorted thresholds, right=True), masked code, bincount, flip-cumsum-flip",
        "bound_ms": curve_bound_ms(labels, t),
        "bound_by": "bytes",
        "compare_bound_ms": curve_compare_bound_ms(n, t),
        "host_us_per_call": host_us(call, calls=500),
    }
    record["_trace"] = lambda: curve_trace(call)
    return {**record, "launches": kernels.LAUNCHES["binned_curve_counts"] - before}


def curve_trace(call) -> dict:
    """The device operations of one call (torch.profiler): one kernel and nothing else."""
    ran = device_kernels_per_call(call)
    if ran["per_call"] != 1 or any("curve_" not in name for name in ran["names"]):
        raise AssertionError(f"binned_curve_counts ran {ran} device operations per call, expected one kernel")
    return traced(ran)


def traced(ran: dict) -> dict:
    """A record's keys for what ``device_kernels_per_call`` found."""
    return {"device_kernels_per_call": ran["per_call"], "device_kernels": ran["names"],
            "device_us_per_call": ran["device_us"]}


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
    record["host_us"] = weighted_host_breakdown(x, w, c, calls=500)
    record["_trace"] = lambda: weighted_trace(lambda: kernels.weighted_bincount(x, w, c))
    return {**record, "launches": kernels.LAUNCHES["weighted_bincount"] - before}


def weighted_trace(call) -> dict:
    """The device kernels of one call (torch.profiler): it must be one."""
    ran = device_kernels_per_call(call)
    if ran["per_call"] != 1 or any("weighted_bincount_kernel" not in name for name in ran["names"]):
        raise AssertionError(f"weighted_bincount ran {ran} device kernels per call, not one")
    return traced(ran)


def trace_records(records: list) -> None:
    """Run each record's torch.profiler check, after every timing of the ``kernels``
    phase: a process that has run the profiler spends more host time per launch from
    then on. (Single-call traces taken after the eval phases' profiles held no device
    event, so they run before those phases.)"""
    for record in records:
        trace = record.pop("_trace", None)
        if trace is not None:
            record.update(trace())


def weighted_host_breakdown(x, w, c: int, calls: int = 2000) -> dict:
    """Host µs per call of each step of ``kernels.weighted_bincount`` on these inputs,
    each step timed alone over ``calls`` calls, and of the whole call."""
    import torch

    from torchmetrics_tpu_torch.ops import kernels

    index = w.get_device()
    k, n = w.shape
    stream = kernels._raw_stream(index)
    scratch = lambda: kernels._stream_scratch(kernels._WEIGHTED_SCRATCH, index, stream,  # noqa: E731
                                              kernels._weighted_scratch_bytes(k, c), zero=True)
    out = w.new_empty((k, c))
    fn = kernels._entry_point("weighted_bincount")
    args = (x.data_ptr(), w.data_ptr(), n, k, c, scratch().data_ptr(), out.data_ptr(), stream)
    return {
        "checks_and_casts": host_us(lambda: (kernels._on_card(x, w), x.dim() != 1, x.dtype != torch.int32,
                                             x.is_contiguous(), w.dtype != torch.float32, w.is_contiguous(),
                                             w.ndim != 2 or w.shape[1] != x.numel()), calls),
        "empty_out": host_us(lambda: w.new_empty((k, c)), calls),
        "stream_lookup": host_us(lambda: (w.get_device(), torch.cuda.current_device(), kernels._raw_stream(index)),
                                 calls),
        "scratch_lookup": host_us(scratch, calls),
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


def bincount_case(n: int, c: int, seed: int, ids: str = "random", dtype=None):
    """Indices for the bincount kernel, int32 unless ``dtype`` is given: "queries", the
    query ids of a reranking run (C queries, N / C candidates each) in a seeded order;
    "grouped", the same ids grouped by query, as retrieval users pass them (runs of
    N / C equal ids); "random", uniform in [0, C)."""
    import torch

    if ids == "queries":
        x = query_ids(c, n // c, seed)
    elif ids == "grouped":
        x = torch.arange(c, device="cuda", dtype=torch.int32).repeat_interleave(n // c)
    else:
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randint(0, c, (n,), generator=g, device="cuda", dtype=torch.int32)
    return x if dtype is None else x.to(dtype)


def bincount_bound_ms(x, c: int) -> float:
    return (x.numel() * x.element_size() + c * 4) / HBM_BYTES_PER_S * 1e3


def kernel_record_bincount(n: int, c: int, seed: int, main_path: bool, ids: str = "random", dtype=None) -> dict:
    """Also: the host µs of a call and, once every record is timed, the device operations
    of one call (torch.profiler: one kernel)."""
    import torch

    from torchmetrics_tpu_torch.ops import kernels

    x = bincount_case(n, c, seed, ids, dtype)
    before = kernels.LAUNCHES["bincount"]
    got = kernels.bincount(x, None, c)
    torch.cuda.synchronize()
    want = kernels.bincount_plain(x.cpu(), c)
    err = int((got.cpu().to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got.cpu(), want):
        raise AssertionError(f"bincount kernel != plain at N={n}, C={c}, {ids} {x.dtype} ids: max abs err {err}")
    if not torch.equal(torch.bincount(x, minlength=c).cpu().to(torch.int32), want):
        raise AssertionError("the torch.bincount yardstick disagrees with the plain version")
    call = lambda: kernels.bincount(x, None, c)  # noqa: E731
    record = {
        "kernel": "bincount", "n": n, "bins": c, "ids": ids, "dtype": str(x.dtype).removeprefix("torch."),
        "main_path": main_path, "max_abs_err": err,
        "kernel_ms": time_ms(call),
        "plain_ms": time_ms(lambda: kernels.bincount_plain(x, c)),
        "library_ms": time_ms(lambda: torch.bincount(x, minlength=c)),
        "bound_ms": bincount_bound_ms(x, c),
        "bound_by": "bytes",
        "host_us_per_call": host_us(call, calls=500),
    }
    record["_trace"] = lambda: bincount_trace(call)
    return {**record, "launches": kernels.LAUNCHES["bincount"] - before}


def bincount_trace(call) -> dict:
    """The device operations of one call (torch.profiler): one kernel and nothing else."""
    ran = device_kernels_per_call(call)
    if ran["per_call"] != 1 or any("bincount_" not in name for name in ran["names"]):
        raise AssertionError(f"bincount ran {ran} device operations per call, expected one kernel")
    return traced(ran)


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


# ------------------------------------------------------------------ collections

# (set, metrics, data, batch, profiled steps): the two eval loops, as MetricCollections
COLLECTION_SETS = (("imagenet", imagenet_metrics, imagenet_data, 500, 10),
                   ("binary", binary_metrics, binary_data, 1 << 18, 4))
COLLECTION_KERNELS = ("confusion_matrix", "binned_curve_counts", "weighted_bincount")
# alternating (per metric, grouped) pairs timed in one process, no profiler in between
COLLECTION_PAIRS = 5
# the two-rank world: its rendezvous and each collective, then the whole world
SYNC_COLLECTIVE_TIMEOUT_S = 120
SYNC_WORLD_TIMEOUT_S = 300
# synced computes timed on each side, alternating, after one untimed compute of each
SYNC_REPEATS = 4


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree.cpu()


def bitwise_equal(a, b) -> bool:
    """Equal dtypes, shapes and bits (NaN included)."""
    import torch

    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(bitwise_equal(x, y) for x, y in zip(a, b))
    a, b = a.cpu().contiguous(), b.cpu().contiguous()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return torch.equal(a.view(bits), b.view(bits))


def collection_states(col) -> dict:
    """{metric: {state: tensor}} of a collection, as ``run_loop`` gives a per-metric loop's."""
    return {name: m.state_dict(persistent_only=False) for name, m in col.items(keep_base=True)}


def collection_eval_phase() -> tuple:
    """Each eval loop's metrics as one MetricCollection with compute groups, on the card,
    against the same metrics one by one: launches per step, µs per step from alternating
    pairs, then one profile of each grouped loop; integer states and every grouped
    member's value must be bitwise the per-metric loop's, other floats within the
    classification tolerance. Returns the phase and, for ``collection_sync``, each
    grouped loop's values and states."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.ops import kernels

    sets, launches, data, reference = {}, {name: 0 for name in kernels.LAUNCHES}, {}, {}
    for kind, metrics_fn, data_fn, batch, _ in COLLECTION_SETS:
        preds, target = data[kind] = data_fn()
        steps = -(-preds.shape[0] // batch)
        us = {"per_metric": [], "grouped": []}
        runs = {}
        for pair in range(COLLECTION_PAIRS):
            for side in ("per_metric", "grouped") if pair % 2 == 0 else ("grouped", "per_metric"):
                metrics = metrics_fn("cuda")
                col = MetricCollection(metrics) if side == "grouped" else None
                kernels.reset_launch_counts()
                if col is None:
                    values, states, seconds = run_loop(metrics, preds, target, batch)
                else:
                    values, _, seconds = run_loop({"all": col}, preds, target, batch)
                    values, states = values["all"], collection_states(col)
                us[side].append(seconds / steps * 1e6)
                if side not in runs:
                    runs[side] = {"values": values, "states": to_cpu(states), "launches": dict(kernels.LAUNCHES),
                                  "groups": col.compute_groups if col is not None else None}
        grouped, per_metric = runs["grouped"], runs["per_metric"]
        for kernel in COLLECTION_KERNELS:
            if grouped["launches"][kernel] <= 0:
                raise AssertionError(f"collection_eval {kind}: kernel {kernel} was never launched by the collection")
        for name in launches:
            launches[name] += grouped["launches"][name]
        state_gap = max(compare(grouped["states"][m], per_metric["states"][m], f"state.{m}")
                        for m in per_metric["states"])
        value_gap, bitwise = 0.0, []
        for members in grouped["groups"].values():
            for m in members:
                if len(members) > 1:
                    if not bitwise_equal(grouped["values"][m], per_metric["values"][m]):
                        raise AssertionError(f"collection_eval {kind}: grouped member {m}'s value is not bitwise"
                                             " the per-metric loop's")
                    bitwise.append(m)
                else:
                    value_gap = max(value_gap, compare(grouped["values"][m], to_cpu(per_metric["values"][m]),
                                                       f"value.{m}"))
        sets[kind] = {
            "samples": int(preds.shape[0]), "batch": batch, "steps": steps,
            "groups": [list(g) for g in grouped["groups"].values()],
            "launches_per_step": {side: {k: runs[side]["launches"][k] / steps for k in COLLECTION_KERNELS}
                                  for side in ("per_metric", "grouped")},
            "us_per_step": us, "us_per_step_mean": {side: statistics.mean(v) for side, v in us.items()},
            "us_per_step_median": {side: statistics.median(v) for side, v in us.items()},
            "bitwise_members": bitwise, "max_state_float_gap": state_gap, "max_value_float_gap": value_gap,
        }
        reference[kind] = {"values": to_cpu(grouped["values"]), "states": grouped["states"]}
    # one profile of each grouped loop, after every timing
    for kind, metrics_fn, _, batch, profile_steps in COLLECTION_SETS:
        preds, target = data.pop(kind)
        sets[kind]["profile"] = profile_loop({"all": MetricCollection(metrics_fn("cuda"))}, preds, target, batch,
                                             profile_steps)
    return {"phase": "collection_eval", "sets": sets, "launches": launches}, reference


# ------------------------------------------------------------------- pipeline

# the fused chunk of the third variant, and the two faulted ImageNet batches (chunks 1
# and 5 of 8) of the fault run
PIPELINE_FUSE = 8
PIPELINE_ROUNDS = 3
PIPELINE_FAULTS = (13, 42)
# batches of each set that the card's fused pipeline and the CPU's run alike: a full
# chunk and a padded one (ImageNet 8 + 4; CTR 5, padded to 8)
PIPELINE_CPU_BATCHES = {"imagenet": 12, "binary": 5}
PIPELINE_VARIANTS = ("eager", "fuse_1", "fuse_8")


def release_graphs() -> None:
    """Free the CUDA graphs (and their memory pools) of the pipelines just dropped: a
    pipeline's fused function refers to the pipeline, so only the collector frees it."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def batches_of(preds, target, batch: int, count: int | None = None) -> list:
    steps = -(-preds.shape[0] // batch)
    return [(preds[i * batch:(i + 1) * batch], target[i * batch:(i + 1) * batch]) for i in range(steps)][:count]


def pipeline_run(metrics_fn, device: str, batches: list, variant: str) -> dict:
    """One pass of a variant over ``batches`` with fresh metrics: ``eager`` is the
    grouped collection's own loop, ``fuse_1`` and ``fuse_8`` a MetricPipeline over it,
    captured by its warmup before the clock starts. Launch counts are zeroed just before
    the timed pass and read just after; the wall clock covers the pass and ``compute``
    and ends in a synchronise."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.engine import MetricPipeline, PipelineConfig
    from torchmetrics_tpu_torch.ops import kernels

    col = MetricCollection(metrics_fn(device))
    pipe, manifest = None, None
    if variant != "eager":
        pipe = MetricPipeline(col, PipelineConfig(fuse=1 if variant == "fuse_1" else PIPELINE_FUSE))
        manifest = pipe.warmup(*batches[0])
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    if pipe is None:
        for p, t in batches:
            col.update(p, t)
    else:
        pipe.run(batches)
    values = col.compute()
    if cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out = {"seconds": seconds, "launches": dict(kernels.LAUNCHES), "values": values,
           "states": to_cpu(collection_states(col)), "col": col}
    if pipe is not None:
        report, info = pipe.report(), pipe.cache_info()
        out.update({
            "report": report.asdict(), "replays": sum(i["replays"] for i in info),
            "misses_in_loop": sum(i["misses"] for i in info),
            "variants": manifest["variants"], "capture_s": manifest["total_compile_seconds"], "pipe": pipe,
        })
    return out


# the device kernels of K1, K2 and K3 by a part of their names (their .cu sources)
DEVICE_KERNEL_NAMES = {"confusion_matrix": "confusion_matrix_", "binned_curve_counts": "curve_",
                       "weighted_bincount": "weighted_bincount_kernel"}


def profile_pipeline(metrics_fn, batches: list, variant: str) -> dict:
    """A torch.profiler trace of one variant's pass over ``batches`` after its warmup:
    device time per step, the busy share of the wall clock, and the K1/K2/K3 device
    kernels the trace holds beside the launches the wrappers counted in the pass (for a
    pipeline, through its replays)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.engine import MetricPipeline, PipelineConfig
    from torchmetrics_tpu_torch.ops import kernels

    col = MetricCollection(metrics_fn("cuda"))
    if variant == "eager":
        def loop():
            for p, t in batches:
                col.update(p, t)
        loop()
        col.reset()
    else:
        pipe = MetricPipeline(col, PipelineConfig(fuse=1 if variant == "fuse_1" else PIPELINE_FUSE))
        pipe.warmup(*batches[0])

        def loop():
            pipe.run(batches)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counted = {k: kernels.LAUNCHES[k] for k in COLLECTION_KERNELS}
    device_us, events, traced_kernels = 0.0, 0, {k: 0 for k in COLLECTION_KERNELS}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            device_us += us
            events += e.count
            for k in COLLECTION_KERNELS:
                if DEVICE_KERNEL_NAMES[k] in e.key:
                    traced_kernels[k] += e.count
    steps = len(batches)
    return {"steps": steps, "wall_ms_per_step": wall / steps * 1e3, "device_ms_per_step": device_us / steps / 1e3,
            "device_busy_share": device_us / 1e6 / wall if wall else None, "device_events": events,
            "counted_launches": counted, "traced_kernels": traced_kernels}


def pipeline_fault_run(batches: list) -> dict:
    """ImageNet through the fused pipeline under the ``quarantine`` policy with NaN put
    into two batches: exactly those two update indices must be quarantined, their two
    chunks replayed per batch, and the state must equal the eager loop without them."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.engine import MetricPipeline, PipelineConfig
    from torchmetrics_tpu_torch.robust import error_policy, faults

    col = MetricCollection(imagenet_metrics("cuda"))
    dump_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "flight")
    pipe = MetricPipeline(col, PipelineConfig(fuse=PIPELINE_FUSE, flight_dump_dir=dump_dir))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with error_policy("quarantine"), faults.inject_nan_updates(indices=PIPELINE_FAULTS):
            report = pipe.run(batches)
    values = col.compute()
    leaders = [members[0] for members in col.compute_groups.values()]
    quarantined = {name: [q["update_index"] for q in col[name].quarantined_batches] for name in leaders}
    for name, indices in quarantined.items():
        if indices != list(PIPELINE_FAULTS):
            raise AssertionError(f"pipeline_eval fault run: {name} quarantined {indices}, not {list(PIPELINE_FAULTS)}")
    if report.chunks_replayed != len(PIPELINE_FAULTS) or report.replayed_batches != PIPELINE_FUSE * 2:
        raise AssertionError(f"pipeline_eval fault run: {report.chunks_replayed} chunks and"
                             f" {report.replayed_batches} batches replayed, not 2 chunks of {PIPELINE_FUSE}")
    clean = MetricCollection(imagenet_metrics("cuda"))
    for i, (p, t) in enumerate(batches):
        if i not in PIPELINE_FAULTS:
            clean.update(p, t)
    # the guarded leaders' state_dicts also carry their guard counters (`__robust__`)
    states = {m: {k: v for k, v in st.items() if k != "__robust__"} for m, st in collection_states(col).items()}
    state_gap = compare(to_cpu(states), to_cpu(collection_states(clean)), "fault.state")
    value_gap = compare(to_cpu(values), to_cpu(clean.compute()), "fault.value")
    return {"faulted_batches": list(PIPELINE_FAULTS), "quarantined": quarantined,
            "chunks_replayed": report.chunks_replayed, "replayed_batches": report.replayed_batches,
            "fused_batches": report.fused_batches, "flight_dumps": len(pipe.flight_dumps),
            "max_state_float_gap": state_gap, "max_value_float_gap": value_gap}


def pipeline_eval_phase() -> dict:
    """Both eval loops as one grouped MetricCollection three ways, in alternating rounds:
    its own eager loop, a MetricPipeline with fuse=1 (one graph replay a step) and one
    with fuse=8 (one replay a chunk). Fails unless the pipelines equal the eager loop on
    the card, the fused one equals its CPU run on a prefix, every batch of a pipeline
    went through a replay (the replay count equals the chunk count, no miss and no
    degraded chunk in the loop), and the fault run quarantines exactly its batches.
    Profiles and peak memory come after every timing."""
    import torch

    from torchmetrics_tpu_torch.ops import kernels

    sets, data, launches = {}, {}, {name: 0 for name in kernels.LAUNCHES}
    for kind, metrics_fn, data_fn, batch, _ in COLLECTION_SETS:
        preds, target = data[kind] = data_fn()
        batches = batches_of(preds, target, batch)
        steps = len(batches)
        chunks = {"eager": steps, "fuse_1": steps, "fuse_8": -(-steps // PIPELINE_FUSE)}
        us, runs = {v: [] for v in PIPELINE_VARIANTS}, {}
        for rnd in range(PIPELINE_ROUNDS):
            order = PIPELINE_VARIANTS if rnd % 2 == 0 else PIPELINE_VARIANTS[::-1]
            for variant in order:
                run = pipeline_run(metrics_fn, "cuda", batches, variant)
                us[variant].append(run["seconds"] / steps * 1e6)
                if variant != "eager":
                    report = run["report"]
                    if run["replays"] != chunks[variant] or run["misses_in_loop"]:
                        raise AssertionError(f"pipeline_eval {kind} {variant}: {run['replays']} replays and"
                                             f" {run['misses_in_loop']} captures in the loop for {chunks[variant]}"
                                             " chunks")
                    if report["chunks_replayed"] or (variant == "fuse_8" and report["eager_batches"]):
                        raise AssertionError(f"pipeline_eval {kind} {variant}: a chunk degraded or a batch went eager")
                run.pop("pipe", None)
                run.pop("col")
                runs.setdefault(variant, run)
                release_graphs()
        eager = runs["eager"]
        for kernel in COLLECTION_KERNELS:
            if runs["fuse_8"]["launches"][kernel] <= 0:
                raise AssertionError(f"pipeline_eval {kind}: kernel {kernel} never launched through a replay")
        for name in launches:
            launches[name] += runs["fuse_8"]["launches"][name]
        gaps = {}
        for variant in ("fuse_1", "fuse_8"):
            gaps[variant] = {
                "state": max(compare(runs[variant]["states"][m], eager["states"][m], f"{variant}.state.{m}")
                             for m in eager["states"]),
                "value": compare(to_cpu(runs[variant]["values"]), to_cpu(eager["values"]), f"{variant}.value"),
                "bitwise_states": all(bitwise_equal(list(runs[variant]["states"][m].values()),
                                                    list(eager["states"][m].values())) for m in eager["states"]),
            }
        prefix = batches[:PIPELINE_CPU_BATCHES[kind]]
        card = pipeline_run(metrics_fn, "cuda", prefix, "fuse_8")
        cpu = pipeline_run(metrics_fn, "cpu", [(p.cpu(), t.cpu()) for p, t in prefix], "fuse_8")
        release_graphs()
        cpu_gap = max(compare(card["states"][m], cpu["states"][m], f"cpu.state.{m}") for m in cpu["states"])
        cpu_gap = max(cpu_gap, compare(to_cpu(card["values"]), cpu["values"], "cpu.value"))
        sets[kind] = {
            "samples": int(preds.shape[0]), "batch": batch, "steps": steps, "fuse": PIPELINE_FUSE,
            "us_per_step": us, "us_per_step_mean": {v: statistics.mean(x) for v, x in us.items()},
            "us_per_step_median": {v: statistics.median(x) for v, x in us.items()},
            "replays_per_batch": {v: runs[v]["replays"] / steps for v in ("fuse_1", "fuse_8")},
            "host_dispatches_per_batch": {v: runs[v]["report"]["dispatches_per_batch"] for v in ("fuse_1", "fuse_8")},
            "launches_per_step": {v: {k: runs[v]["launches"][k] / steps for k in COLLECTION_KERNELS}
                                  for v in PIPELINE_VARIANTS},
            "captured_variants": {v: runs[v]["variants"] for v in ("fuse_1", "fuse_8")},
            "capture_s": {v: runs[v]["capture_s"] for v in ("fuse_1", "fuse_8")},
            "padded_steps": runs["fuse_8"]["report"]["padded_steps"], "float_gaps": gaps,
            "cpu_compared_batches": len(prefix), "max_cpu_float_gap": cpu_gap,
        }
    imagenet_batches = batches_of(*data["imagenet"], COLLECTION_SETS[0][3])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    pipeline_run(imagenet_metrics, "cuda", imagenet_batches, "fuse_8")
    sets["imagenet"]["peak_mb_fuse_8"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    release_graphs()
    fault = pipeline_fault_run(imagenet_batches)
    release_graphs()
    # profiles after every timing: a process that has run the profiler is slower afterwards
    for kind, metrics_fn, _, batch, profile_steps in COLLECTION_SETS:
        batches = batches_of(*data.pop(kind), batch, count=2 * PIPELINE_FUSE)
        sets[kind]["profile"] = profiles = {v: profile_pipeline(metrics_fn, batches, v) for v in PIPELINE_VARIANTS}
        for variant in ("fuse_1", "fuse_8"):
            # the replay-counted launches must be kernels the card ran; a trace may drop
            # a kernel (the eager loop's once dropped one of 32) but never adds one, so
            # up to two more traces are taken before the run fails
            per_step = sets[kind]["launches_per_step"][variant]
            want = {k: round(per_step[k] * len(batches)) for k in COLLECTION_KERNELS}
            got = profiles[variant]
            for _ in range(2):
                if got["counted_launches"] == want and got["traced_kernels"] == want:
                    break
                again = profile_pipeline(metrics_fn, batches, variant)
                if sum(again["traced_kernels"].values()) > sum(got["traced_kernels"].values()):
                    got = profiles[variant] = again
            if got["counted_launches"] != want or got["traced_kernels"] != want:
                raise AssertionError(f"pipeline_eval {kind} {variant}: over {len(batches)} profiled steps the"
                                     f" wrappers counted {got['counted_launches']} and the trace holds"
                                     f" {got['traced_kernels']} K1/K2/K3 kernels, not {want}")
    return {"phase": "pipeline_eval", "sets": sets, "fault_run": fault, "launches": launches}


# -------------------------------------------------------------------- session

# the migrated session: the origin folds the first SESSION_CUT batches, holds the next
# SESSION_TAIL behind its cursor, and the restored process replays them and folds the
# rest; the restored process then runs 52 ImageNet / 10 CTR batches, which split into
# chunks of 8 and one unpadded bucket (4 / 2), so its launches per step are exact
SESSION_CUT = {"imagenet": 48, "binary": 6}
SESSION_TAIL = 2
# the crash run dies after this many fed batches (CTR: the whole stream, since a
# 16-batch cadence writes its one bundle at the end of the 16-batch stream)
SESSION_CRASH_AT = {"imagenet": 75, "binary": 16}
# the batch whose first score is NaN in the alert run
SESSION_NAN_BATCH = {"imagenet": 30, "binary": 5}
SESSION_TENANT = {"imagenet": "imagenet", "binary": "ctr"}
SESSION_ROUNDS = 3
SESSION_VARIANTS = ("plain", "alerts", "checkpoint")
# K1/K2/K3 launches per step of pipeline_eval's fuse=8 variant
SESSION_LAUNCHES_PER_STEP = {"imagenet": {"confusion_matrix": 2, "binned_curve_counts": 1, "weighted_bincount": 1},
                             "binary": {"confusion_matrix": 1, "binned_curve_counts": 1, "weighted_bincount": 1}}
SESSION_CHILD_TIMEOUT_S = 300


def session_root() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "session")


def session_engine():
    """An alert engine with its own value log: the non-finite and the out-of-bounds rule
    over every metric's scalar values."""
    from torchmetrics_tpu_torch.obs.alerts import AlertEngine, AlertRule
    from torchmetrics_tpu_torch.obs.values import ValueLog

    return AlertEngine(rules=[AlertRule(name="non_finite", kind="non_finite"),
                              AlertRule(name="out_of_bounds", kind="bounds")], value_log=ValueLog())


def session_config(kind: str, variant: str, directory: str, engine=None):
    from torchmetrics_tpu_torch.engine import PipelineConfig
    from torchmetrics_tpu_torch.engine.migrate import CheckpointPolicy

    policy = None
    if variant == "checkpoint":
        policy = CheckpointPolicy(directory=directory, every_batches=16, full_every=4, keep=4)
    return PipelineConfig(fuse=PIPELINE_FUSE, tenant=SESSION_TENANT[kind], alert_every=1,
                          alert_engine=engine if variant != "plain" else None, checkpoint=policy,
                          flight_dump_dir=os.path.join(session_root(), "flight"))


def session_run(kind: str, metrics_fn, batches: list, variant: str, directory: str) -> dict:
    """One tenant session over ``batches`` after its warmup: ``plain`` (fuse=8), with the
    alert engine evaluated at every commit, and with it and the continuous checkpoint
    policy too (the control). The clock covers the pass, ``compute`` and a synchronise."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.engine import MetricPipeline

    col = MetricCollection(metrics_fn("cuda"))
    engine = session_engine()
    pipe = MetricPipeline(col, session_config(kind, variant, directory, engine))
    pipe.warmup(*batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.run(batches)
    values = col.compute()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    pipe.close()
    stats = pipe._checkpointer.stats if pipe._checkpointer is not None else None
    return {"seconds": seconds, "values": to_cpu(values), "states": to_cpu(collection_states(col)),
            "firing": engine.firing(), "checkpoint_stats": stats, "flight_dumps": len(pipe.flight_dumps)}


def session_restore_set(kind: str, metrics_fn, data_fn, batch: int, bundle: str) -> dict:
    """The restored half of the migration, in a process of its own: fresh metrics,
    ``restore_session`` (the tail replays into the open chunk), a warmup that captures
    the restored pipeline's graphs (the cold start), then the rest of the stream with
    launch counts zeroed just before and read just after."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.engine.migrate import CheckpointPolicy, restore_session
    from torchmetrics_tpu_torch.obs import scope
    from torchmetrics_tpu_torch.ops import kernels

    batches = batches_of(*data_fn(), batch)
    col = MetricCollection(metrics_fn("cuda"))
    engine = session_engine()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe, manifest = restore_session(
        col, bundle, alert_engine=engine, value_log=engine._log(),
        flight_dump_dir=os.path.join(session_root(), "flight"),
        checkpoint=CheckpointPolicy(directory=os.path.join(session_root(), kind, "restored"), every_batches=16,
                                    full_every=4, keep=4))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    cursor = manifest["cursor"]["batches_ingested"] + manifest["cursor"]["tail_batches"]
    origin_row = manifest["registry"]
    restored_row = next(r for r in scope.get_registry().rows() if r["tenant"] == SESSION_TENANT[kind])
    warm = pipe.warmup(*batches[cursor])
    before = pipe.report()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    pipe.run(batches[cursor:])
    values = col.compute()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    report = pipe.report()
    pipe.close()
    row = next(r for r in scope.get_registry().rows() if r["tenant"] == SESSION_TENANT[kind])
    series = [s for s in engine._log().series() if s["tenant"] == SESSION_TENANT[kind]]
    return {
        "values": to_cpu(values), "states": to_cpu(collection_states(col)), "launches": launches,
        "steps": len(batches) - manifest["cursor"]["batches_ingested"],
        "padded_steps": report.padded_steps - before.padded_steps, "report": report.asdict(),
        "restore_s": restore_s, "capture_s": warm["total_compile_seconds"], "variants": warm["variants"],
        "origin_row": origin_row, "restored_row": restored_row, "row": row,
        "leaders": len(col.compute_groups),
        "series_steps": {f"{s['metric']}[{s['inst']}].{s['leaf']}": [p[0] for p in s["points"]] for s in series},
        "firing": engine.firing(), "lineage_epoch": pipe.lineage_epoch,
    }


def session_restore_worker(bundles: dict, queue) -> None:
    """The restoring process (spawned): every set's bundle restored on cuda:0; the
    result goes back as ``torch.save`` bytes."""
    import io
    import traceback

    import torch

    try:
        torch.cuda.set_device(0)
        out = {}
        for kind, metrics_fn, data_fn, batch, _ in COLLECTION_SETS:
            out[kind] = session_restore_set(kind, metrics_fn, data_fn, batch, bundles[kind])
            release_graphs()
        payload = io.BytesIO()
        torch.save(out, payload)
        queue.put((payload.getvalue(), None))
    except BaseException:  # reported to the parent, which fails the run
        queue.put((None, traceback.format_exc()))
        raise


def session_restore_elsewhere(bundles: dict) -> dict:
    """Run :func:`session_restore_worker` in a spawned process and wait for it (a
    timeout on the whole process; a failure or a hang fails the run)."""
    import io
    import queue as queue_mod

    import torch
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    proc = ctx.Process(target=session_restore_worker, args=(bundles, results))
    proc.start()
    try:
        deadline = time.monotonic() + SESSION_CHILD_TIMEOUT_S
        while True:
            if time.monotonic() > deadline:
                raise AssertionError("session_eval: the restoring process hung")
            try:
                result, error = results.get(timeout=1)
                break
            except queue_mod.Empty:
                if proc.exitcode not in (None, 0):
                    raise AssertionError(f"session_eval: the restoring process exited with {proc.exitcode}")
        if error is not None:
            raise AssertionError(f"session_eval: the restoring process failed:\n{error}")
        proc.join(timeout=60)
        if proc.exitcode != 0:
            raise AssertionError(f"session_eval: the restoring process ended with exit code {proc.exitcode}")
        return torch.load(io.BytesIO(result))
    finally:
        if proc.is_alive():
            proc.kill()
            proc.join()


def session_bitwise(where: str, got: dict, want: dict) -> None:
    """Every state and value of ``got`` bitwise ``want``'s."""
    for m in want["states"]:
        if not bitwise_equal(list(got["states"][m].values()), list(want["states"][m].values())):
            raise AssertionError(f"session_eval {where}: the states of {m} are not bitwise the control's")
    for m, value in want["values"].items():
        a = list(value) if isinstance(value, tuple) else value
        b = list(got["values"][m]) if isinstance(got["values"][m], tuple) else got["values"][m]
        if not bitwise_equal(a, b):
            raise AssertionError(f"session_eval {where}: the value of {m} is not bitwise the control's")


def session_eval_phase() -> dict:
    """A tenant session of each eval loop's grouped collection, migrated and crashed.

    1. Control: ``MetricPipeline(fuse=8)`` as tenant ``imagenet`` / ``ctr`` with an
       alert engine (non-finite and out-of-bounds rules, ``alert_every=1``) and
       ``CheckpointPolicy(every_batches=16, full_every=4, keep=4)``, in alternating
       rounds with the same session without the policy and without either.
    2. Migrated run: the same session anew folds the first half of the stream but for
       two batches it holds behind its cursor; ``drain`` and ``checkpoint_session``
       with those two as the tail.
    3. A spawned process restores each bundle on cuda:0, replays the tail, folds the
       rest and computes (``session_restore_worker``).
    4. Fencing: the origin's epoch is fenced; the origin's next bundle must raise
       ``FencedBundleError`` and the migration bundle must still verify.
    5. Crash recovery: a session with the policy dies mid-stream beside a torn
       ``bundle-*.tmp.*`` directory; ``latest_valid_bundle`` must skip it with a
       warning, and a restore plus a re-feed of the gap must compute the control.

    Fails unless every state and value of 3 and 5 is bitwise the control's, the
    restored process launched K1/K2/K3 at pipeline_eval's fuse=8 counts per step, its
    registry row, report and value timelines continue the origin's, no alert fired on
    clean data, and a NaN in one batch fires the non-finite rule with one flight dump.
    """
    import shutil

    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.engine import MetricPipeline
    from torchmetrics_tpu_torch.engine.migrate import (
        FencedBundleError,
        checkpoint_session,
        fence_epoch,
        latest_valid_bundle,
        restore_session,
        verify_bundle,
    )

    root = session_root()
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    sets, data, controls, bundles, origins = {}, {}, {}, {}, {}
    try:
        for kind, metrics_fn, data_fn, batch, _ in COLLECTION_SETS:
            batches = data[kind] = batches_of(*data_fn(), batch)
            steps = len(batches)
            us, runs = {v: [] for v in SESSION_VARIANTS}, {}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            for rnd in range(SESSION_ROUNDS):
                order = SESSION_VARIANTS if rnd % 2 == 0 else SESSION_VARIANTS[::-1]
                for variant in order:
                    directory = os.path.join(root, kind, f"{variant}{rnd}")
                    run = session_run(kind, metrics_fn, batches, variant, directory)
                    us[variant].append(run["seconds"] / steps * 1e6)
                    if run["firing"]:
                        raise AssertionError(f"session_eval {kind} {variant}: alerts fired on clean data:"
                                             f" {run['firing']}")
                    runs.setdefault(variant, run)
                    session_bitwise(f"{kind} {variant} round {rnd}", run, runs["plain"] if "plain" in runs else run)
                    release_graphs()
            peak_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
            control = controls[kind] = runs["checkpoint"]
            session_bitwise(f"{kind} control", control, runs["plain"])
            stats = control["checkpoint_stats"]

            # 2. the migrated run's origin
            cut = SESSION_CUT[kind]
            col = MetricCollection(metrics_fn("cuda"))
            engine = session_engine()
            origin = MetricPipeline(col, session_config(kind, "checkpoint", os.path.join(root, kind, "origin"), engine))
            origin.warmup(*batches[0])
            for b in batches[:cut]:
                origin.feed(*b)
            migrate_dir = os.path.join(root, kind, "migrate")
            bundle = bundles[kind] = os.path.join(migrate_dir, "bundle-000000")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            manifest = checkpoint_session(origin, bundle, tail=batches[cut:cut + SESSION_TAIL])
            write_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            verify_bundle(bundle)
            verify_s = time.perf_counter() - t0
            origins[kind] = (origin, col, manifest)
            sets[kind] = {
                "samples": int(sum(b[0].shape[0] for b in batches)), "batch": batch, "steps": steps,
                "tenant": SESSION_TENANT[kind], "fuse": PIPELINE_FUSE,
                "us_per_step": us, "us_per_step_mean": {v: statistics.mean(x) for v, x in us.items()},
                "us_per_step_median": {v: statistics.median(x) for v, x in us.items()},
                "control_bundles": {k: dict(v) for k, v in stats.items()},
                "bundle_bytes": {k: (v["bytes"] / v["count"] if v["count"] else None) for k, v in stats.items()},
                "migration_bundle_bytes": sum(os.path.getsize(os.path.join(bundle, f)) for f in os.listdir(bundle)),
                "bundle_write_s": write_s, "bundle_verify_s": verify_s,
                "origin_cursor": manifest["cursor"]["batches_ingested"], "tail": manifest["cursor"]["tail_batches"],
                "peak_mb_rounds": peak_mb,
            }
            del col
            release_graphs()

        # 3. the restoring process
        t0 = time.perf_counter()
        restored = session_restore_elsewhere(bundles)
        child_wall = time.perf_counter() - t0
        launches = {}
        for kind, _, _, _, _ in COLLECTION_SETS:
            got, record = restored[kind], sets[kind]
            session_bitwise(f"{kind} migrated", got, controls[kind])
            want = {k: n * got["steps"] for k, n in SESSION_LAUNCHES_PER_STEP[kind].items()}
            counted = {k: got["launches"][k] for k in want}
            if got["padded_steps"] or counted != want:
                raise AssertionError(f"session_eval {kind}: the restored process launched {counted} over"
                                     f" {got['steps']} steps ({got['padded_steps']} padded), not {want}")
            for name, n in got["launches"].items():
                launches[name] = launches.get(name, 0) + n
            origin_row, row = got["origin_row"], got["row"]
            if got["restored_row"]["updates"] != origin_row["updates"] or \
                    row["updates"] != origin_row["updates"] + got["leaders"] * got["steps"] or \
                    row["first_seen_unix"] != origin_row["first_seen_unix"]:
                raise AssertionError(f"session_eval {kind}: the registry row restarted: origin {origin_row},"
                                     f" restored {got['restored_row']}, final {row}")
            if got["report"]["batches"] != record["steps"] or got["report"]["processed_batches"] != record["steps"]:
                raise AssertionError(f"session_eval {kind}: the restored report counts {got['report']['batches']}"
                                     f" batches, not the stream's {record['steps']}")
            # a value series is keyed by metric instance: the origin's series come back
            # with their step anchors, and the restored metrics' own series go on from
            # the origin's update counts, not from 0
            cursor = record["origin_cursor"]
            carried = {k: s for k, s in got["series_steps"].items() if s and s[0] <= cursor}
            fresh = {k: s for k, s in got["series_steps"].items() if k not in carried}
            if not carried or not fresh or any(s != sorted(s) for s in got["series_steps"].values()) or \
                    any(s[-1] > cursor for s in carried.values()) or \
                    any(s[0] <= cursor or s[-1] != record["steps"] for s in fresh.values()):
                raise AssertionError(f"session_eval {kind}: the value timelines did not continue across the"
                                     f" move: {got['series_steps']}")
            if got["firing"]:
                raise AssertionError(f"session_eval {kind}: alerts fired in the restored process: {got['firing']}")
            record.update({"restore_s": got["restore_s"], "restored_capture_s": got["capture_s"],
                           "restored_captured_variants": got["variants"], "restored_steps": got["steps"],
                           "restored_launches_per_step": {k: got["launches"][k] / got["steps"] for k in want},
                           "registry_updates": {"origin": origin_row["updates"], "final": row["updates"]},
                           "value_series": {"carried": len(carried), "fresh": len(fresh)}})

            # 4. fencing: the origin writes again after its epoch is fenced
            origin, _, manifest = origins.pop(kind)
            migrate_dir = os.path.dirname(bundles[kind])
            fence_epoch(migrate_dir, origin.lineage_epoch, tenant=SESSION_TENANT[kind], by="session_eval")
            zombie = os.path.join(migrate_dir, "bundle-000001")
            checkpoint_session(origin, zombie)
            try:
                verify_bundle(zombie)
            except FencedBundleError:
                pass
            else:
                raise AssertionError(f"session_eval {kind}: the fenced origin's bundle verified")
            verify_bundle(bundles[kind])
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                chosen = latest_valid_bundle(migrate_dir)
            if chosen != bundles[kind] or not any("zombie" in str(w.message) for w in caught):
                raise AssertionError(f"session_eval {kind}: recovery chose {chosen} beside the fenced bundle")
            origin.close()
            record["fenced"] = {"epoch": origin.lineage_epoch, "zombie_rejected": True}
            release_graphs()

        # 5. crash recovery, and the NaN run
        for kind, metrics_fn, _, _, _ in COLLECTION_SETS:
            batches, record = data[kind], sets[kind]
            crash_dir = os.path.join(root, kind, "crash")
            col = MetricCollection(metrics_fn("cuda"))
            crashed = MetricPipeline(col, session_config(kind, "checkpoint", crash_dir, session_engine()))
            for b in batches[:SESSION_CRASH_AT[kind]]:
                crashed.feed(*b)
            torch.cuda.synchronize()
            del crashed, col  # the process "dies": no drain, no close, no final bundle
            release_graphs()
            torn = os.path.join(crash_dir, "bundle-000099.tmp.4242.deadbeef")
            os.makedirs(torn)
            with open(os.path.join(torn, "state.npz"), "wb") as fh:
                fh.write(b"PK\x03\x04 torn")
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                latest = latest_valid_bundle(crash_dir)
            if latest is None or not any(os.path.basename(torn) in str(w.message) for w in caught):
                raise AssertionError(f"session_eval {kind}: the crash scan chose {latest} and did not name the"
                                     " torn directory")
            col = MetricCollection(metrics_fn("cuda"))
            pipe, manifest = restore_session(col, latest, alert_engine=session_engine(),
                                             flight_dump_dir=os.path.join(root, "flight"))
            gap_from = manifest["cursor"]["batches_ingested"]
            pipe.run(batches[gap_from:])
            recovered = {"values": to_cpu(col.compute()), "states": to_cpu(collection_states(col))}
            pipe.close()
            session_bitwise(f"{kind} crash-recovered", recovered, controls[kind])
            record["crash"] = {"died_after": SESSION_CRASH_AT[kind], "restored_from": os.path.basename(latest),
                               "gap_refed": len(batches) - gap_from}
            del col, pipe
            release_graphs()

            poisoned = list(batches)
            p, t = poisoned[SESSION_NAN_BATCH[kind]]
            p = p.clone()
            p.view(-1)[0] = float("nan")
            poisoned[SESSION_NAN_BATCH[kind]] = (p, t)
            run = session_run_with_nan(kind, metrics_fn, poisoned)
            record["nan_run"] = run
            release_graphs()
    finally:
        for origin, _, _ in origins.values():
            origin.close()
        shutil.rmtree(root, ignore_errors=True)
    return {"phase": "session_eval", "sets": sets, "restoring_process_wall_s": child_wall, "launches": launches}


def session_run_with_nan(kind: str, metrics_fn, batches: list) -> dict:
    """The session with the alert engine over a stream with one NaN score: the
    non-finite rule must fire and the pipeline must write exactly one flight dump."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.engine import MetricPipeline

    col = MetricCollection(metrics_fn("cuda"))
    engine = session_engine()
    pipe = MetricPipeline(col, session_config(kind, "alerts", "", engine))
    pipe.run(batches)
    pipe.close()
    fired = sorted({a["rule"] for a in engine.firing()})
    dumps = pipe.flight_dumps
    if "non_finite" not in fired or len(dumps) != 1:
        raise AssertionError(f"session_eval {kind}: a NaN batch fired {fired} and wrote {len(dumps)} flight dumps")
    with open(dumps[0], encoding="utf-8") as fh:
        reason = json.loads(fh.readline())["reason"]
    if not reason.startswith("value_alert:") or "non_finite" not in reason:
        raise AssertionError(f"session_eval {kind}: the flight dump's reason is {reason!r}")
    return {"nan_batch": SESSION_NAN_BATCH[kind], "fired": fired, "flight_dumps": len(dumps), "reason": reason,
            "series_firing": sorted({a["series"] for a in engine.firing()})}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def collection_sync_rank(rank: int, port: int) -> dict:
    """One rank of the two-rank world on the one card: the full seeded data, every other
    batch into a grouped and an ungrouped collection on cuda:0, then synced ``compute``s
    of each, timed in turns and with their ``all_gather`` calls counted, and the sync of
    the leaders' states alone, timed the same way (the grouped one also for the parent's
    check)."""
    import datetime

    import torch
    import torch.distributed as dist

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.ops import kernels
    from torchmetrics_tpu_torch.parallel.sync import stages_through_host

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=SYNC_COLLECTIVE_TIMEOUT_S))
    try:
        gathers = []
        all_gather = dist.all_gather
        # every collective of the sync layer is an all_gather: count them
        dist.all_gather = lambda *a, **k: gathers.append(1) or all_gather(*a, **k)
        kernels.reset_launch_counts()
        out = {"backend": str(dist.get_backend()), "world": dist.get_world_size(),
               "staged": stages_through_host(torch.zeros(1, device="cuda")), "sets": {}}
        for kind, metrics_fn, data_fn, batch, _ in COLLECTION_SETS:
            preds, target = data_fn()
            cols = {"grouped": MetricCollection(metrics_fn("cuda")),
                    "ungrouped": MetricCollection(metrics_fn("cuda"), compute_groups=False)}
            for start in range(rank * batch, preds.shape[0], 2 * batch):
                for col in cols.values():
                    col.update(preds[start:start + batch], target[start:start + batch])
            record = {name: {"ms_per_compute": [], "ms_per_sync_state": [], "groups": len(col.compute_groups)}
                      for name, col in cols.items()}
            leader_states = {name: {members[0]: col[members[0]].state_dict(persistent_only=False)
                                    for members in col.compute_groups.values()} for name, col in cols.items()}
            for col in cols.values():
                for m in col.values():
                    m.compute_with_cache = False  # every compute syncs again
                col.compute()  # the first compute pays the first use of its kernels and of the gloo pairs
            for repeat in range(SYNC_REPEATS):
                for name in ("grouped", "ungrouped") if repeat % 2 == 0 else ("ungrouped", "grouped"):
                    torch.cuda.synchronize()
                    dist.barrier()
                    del gathers[:]
                    t0 = time.perf_counter()
                    values = cols[name].compute()
                    torch.cuda.synchronize()
                    record[name]["ms_per_compute"].append((time.perf_counter() - t0) * 1e3)
                    record[name]["collectives"] = len(gathers)
                    dist.barrier()
                    t0 = time.perf_counter()
                    synced = cols[name].sync_state(leader_states[name])
                    torch.cuda.synchronize()
                    record[name]["ms_per_sync_state"].append((time.perf_counter() - t0) * 1e3)
                    if name == "grouped":
                        record["values"], record["states"] = to_cpu(values), to_cpu(synced)
            out["sets"][kind] = record
            del preds, target, cols
        out["launches"] = dict(kernels.LAUNCHES)
        return out
    finally:
        dist.destroy_process_group()


def collection_sync_worker(rank: int, port: int, queue) -> None:
    """Run one rank and put its result on ``queue`` as ``torch.save`` bytes (a tensor
    put on a queue would be shared through a file descriptor that dies with the rank)."""
    import io
    import traceback

    import torch

    try:
        payload = io.BytesIO()
        torch.save(collection_sync_rank(rank, port), payload)
        queue.put((rank, payload.getvalue(), None))
    except BaseException:  # reported to the parent, which fails the run
        queue.put((rank, None, traceback.format_exc()))
        raise


def collection_sync_phase(reference: dict) -> dict:
    """Two ranks in one gloo world on the one card (``torch.multiprocessing`` spawn). Each
    rank's synced values and leader states must equal the single-process collection's
    over all the data (``reference``, from ``collection_eval``): integers exactly, floats
    within the classification tolerance. A rank that fails or hangs fails the run."""
    import io
    import queue as queue_mod

    import torch
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results_queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=collection_sync_worker, args=(rank, port, results_queue)) for rank in range(2)]
    t0 = time.perf_counter()
    for proc in procs:
        proc.start()
    results = {}
    try:
        deadline = time.monotonic() + SYNC_WORLD_TIMEOUT_S
        while len(results) < 2:
            if time.monotonic() > deadline:
                raise AssertionError(f"collection_sync: the world hung ({sorted(results)} of 2 ranks reported)")
            try:
                rank, result, error = results_queue.get(timeout=1)
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise AssertionError(f"collection_sync: a rank exited with {dead} before it reported")
                continue
            if error is not None:
                raise AssertionError(f"collection_sync: rank {rank} failed:\n{error}")
            results[rank] = torch.load(io.BytesIO(result))
        for proc in procs:
            proc.join(timeout=max(1.0, deadline - time.monotonic()))
            if proc.exitcode != 0:
                raise AssertionError(f"collection_sync: a rank ended with exit code {proc.exitcode}")
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
    wall = time.perf_counter() - t0

    launches = {}
    for rank, result in results.items():
        for kernel in COLLECTION_KERNELS:
            if result["launches"][kernel] <= 0:
                raise AssertionError(f"collection_sync: rank {rank} never launched {kernel}")
        for kernel, n in result["launches"].items():
            launches[kernel] = launches.get(kernel, 0) + n
    sets, gap = {}, 0.0
    for kind, _, _, _, _ in COLLECTION_SETS:
        ref = reference[kind]
        for rank, result in results.items():
            record = result["sets"][kind]
            for leader, state in record["states"].items():
                gap = max(gap, compare(state, ref["states"][leader], f"rank{rank}.state.{leader}"))
            for metric, value in record["values"].items():
                gap = max(gap, compare(value, ref["values"][metric], f"rank{rank}.value.{metric}"))
        rank0 = results[0]["sets"][kind]
        summary = {}
        for metric, value in rank0["values"].items():
            if isinstance(value, tuple):
                summary[metric] = {"points": int(value[0].numel())}
            elif value.numel() == 1:
                summary[metric] = float(value)
            else:
                summary[metric] = {"shape": list(value.shape), "sum": int(value.sum())}
        sets[kind] = {
            "collectives_per_compute": {side: rank0[side]["collectives"] for side in ("grouped", "ungrouped")},
            "groups": {side: rank0[side]["groups"] for side in ("grouped", "ungrouped")},
            "ms_per_synced_compute": {side: {f"rank{r}": results[r]["sets"][kind][side]["ms_per_compute"]
                                             for r in results} for side in ("grouped", "ungrouped")},
            "ms_per_sync_state": {side: {f"rank{r}": results[r]["sets"][kind][side]["ms_per_sync_state"]
                                         for r in results} for side in ("grouped", "ungrouped")},
            "median_ms_rank0": {side: {"compute": statistics.median(rank0[side]["ms_per_compute"]),
                                       "sync_state": statistics.median(rank0[side]["ms_per_sync_state"])}
                                for side in ("grouped", "ungrouped")},
            "values": summary,
        }
    return {"phase": "collection_sync", "ranks": 2, "backend": results[0]["backend"],
            "staged": results[0]["staged"], "world": results[0]["world"], "max_float_gap": gap,
            "world_wall_s": wall, "sets": sets, "launches": launches}


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


# K1's shapes: the ImageNet step (int64 preds from argmax), the binary step, and three
# stress shapes
CONFUSION_SHAPES = [(500, 1000, "int64"), (1 << 18, 2, "int32"), (1 << 20, 10, "int32"), (1 << 20, 100, "int32"),
                    (1 << 20, 1000, "int32")]


# K2's shapes (N, T, shuffled thresholds with ties, main path, seed): the ImageNet micro
# PR curve's step (N = 500 x 1000 pairs), the binary step, and three stress shapes
CURVE_SHAPES = [(500 * 1000, 200, False, True, 4), (1 << 18, 1000, False, True, 5), (1 << 20, 100, False, False, 100),
                (1 << 20, 1000, False, False, 1000), (1 << 20, 200, True, False, 3)]


# K4's shapes (N, C, ids, dtype, main path): the retrieval grouping's 6.98 M query ids
# (shuffled as in its phase; as int64; grouped by query), and four stress shapes from a
# per-lane copy (C = 100) to an output beyond shared memory (C = 2^20)
BINCOUNT_SHAPES = [(6980 * 1000, 6980, "queries", "int32", True), (6980 * 1000, 6980, "queries", "int64", False),
                   (6980 * 1000, 6980, "grouped", "int32", False)] + [
    (1 << 20, c, "random", "int32", False) for c in (100, 8192, 1 << 16, 1 << 20)]


def kernel_times() -> dict:
    """The confusion matrix, the binned curve, the weighted bincount and the SSIM moments
    through their public wrappers only."""
    import hashlib

    import torch

    from torchmetrics_tpu_torch.ops import kernels

    confusion, calls = [], []
    for n, c, preds_dtype in CONFUSION_SHAPES:
        preds, target, valid = confusion_matrix_case(n, c, seed=c, preds_dtype=getattr(torch, preds_dtype))
        got = kernels.confusion_matrix(preds, target, valid, c).cpu()
        if not torch.equal(got, kernels.confusion_matrix_plain(preds.cpu(), target.cpu(), valid.cpu(), c)):
            raise AssertionError(f"confusion_matrix != plain at N={n}, C={c}")
        code, weight = confusion_matrix_library(preds, target, valid, c)
        call = (lambda p, t, v, c: lambda: kernels.confusion_matrix(p, t, v, c))(preds, target, valid, c)
        calls.append(call)
        confusion.append({
            "n": n, "classes": c, "preds_dtype": preds_dtype, "kernel_ms": time_ms(call, reps=200),
            "library_ms": time_ms(lambda: torch.bincount(code, weights=weight, minlength=c * c), reps=200),
            "host_us_per_call": host_us(call), "bound_ms": confusion_matrix_bound_ms(preds, target, c),
        })
    curve = []
    for n, t, unsorted, _, seed in CURVE_SHAPES:
        scores, labels, valid, thresholds = curve_case(n, t, seed, unsorted)
        got = kernels.binned_curve_counts(scores, labels, valid, thresholds).cpu()
        if not torch.equal(got, kernels.binned_curve_counts_plain(scores.cpu(), labels.cpu(), valid.cpu(),
                                                                  thresholds.cpu())):
            raise AssertionError(f"binned_curve_counts != plain at N={n}, T={t}")
        call = (lambda s, l, v, th: lambda: kernels.binned_curve_counts(s, l, v, th))(scores, labels, valid, thresholds)
        calls.append(call)
        curve.append({
            "n": n, "thresholds": t, "unsorted_ties": unsorted, "kernel_ms": time_ms(call, reps=200),
            "composed_library_ms": time_ms(curve_library(scores, labels, valid, thresholds), reps=200),
            "host_us_per_call": host_us(call), "bound_ms": curve_bound_ms(labels, t),
        })
    weighted = []
    for n, k, c in WEIGHTED_SHAPES:
        x, w = weighted_case(n, k, c, seed=13 + k + c)
        got = kernels.weighted_bincount(x, w, c).cpu()
        want = kernels.weighted_bincount_plain(x.cpu(), w.cpu(), c)
        if not torch.equal(got[-1], want[-1]):
            raise AssertionError(f"weighted_bincount count row != plain at N={n}, K={k}, C={c}")
        torch.testing.assert_close(got, want, rtol=WEIGHTED_RTOL, atol=0)
        calls.append((lambda x, w, c: lambda: kernels.weighted_bincount(x, w, c))(x, w, c))
        weighted.append({
            "n": n, "rows": k, "bins": c, "kernel_ms": time_ms(calls[-1], reps=200),
            "host_us_per_call": host_us(calls[-1]),
        })
    bincount = []
    for n, c, ids, dtype, _ in BINCOUNT_SHAPES:
        x = bincount_case(n, c, 9 if ids == "queries" else c, ids, getattr(torch, dtype))
        if not torch.equal(kernels.bincount(x, None, c).cpu(), kernels.bincount_plain(x.cpu(), c)):
            raise AssertionError(f"bincount != plain at N={n}, C={c}, {ids} {dtype} ids")
        calls.append((lambda x, c: lambda: kernels.bincount(x, None, c))(x, c))
        bincount.append({
            "n": n, "bins": c, "ids": ids, "dtype": dtype, "kernel_ms": time_ms(calls[-1], reps=200),
            "library_ms": time_ms(lambda: torch.bincount(x, minlength=c), reps=200),
            "host_us_per_call": host_us(calls[-1]), "bound_ms": bincount_bound_ms(x, c),
        })
        del x
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
    # traced last: a process that has run the profiler spends more host time per launch
    for record, call in zip(confusion + curve + weighted + bincount, calls):
        record.update(traced(device_kernels_per_call(call)))
    return {"phase": "kernel_times", "confusion_matrix": confusion, "binned_curve_counts": curve,
            "weighted_bincount": weighted, "bincount": bincount,
            "torch_steps_us": torch_steps_us, "ssim_moments": ssim}


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
    if "--pipeline-eval" in sys.argv[1:]:
        t0 = time.perf_counter()
        emit({**pipeline_eval_phase(), "card": smi, "root": os.path.dirname(os.path.abspath(__file__)),
              "phase_wall_s": time.perf_counter() - t0})
        return 0
    if "--session-eval" in sys.argv[1:]:
        t0 = time.perf_counter()
        emit({**session_eval_phase(), "card": smi, "root": os.path.dirname(os.path.abspath(__file__)),
              "phase_wall_s": time.perf_counter() - t0})
        return 0
    t0 = time.perf_counter()
    records = [kernel_record_confusion_matrix(1 << 20, c, seed=c, main_path=False) for c in (10, 100, 1000)]
    # the ImageNet step's stat scores: argmax's int64 preds beside int32 targets
    records.append(kernel_record_confusion_matrix(500, 1000, seed=7, main_path=True, preds_dtype=torch.int64))
    records.append(kernel_record_confusion_matrix(1 << 18, 2, seed=8, main_path=True))
    records.append(kernel_record_confusion_matrix(1 << 16, 10, seed=9, main_path=False, preds_dtype=torch.int64,
                                                  target_dtype=torch.int64, high_bits=True))
    records += [kernel_record_curve(n, t, seed=seed, main_path=main, unsorted_ties=unsorted)
                for n, t, unsorted, main, seed in CURVE_SHAPES]
    # the micro curve's shape with int64 labels, read in place; past 4096 thresholds (the compare mode)
    records.append(kernel_record_curve(500 * 1000, 200, seed=6, main_path=False, label_dtype=torch.int64))
    records.append(kernel_record_curve(1 << 16, 5000, seed=7, main_path=False, unsorted_ties=True))
    records.append(kernel_record_weighted_bincount(500, 3, 15, seed=11, main_path=True))
    records.append(kernel_record_weighted_bincount(1 << 18, 3, 15, seed=12, main_path=True))
    records += [kernel_record_weighted_bincount(1 << 20, k, c, seed=13 + k + c, main_path=False)
                for c in (15, 1000, 8192) for k in (1, 3)]
    records += [kernel_record_bincount(n, c, seed=9 if ids == "queries" else c, main_path=main, ids=ids,
                                       dtype=getattr(torch, dtype))
                for n, c, ids, dtype, main in BINCOUNT_SHAPES]
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
    trace_records(records)
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
    collection, reference = collection_eval_phase()
    phases.append(collection)
    emit({**collection, "card": smi, "phase_wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    pipeline = pipeline_eval_phase()
    phases.append(pipeline)
    emit({**pipeline, "card": smi, "phase_wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    session = session_eval_phase()
    phases.append(session)
    emit({**session, "card": smi, "phase_wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    sync = collection_sync_phase(reference)
    phases.append(sync)
    emit({**sync, "card": smi, "phase_wall_s": time.perf_counter() - t0})
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
