#!/usr/bin/env python3
"""Drive the PyTorch port (``torchmetrics_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one JSON line (a failure raises and exits non-zero):

1. ``device``: the card's name and power limit (``nvidia-smi``) and the CUDA version.
2. ``build``: compile the CUDA kernels from ``torchmetrics_tpu_torch/ops/csrc/``.
3. ``kernels``: each kernel against its plain PyTorch version on a CPU copy (the counts
   must be equal), at stress shapes and at the shapes the eval loops give it, with
   its time, its bound, the plain version's time, where one PyTorch call computes
   the same function that call's time, and the launches the check and timing made.
4. ``imagenet_eval``: an ImageNet-1k validation pass, 50,000 samples, 1000 classes,
   batch 500: top-1 and macro accuracy, macro F1, the confusion matrix, AUROC
   (100 thresholds) and the micro-averaged PR curve (200 thresholds).
5. ``binary_eval``: a CTR-style pass, 2^22 scores in 16 batches with 1% of targets
   ignored: AUROC (1000 thresholds), accuracy, F1 and the confusion matrix.

Both eval phases run the same loop again with ``device="cpu"`` and require equal
integer states and floats within 1e-5, and require every kernel to have launched.
Each then profiles a few warm steps on fresh metrics (``torch.profiler``): the
device time per step, the device's busy share of the wall clock and the kernels
that take most of it.
The last three lines are the ``nvidia-smi`` line, a JSON line with every kernel, and
``{"ok": true, "device": {...}}``. Times come from CUDA events over many launches
(inputs warm in L2) or from the host clock around work that ends in a synchronise.
Without a card the script exits non-zero before printing any result.

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
KERNEL_SOURCES = {
    "confusion_matrix": ("torchmetrics_tpu_torch/ops/csrc/confusion_matrix.cu", "torchmetrics_tpu/ops/pallas_kernels.py:70"),
    "binned_curve_counts": (
        "torchmetrics_tpu_torch/ops/csrc/binned_curve_counts.cu",
        "torchmetrics_tpu/ops/pallas_kernels.py:140",
    ),
}


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


# -------------------------------------------------------------------------- evals


def imagenet_metrics(device: str) -> dict:
    from torchmetrics_tpu_torch import classification as tc

    c = 1000
    kw = {"validate_args": False, "device": device}
    return {
        "accuracy_top1": tc.MulticlassAccuracy(c, average="micro", **kw),
        "accuracy_macro": tc.MulticlassAccuracy(c, average="macro", **kw),
        "f1_macro": tc.MulticlassF1Score(c, average="macro", **kw),
        "confusion_matrix": tc.MulticlassConfusionMatrix(c, **kw),
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


def compare(card, cpu, where: str) -> float:
    """Integers (and thresholds) equal, floats within FLOAT_ATOL; returns the largest float gap."""
    import torch

    if isinstance(card, dict):
        return max([compare(card[k], cpu[k], f"{where}.{k}") for k in card] or [0.0])
    if isinstance(card, (list, tuple)):
        return max([compare(a, b, f"{where}[{i}]") for i, (a, b) in enumerate(zip(card, cpu, strict=True))] or [0.0])
    a, b = card.cpu(), cpu
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{where}: card {tuple(a.shape)} {a.dtype} vs cpu {tuple(b.shape)} {b.dtype}")
    if not a.is_floating_point():
        if not torch.equal(a, b):
            raise AssertionError(f"{where}: integer state differs between the card and the CPU")
        return 0.0
    gap = float((a - b).abs().max()) if a.numel() else 0.0
    if not gap <= FLOAT_ATOL:
        raise AssertionError(f"{where}: float gap {gap} > {FLOAT_ATOL}")
    return gap


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
    gap = max(compare(card_states, cpu_states, "state"), compare(card_values, cpu_values, "value"))
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
        "cpu_compared_steps": steps, "cpu_wall_s": cpu_seconds, "max_float_gap": gap, "values": summary,
        "profile": profile_loop(metrics_fn("cuda"), preds, target, batch, profile_steps),
    }


def profile_loop(metrics: dict, preds, target, batch: int, steps: int) -> dict:
    """Device time by kernel over ``steps`` warm steps of an eval loop, from torch.profiler."""
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
    return {
        "steps": steps, "wall_ms_per_step": wall / steps * 1e3,
        "device_ms_per_step": total_device_us / steps / 1e3,
        "device_busy_share": total_device_us / 1e6 / wall if wall else None,
        "top_kernels": [{"name": k[:90], "ms_per_step": us / steps / 1e3, "calls": n} for k, (us, n) in top],
    }


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

    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "sources": {
        name: {"seconds": rec["seconds"], "ptxas": [line.strip() for line in rec["log"].splitlines() if "Used" in line]}
        for name, rec in _build.BUILD_LOG.items()
    }})
    records = [kernel_record_confusion_matrix(1 << 20, c, seed=c, main_path=False) for c in (10, 100, 1000)]
    records.append(kernel_record_confusion_matrix(500, 1000, seed=7, main_path=True))
    records.append(kernel_record_confusion_matrix(1 << 18, 2, seed=8, main_path=True))
    records += [kernel_record_curve(1 << 20, t, seed=t, main_path=False) for t in (100, 1000)]
    records.append(kernel_record_curve(1 << 20, 200, seed=3, main_path=False, unsorted_ties=True))
    records.append(kernel_record_curve(500 * 1000, 200, seed=4, main_path=True))
    records.append(kernel_record_curve(1 << 18, 1000, seed=5, main_path=True))
    emit({"phase": "kernels", "card": smi, "l2": "warm", "records": records})

    imagenet = eval_phase("imagenet_eval", imagenet_metrics, imagenet_data(), batch=500,
                          required=("confusion_matrix", "binned_curve_counts"), profile_steps=10)
    emit({**imagenet, "card": smi})
    binary = eval_phase("binary_eval", binary_metrics, binary_data(), batch=1 << 18,
                        required=("confusion_matrix", "binned_curve_counts"), profile_steps=4)
    emit({**binary, "card": smi})

    line = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        mine = [r for r in records if r["kernel"] == name]
        main = next(r for r in mine if r["main_path"])  # the ImageNet loop's shape comes first
        line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": imagenet["launches"][name] + binary["launches"][name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main["kernel_ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": {k: main[k] for k in ("n", "classes", "thresholds") if k in main},
        })
    print(smi)
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
