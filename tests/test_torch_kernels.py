"""The port's two kernels held against the JAX package's Pallas kernels and XLA paths.

On the CPU each wrapper runs its plain PyTorch version; these tests hold that plain
version against the Pallas kernel in interpret mode and against the XLA path at the
kernel's call site, exactly, on the edge cases: empty input, every sample invalid,
out-of-range and negative labels, unsorted thresholds, scores equal to a threshold,
NaN scores, and class counts that are not a multiple of 128. The CUDA kernels
themselves run only on a card: ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from torchmetrics_tpu.functional.classification.confusion_matrix import _masked_confmat  # noqa: E402
from torchmetrics_tpu.functional.classification.precision_recall_curve import (  # noqa: E402
    _binary_precision_recall_curve_update,
)
from torchmetrics_tpu.ops.pallas_kernels import binned_curve_counts_pallas, confusion_matrix_pallas  # noqa: E402
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _linspace_thresholds  # noqa: E402
from torchmetrics_tpu_torch.ops import _build, kernels  # noqa: E402


def _confmat_case(n: int, c: int, seed: int, invalid: float = 0.2, out_of_range: bool = True):
    rng = np.random.RandomState(seed)
    preds = rng.randint(0, c, n).astype(np.int32)
    target = rng.randint(0, c, n).astype(np.int32)
    valid = rng.rand(n) >= invalid
    if out_of_range and n:
        bad = rng.rand(n) < 0.1
        preds[bad] = rng.choice([-1, -7, c, c + 3], bad.sum())
        bad = rng.rand(n) < 0.1
        target[bad] = rng.choice([-2, c, 2 * c], bad.sum())
    return preds, target, valid


CONFMAT_CASES = {
    "empty": (0, 4, 0.2),
    "all_invalid": (300, 5, 1.0),
    "c130_not_lane_multiple": (1500, 130, 0.2),
    "tiny": (7, 3, 0.2),
    "c10": (2048, 10, 0.2),
    "binary": (1000, 2, 0.2),
}


@pytest.mark.parametrize("case", sorted(CONFMAT_CASES))
def test_confusion_matrix_plain_matches_pallas_and_xla(case):
    n, c, invalid = CONFMAT_CASES[case]
    preds, target, valid = _confmat_case(n, c, seed=n + c, invalid=invalid)
    got = kernels.confusion_matrix(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(valid), c)
    assert got.dtype == torch.int32 and got.shape == (c, c)

    pallas = confusion_matrix_pallas(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(valid), c, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas).astype(np.int32))
    xla = _masked_confmat(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(valid), c)
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))


def _curve_case(n: int, t: int, seed: int, invalid: float = 0.2, ties: bool = False, unsorted: bool = False,
                nan: bool = False):
    rng = np.random.RandomState(seed)
    thresholds = np.asarray(_linspace_thresholds(t))
    if unsorted:
        thresholds = rng.permutation(thresholds)
    scores = rng.rand(n).astype(np.float32)
    if ties and n:
        scores[: n // 2] = rng.choice(thresholds, n // 2)
    if nan and n:
        scores[rng.rand(n) < 0.05] = np.nan
    labels = rng.randint(0, 2, n).astype(np.int32)
    valid = rng.rand(n) >= invalid
    return scores, labels, valid, thresholds.astype(np.float32)


CURVE_CASES = {
    "empty": dict(n=0, t=5),
    "all_invalid": dict(n=200, t=11, invalid=1.0),
    "unsorted_thresholds": dict(n=1000, t=37, unsorted=True),
    "ties_at_thresholds": dict(n=1024, t=21, ties=True),
    "ties_unsorted": dict(n=777, t=200, ties=True, unsorted=True),
    "nan_scores": dict(n=500, t=11, nan=True),
    "t100": dict(n=2048, t=100),
}


@pytest.mark.parametrize("case", sorted(CURVE_CASES))
def test_binned_curve_counts_plain_matches_pallas_and_xla(case):
    kw = CURVE_CASES[case]
    scores, labels, valid, thresholds = _curve_case(seed=kw["n"] + kw["t"], **kw)
    got = kernels.binned_curve_counts(
        torch.from_numpy(scores), torch.from_numpy(labels), torch.from_numpy(valid), torch.from_numpy(thresholds)
    )
    assert got.dtype == torch.int32 and got.shape == (len(thresholds), 2)

    pallas = binned_curve_counts_pallas(
        jnp.asarray(scores), jnp.asarray(labels), jnp.asarray(valid), jnp.asarray(thresholds), interpret=True
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas).astype(np.int32))
    state = np.asarray(
        _binary_precision_recall_curve_update(
            jnp.asarray(scores), jnp.asarray(labels), jnp.asarray(valid), jnp.asarray(thresholds)
        )
    )
    np.testing.assert_array_equal(got[:, 0].numpy(), state[:, 1, 1])
    np.testing.assert_array_equal(got[:, 1].numpy(), state[:, 0, 1])


@pytest.mark.parametrize("num", [2, 3, 5, 7, 10, 11, 42, 48, 56, 62, 83, 100, 101, 200, 1000, 4096])
def test_threshold_grid_is_bitwise_jnp_linspace(num):
    got = _linspace_thresholds(num)
    want = np.asarray(jnp.linspace(0.0, 1.0, num))
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want.tobytes()


def test_cpu_tensors_take_the_plain_version_without_counting():
    kernels.reset_launch_counts()
    preds, target, valid = _confmat_case(64, 4, seed=1)
    kernels.confusion_matrix(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(valid), 4)
    scores, labels, valid, thr = _curve_case(64, 5, seed=1)
    kernels.binned_curve_counts(*(torch.from_numpy(a) for a in (scores, labels, valid, thr)))
    x = torch.from_numpy(preds)
    kernels.weighted_bincount(x, torch.ones((3, 64)), 4)
    kernels.bincount(x, None, 4)
    kernels.bincount(x, torch.from_numpy(valid), 4)
    planes = torch.rand(2, 12, 13)
    kernels.ssim_moments(planes, planes, torch.ones(3) / 3, torch.ones(5) / 5)
    assert kernels.LAUNCHES == {
        "confusion_matrix": 0, "binned_curve_counts": 0, "weighted_bincount": 0, "bincount": 0, "ssim_moments": 0,
    }


@pytest.mark.parametrize("which", ["confusion_matrix", "binned_curve_counts"])
def test_wrappers_raise_on_other_devices(which):
    meta = torch.empty(8, dtype=torch.int32, device="meta")
    cpu = torch.zeros(8, dtype=torch.int32)
    if which == "confusion_matrix":
        with pytest.raises(ValueError, match="CUDA or CPU"):
            kernels.confusion_matrix(meta, meta, meta.bool(), 3)
        with pytest.raises(ValueError, match="one device"):
            kernels.confusion_matrix(meta, cpu, cpu.bool(), 3)
    else:
        thr = torch.empty(4, device="meta")
        with pytest.raises(ValueError, match="CUDA or CPU"):
            kernels.binned_curve_counts(meta.float(), meta, meta.bool(), thr)
        with pytest.raises(ValueError, match="one device"):
            kernels.binned_curve_counts(cpu.float(), cpu, cpu.bool(), thr)


def test_build_targets_hopper_and_raises_without_nvcc(monkeypatch):
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.BUILD_DIR.parts[-2:] == ("build", "torch_kernels")
    names = {_build._library_path(name).name for name in _build.SOURCES}
    assert len(names) == len(_build.SOURCES)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
    monkeypatch.setattr(_build, "_library_path", lambda name: _build.BUILD_DIR / f"lib{name}_absent.so")
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        _build.build_all()
