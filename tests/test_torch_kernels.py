"""The port's two kernels held against the JAX package's Pallas kernels and XLA paths.

On the CPU each wrapper runs its plain PyTorch version; these tests hold that plain
version against the Pallas kernel in interpret mode and against the XLA path at the
kernel's call site, exactly, on the edge cases: empty input, every sample invalid,
out-of-range and negative labels, unsorted thresholds, scores equal to a threshold,
NaN scores and thresholds, duplicate thresholds, +-0.0, +-inf, float64 scores, class
counts that are not a multiple of 128, and int64 labels beyond the int32 range (JAX
takes them by their low 32 bits, and so do the plain versions). The
confusion-matrix wrapper's refusals are tested here too. The CUDA kernels
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
from torchmetrics_tpu.ops.pallas_kernels import (  # noqa: E402
    bincount_pallas,
    binned_curve_counts_pallas,
    confusion_matrix_pallas,
    weighted_bincount_pallas,
)
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


def _wide(rng, values: np.ndarray) -> np.ndarray:
    """int64 ``values`` plus multiples of 2^32, and the two int64 values next to the int32
    range's ends: JAX (64-bit types off) keeps the low 32 bits of each."""
    wide = values.astype(np.int64) + rng.choice([-2, -1, 0, 1, 2], values.shape[0]).astype(np.int64) * (1 << 32)
    if wide.shape[0] >= 2:
        wide[:2] = [1 << 31, -(1 << 31) - 1]  # int32 -2^31 and 2^31 - 1: outside any [0, C)
    return wide


def _int64_mask(rng, n: int) -> np.ndarray:
    """An int64 mask of 0 and 1 plus multiples of 2^32: non-zero entries that are 0 in
    int32. (The JAX confusion-matrix kernel weights a pair by its mask's value, the port
    counts a pair whose mask is not 0: they agree on masks of 0 and 1, and every caller
    passes a bool mask.)"""
    return (rng.randint(0, 2, n) + rng.choice([-1, 0, 1, 3], n) * (1 << 32)).astype(np.int64)


def _wide_cases(kernel: str, n: int = 2000, c: int = 7):
    """(port result, JAX kernel in interpret mode) on int64 labels at +-2^32 + k."""
    rng = np.random.RandomState(hash(kernel) % 1000)
    if kernel.startswith("confusion_matrix"):
        preds, target = _wide(rng, rng.randint(-2, c + 2, n)), _wide(rng, rng.randint(-2, c + 2, n))
        valid = _int64_mask(rng, n) if kernel.endswith("int64_mask") else rng.rand(n) >= 0.2
        got = kernels.confusion_matrix(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(valid), c)
        want = confusion_matrix_pallas(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(valid), c, interpret=True)
    elif kernel == "binned_curve_counts_micro_one_hot":
        # the micro-averaged curve's flattened (sample, class) pairs: softmax scores and
        # int64 one-hot labels, here with multiples of 2^32 added
        rows = n // c
        logits = rng.randn(rows, c)
        probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32).reshape(-1)
        onehot = (rng.randint(0, c, rows)[:, None] == np.arange(c)[None, :]).astype(np.int64).reshape(-1)
        labels = _wide(rng, onehot)
        valid = np.repeat(rng.rand(rows) >= 0.1, c)
        thresholds = np.asarray(_linspace_thresholds(200))
        got = kernels.binned_curve_counts(*(torch.from_numpy(a) for a in (probs, labels, valid, thresholds)))
        want = binned_curve_counts_pallas(jnp.asarray(probs), jnp.asarray(labels), jnp.asarray(valid),
                                          jnp.asarray(thresholds), interpret=True)
    elif kernel.startswith("binned_curve_counts"):
        scores = rng.rand(n).astype(np.float32)
        labels = _wide(rng, rng.randint(0, 2, n))
        valid = _int64_mask(rng, n) if kernel.endswith("int64_mask") else rng.rand(n) >= 0.2
        thresholds = np.asarray(_linspace_thresholds(11))
        got = kernels.binned_curve_counts(*(torch.from_numpy(a) for a in (scores, labels, valid, thresholds)))
        want = binned_curve_counts_pallas(jnp.asarray(scores), jnp.asarray(labels), jnp.asarray(valid),
                                          jnp.asarray(thresholds), interpret=True)
    elif kernel == "weighted_bincount":
        x = _wide(rng, rng.randint(-2, c + 2, n))
        weights = rng.randint(0, 3, (3, n)).astype(np.float32)  # integer sums: exact in float32
        got = kernels.weighted_bincount(torch.from_numpy(x), torch.from_numpy(weights), c)
        want = weighted_bincount_pallas(jnp.asarray(x), jnp.asarray(weights), c, interpret=True)
    else:
        x = _wide(rng, rng.randint(-2, c + 2, n))
        valid = {"bincount": None, "bincount_masked": rng.rand(n) >= 0.2, "bincount_int64_mask": _int64_mask(rng, n)}[
            kernel]
        got = kernels.bincount(torch.from_numpy(x), None if valid is None else torch.from_numpy(valid), c)
        want = bincount_pallas(jnp.asarray(x), None if valid is None else jnp.asarray(valid), c, interpret=True)
    return got, np.asarray(want)


@pytest.mark.parametrize("kernel", [
    "confusion_matrix", "confusion_matrix_int64_mask", "binned_curve_counts", "binned_curve_counts_int64_mask",
    "binned_curve_counts_micro_one_hot", "weighted_bincount", "bincount", "bincount_masked", "bincount_int64_mask",
])
def test_plain_versions_take_int64_labels_as_jax_does(kernel):
    got, want = _wide_cases(kernel)
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want.astype(got.numpy().dtype))


CONFMAT_DTYPES = {
    "int64_both": (np.int64, np.int64, np.bool_),
    "int64_preds_int32_target": (np.int64, np.int32, np.bool_),
    "int32_preds_int64_target": (np.int32, np.int64, np.bool_),
    "int16_labels": (np.int16, np.int16, np.bool_),
    "uint8_labels_uint8_mask": (np.uint8, np.uint8, np.uint8),
    "int32_mask": (np.int32, np.int32, np.int32),
    "bool_labels": (np.bool_, np.bool_, np.bool_),
}


@pytest.mark.parametrize("case", sorted(CONFMAT_DTYPES))
@pytest.mark.parametrize("layout", ["contiguous", "strided"])
def test_confusion_matrix_plain_on_any_integer_dtype_matches_pallas(case, layout):
    pd, td, vd = CONFMAT_DTYPES[case]
    c = 2 if pd is np.bool_ else 6
    rng = np.random.RandomState(len(case))
    low = 0 if np.dtype(pd).kind in "ub" else -2
    preds = rng.randint(low, c + 2, 2 * 999).astype(pd)
    target = rng.randint(low, c + 2, 2 * 999).astype(td)
    valid = rng.randint(0, 2, 2 * 999).astype(vd)
    if layout == "strided":  # every other element: views that are not contiguous
        args = [torch.from_numpy(a)[::2] for a in (preds, target, valid)]
        preds, target, valid = preds[::2], target[::2], valid[::2]
        assert not args[0].is_contiguous()
    else:
        args = [torch.from_numpy(a) for a in (preds, target, valid)]
    got = kernels.confusion_matrix(*args, c)
    assert got.dtype == torch.int32 and got.shape == (c, c)
    want = confusion_matrix_pallas(jnp.asarray(preds), jnp.asarray(target), jnp.asarray(valid), c, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int32))


CONFMAT_REFUSALS = {
    "float_preds": (TypeError, "integer or bool", lambda p, t, v: (p.float(), t, v, 4)),
    "float_mask": (TypeError, "integer or bool", lambda p, t, v: (p, t, v.float(), 4)),
    "complex_target": (TypeError, "integer or bool", lambda p, t, v: (p, t.to(torch.complex64), v, 4)),
    "short_target": (ValueError, "one length", lambda p, t, v: (p, t[:-1], v, 4)),
    "long_mask": (ValueError, "one length", lambda p, t, v: (p, t, torch.cat([v, v[:1]]), 4)),
    "one_element_target": (ValueError, "one length", lambda p, t, v: (p, t[:1], v, 4)),
    "negative_classes": (ValueError, "num_classes", lambda p, t, v: (p, t, v, -1)),
    "too_many_classes": (ValueError, "num_classes", lambda p, t, v: (p, t, v, 46341)),
    "meta_tensors": (ValueError, "CUDA or CPU", lambda p, t, v: (p.to("meta"), t.to("meta"), v.to("meta"), 4)),
    "meta_and_cpu": (ValueError, "one device", lambda p, t, v: (p, t.to("meta"), v, 4)),
}


@pytest.mark.parametrize("case", sorted(CONFMAT_REFUSALS))
def test_confusion_matrix_wrapper_refusals(case):
    error, match, make = CONFMAT_REFUSALS[case]
    preds, target, valid = (torch.from_numpy(a) for a in _confmat_case(50, 4, seed=2))
    with pytest.raises(error, match=match):
        kernels.confusion_matrix(*make(preds, target, valid))


def test_confusion_matrix_takes_any_shape_of_n_elements():
    preds, target, valid = (torch.from_numpy(a) for a in _confmat_case(48, 5, seed=3))
    want = kernels.confusion_matrix(preds, target, valid, 5)
    got = kernels.confusion_matrix(preds.reshape(6, 8), target.reshape(4, 12), valid.reshape(2, 3, 8), 5)
    assert torch.equal(got, want)
    assert kernels.confusion_matrix(preds, target, valid, 0).shape == (0, 0)


@pytest.mark.parametrize("n, c, blocks", [
    (8192, 2, 0), (8193, 2, 9), (1 << 20, 2, 132), (1 << 20, 110, 132), (1 << 20, 111, 0), (50000, 10, 49),
    (1 << 20, 1000, 0), (0, 1, 0),
])
def test_confusion_matrix_scratch_holds_a_slot_for_each_block_of_the_grid(monkeypatch, n, c, blocks):
    """The grid of the shared-memory modes (N > 8192, C <= 110) takes one 1024-thread
    block per SM at most, each with an int32 [C, C] slot; the other modes take none."""
    monkeypatch.setattr(kernels, "_SM_COUNTS", {0: 132})
    assert kernels._confusion_slots_bytes(0, n, c) == blocks * c * c * 4


@pytest.mark.parametrize("n, c, blocks", [
    (8192, 6980, 0), (8193, 6980, 9), (6980 * 1000, 6980, 132), (1 << 20, 1, 132), (1 << 20, 57856, 132),
    (1 << 20, 6981, 132), (1 << 20, 385, 132),
    (1 << 20, 57857, 0), (50000, 100, 49), (1 << 20, 1 << 20, 0), (0, 1, 0),
])
def test_bincount_scratch_holds_a_slot_for_each_block_of_the_grid(monkeypatch, n, c, blocks):
    """The grid of the shared-memory modes (N > 8192, C <= 57,856) takes one 1024-thread
    block per SM at most, each with an int32 slot of C bins rounded up to 4; the other
    modes take none."""
    monkeypatch.setattr(kernels, "_SM_COUNTS", {0: 132})
    assert kernels._bincount_slots_bytes(0, n, c) == blocks * -(-c // 4) * 16


def _curve_case(n: int, t: int, seed: int, invalid: float = 0.2, ties: bool = False, unsorted: bool = False,
                nan: bool = False, thresholds=None, specials: bool = False, scores_dtype=np.float32):
    """The default grid of ``t`` thresholds and uniform scores, or the ``thresholds``
    given and normal scores. ``ties`` sets half the scores to thresholds, ``specials``
    puts +-inf, NaN and +-0.0 among them; float64 scores are ties moved by ~1e-12, which
    the conversion to float32 rounds back onto the threshold or next to it."""
    rng = np.random.RandomState(seed)
    if thresholds is None:
        thresholds = np.asarray(_linspace_thresholds(t))
        scores = rng.rand(n).astype(np.float32)
    else:
        thresholds = np.asarray(thresholds, dtype=np.float32)
        scores = (rng.randn(n) * 1.5).astype(np.float32)
    if unsorted:
        thresholds = rng.permutation(thresholds)
    if ties and n:
        scores[: n // 2] = rng.choice(thresholds, n // 2)
    if nan and n:
        scores[rng.rand(n) < 0.05] = np.nan
    if specials and n:
        picks = rng.randint(0, n, max(1, n // 50))
        scores[picks] = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0], np.float32)[np.arange(picks.size) % 5]
    if scores_dtype == np.float64:
        scores = scores.astype(np.float64) + rng.randn(n) * 1e-12
    labels = rng.randint(0, 2, n).astype(np.int32)
    valid = rng.rand(n) >= invalid
    return scores, labels, valid, thresholds.astype(np.float32)


NAN, INF = float("nan"), float("inf")
CURVE_CASES = {
    "empty": dict(n=0, t=5),
    "all_invalid": dict(n=200, t=11, invalid=1.0),
    "unsorted_thresholds": dict(n=1000, t=37, unsorted=True),
    "ties_at_thresholds": dict(n=1024, t=21, ties=True),
    "ties_unsorted": dict(n=777, t=200, ties=True, unsorted=True),
    "nan_scores": dict(n=500, t=11, nan=True),
    "t100": dict(n=2048, t=100),
    # threshold lists a user may pass, each with ties, +-inf, NaN and +-0.0 among the scores
    "nan_thresholds_tail": dict(n=1000, t=7, thresholds=[0.0, 0.25, 0.5, 0.75, 1.0, NAN, NAN], ties=True,
                                specials=True),
    "nan_thresholds_middle": dict(n=1000, t=6, thresholds=[0.0, 0.25, NAN, 0.75, 1.0, 0.5], ties=True,
                                  specials=True),
    "all_nan_thresholds": dict(n=500, t=4, thresholds=[NAN] * 4, specials=True),
    "duplicate_thresholds": dict(n=1000, t=8, thresholds=[0.3, 0.3, 0.3, 0.7, 0.7, 0.1, 0.1, 0.3], ties=True,
                                 specials=True),
    "t1": dict(n=1000, t=1, thresholds=[0.5], ties=True, specials=True),
    "signed_zeros": dict(n=1000, t=5, thresholds=[0.0, -0.0, 0.25, -0.0, 0.0], ties=True, specials=True),
    "inf_scores": dict(n=1000, t=5, thresholds=[-INF, 0.0, 0.5, 1.0, INF], ties=True, specials=True),
    "thresholds_outside_unit": dict(n=2000, t=7, thresholds=[1.5, -2.0, 0.5, 3.0, -0.5, 0.0, 1.0], ties=True,
                                    specials=True),
    "float64_scores": dict(n=2000, t=50, ties=True, unsorted=True, scores_dtype=np.float64),
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


@pytest.mark.parametrize("which", ["confusion_matrix", "binned_curve_counts", "weighted_bincount", "ssim_moments"])
def test_wrappers_raise_on_other_devices(which):
    meta = torch.empty(8, dtype=torch.int32, device="meta")
    cpu = torch.zeros(8, dtype=torch.int32)
    if which == "confusion_matrix":
        with pytest.raises(ValueError, match="CUDA or CPU"):
            kernels.confusion_matrix(meta, meta, meta.bool(), 3)
        with pytest.raises(ValueError, match="one device"):
            kernels.confusion_matrix(meta, cpu, cpu.bool(), 3)
    elif which == "binned_curve_counts":
        thr = torch.empty(4, device="meta")
        with pytest.raises(ValueError, match="CUDA or CPU"):
            kernels.binned_curve_counts(meta.float(), meta, meta.bool(), thr)
        with pytest.raises(ValueError, match="one device"):
            kernels.binned_curve_counts(cpu.float(), cpu, cpu.bool(), thr)
    elif which == "weighted_bincount":
        with pytest.raises(ValueError, match="CUDA or CPU"):
            kernels.weighted_bincount(meta, meta.float().reshape(1, 8), 3)
        with pytest.raises(ValueError, match="one device"):
            kernels.weighted_bincount(cpu, meta.float().reshape(1, 8), 3)
    else:
        planes, window = torch.empty(2, 9, 9, device="meta"), torch.empty(3, device="meta")
        with pytest.raises(ValueError, match="CUDA or CPU"):
            kernels.ssim_moments(planes, planes, window, window)
        with pytest.raises(ValueError, match="one device"):
            kernels.ssim_moments(planes, planes, torch.ones(3) / 3, window)


SSIM_BAD_SHAPES = {
    "planes_not_3d": ((12, 13), (12, 13), 3, 3),
    "target_shape_differs": ((2, 12, 13), (2, 12, 14), 3, 3),
    "empty_window": ((2, 12, 13), (2, 12, 13), 0, 3),
    "window_wider_than_the_plane": ((2, 12, 13), (2, 12, 13), 3, 14),
}


@pytest.mark.parametrize("case", sorted(SSIM_BAD_SHAPES))
def test_ssim_moments_rejects_bad_shapes(case):
    p_shape, t_shape, kh, kw = SSIM_BAD_SHAPES[case]
    with pytest.raises(ValueError, match="Expected|larger than"):
        kernels.ssim_moments(torch.rand(p_shape), torch.rand(t_shape), torch.ones(kh) / 3, torch.ones(kw) / 3)


@pytest.mark.parametrize("layout", ["float64_planes", "transposed_planes", "row_vector_windows", "float64_windows"])
def test_ssim_moments_takes_any_dtype_and_layout(layout):
    g = torch.Generator().manual_seed(3)
    p, t = torch.rand(2, 20, 17, generator=g), torch.rand(2, 20, 17, generator=g)
    wh, ww = torch.rand(5, generator=g), torch.rand(3, generator=g)
    want = kernels.ssim_moments_plain(p, t, wh, ww)
    args = {
        "float64_planes": (p.double(), t.double(), wh, ww),
        "transposed_planes": (p.transpose(1, 2).contiguous().transpose(1, 2), t, wh, ww),
        "row_vector_windows": (p, t, wh[None, :], ww[None, :]),
        "float64_windows": (p, t, wh.double(), ww.double()),
    }[layout]
    got = kernels.ssim_moments(*args)
    assert got.dtype == torch.float32 and got.shape == (2, 5, 16, 15)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("edit", ["source", "header", "flags", "other_source"])
def test_library_name_hashes_its_source_the_headers_and_the_flags(tmp_path, monkeypatch, edit):
    for f in [*_build.CSRC.glob("*.cu"), *_build.CSRC.glob("*.cuh")]:
        (tmp_path / f.name).write_bytes(f.read_bytes())
    assert list(tmp_path.glob("*.cuh"))
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build._library_path("ssim_moments")
    if edit == "flags":
        monkeypatch.setattr(_build, "NVCC_FLAGS", [*_build.NVCC_FLAGS, "-lineinfo"])
    else:
        name = {"source": "ssim_moments.cu", "other_source": "bincount.cu"}.get(edit)
        target = tmp_path / name if name else next(tmp_path.glob("*.cuh"))
        target.write_bytes(target.read_bytes() + b"\n// edited\n")
    assert (_build._library_path("ssim_moments") == before) == (edit == "other_source")


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
