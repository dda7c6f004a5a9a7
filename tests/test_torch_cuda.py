"""The port on the card: CUDA kernels against their plain versions, metrics on the card
against the same metrics on the CPU.

Every test here needs an NVIDIA GPU and skips without one (the CUDA kernels have no
CPU mode). The file imports no JAX, so on a machine with a card it runs without the
suite's JAX conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

from __future__ import annotations

import pytest
import torch

torch.set_num_threads(2)

from torchmetrics_tpu_torch import classification as tc  # noqa: E402
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _linspace_thresholds  # noqa: E402
from torchmetrics_tpu_torch.ops import kernels  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _labels(n: int, c: int, seed: int, invalid: float = 0.2):
    """CPU int32 preds/target with some out-of-range and negative values, and a mask."""
    g = torch.Generator().manual_seed(seed)
    preds = torch.randint(-2, c + 2, (n,), generator=g, dtype=torch.int32)
    target = torch.randint(-1, c + 1, (n,), generator=g, dtype=torch.int32)
    valid = torch.rand(n, generator=g) >= invalid
    return preds, target, valid


@pytest.mark.parametrize(
    "n, c, invalid",
    [(0, 4, 0.2), (300, 5, 1.0), (1500, 130, 0.2), (7, 3, 0.2), (1 << 16, 10, 0.2), (1000, 2, 0.2),
     (20000, 110, 0.2), (20000, 111, 0.2), (50000, 1000, 0.2)],
)
def test_confusion_matrix_kernel_matches_plain(card, n, c, invalid):
    preds, target, valid = _labels(n, c, seed=n + c, invalid=invalid)
    got = kernels.confusion_matrix(preds.to(card), target.to(card), valid.to(card), c)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got.cpu(), kernels.confusion_matrix_plain(preds, target, valid, c))


def _curve(n: int, t: int, seed: int, unsorted: bool = False, ties: bool = False, nan: bool = False,
           invalid: float = 0.2):
    g = torch.Generator().manual_seed(seed)
    thresholds = _linspace_thresholds(t)
    if unsorted:
        thresholds = thresholds[torch.randperm(t, generator=g)]
    scores = torch.rand(n, generator=g)
    if ties and n:
        scores[: n // 2] = thresholds[torch.randint(0, t, (n // 2,), generator=g)]
    if nan and n:
        scores[torch.rand(n, generator=g) < 0.05] = float("nan")
    labels = torch.randint(0, 2, (n,), generator=g, dtype=torch.int32)
    valid = torch.rand(n, generator=g) >= invalid
    return scores, labels, valid, thresholds


@pytest.mark.parametrize(
    "n, t, kw",
    [(0, 5, {}), (200, 11, {"invalid": 1.0}), (1000, 37, {"unsorted": True}), (1024, 21, {"ties": True}),
     (777, 300, {"ties": True, "unsorted": True}), (500, 11, {"nan": True}), (1 << 16, 1000, {}),
     (3, 4096, {})],
)
def test_binned_curve_counts_kernel_matches_plain(card, n, t, kw):
    arrays = _curve(n, t, seed=n + t, **kw)
    got = kernels.binned_curve_counts(*(a.to(card) for a in arrays))
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got.cpu(), kernels.binned_curve_counts_plain(*arrays))


def test_launches_are_counted_only_for_the_kernels(card):
    kernels.reset_launch_counts()
    preds, target, valid = _labels(100, 4, seed=0)
    kernels.confusion_matrix(preds.to(card), target.to(card), valid.to(card), 4)
    kernels.confusion_matrix(preds, target, valid, 4)  # CPU: the plain version, not counted
    arrays = _curve(100, 5, seed=0)
    kernels.binned_curve_counts(*(a.to(card) for a in arrays))
    kernels.binned_curve_counts(*(a[:0].to(card) if i < 3 else a.to(card) for i, a in enumerate(arrays)))
    x = preds.to(card)
    kernels.weighted_bincount(x, torch.ones((3, 100), device=card), 4)
    kernels.bincount(x, None, 4)
    kernels.bincount(x, valid.to(card), 4)  # the masked form is the weighted kernel's K=1 case
    kernels.bincount(x[:0], None, 4)  # empty: nothing to launch
    assert kernels.LAUNCHES == {"confusion_matrix": 1, "binned_curve_counts": 1, "weighted_bincount": 2, "bincount": 1}
    with pytest.raises(ValueError, match="one device"):
        kernels.confusion_matrix(preds.to(card), target, valid, 4)


def _weighted(n: int, k: int, c: int, seed: int, zero: float = 0.2, out_of_range: float = 0.01,
              nonfinite: bool = False):
    """CPU int32 indices with some outside [0, C), float32 [K, N] weights with some zeros."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, c, (n,), generator=g, dtype=torch.int32)
    bad = torch.rand(n, generator=g) < out_of_range
    x = torch.where(bad, torch.where(x % 2 == 0, c + 3, -2), x).to(torch.int32)
    w = torch.rand((k, n), generator=g)
    w = torch.where(torch.rand((k, n), generator=g) < zero, torch.zeros_like(w), w)
    if nonfinite and n:
        w[0, n // 2] = float("nan")
        w[-1, n // 3] = float("inf")
    return x, w


# float rows: both sides sum in float64 and round once, so they agree to about one
# float32 ulp whatever order the card's atomics take
WEIGHTED_RTOL = 1e-6


@pytest.mark.parametrize(
    "n, k, c, kw",
    [(0, 3, 15, {}), (500, 3, 15, {}), (1 << 18, 3, 15, {}), (1 << 16, 1, 15, {}), (1 << 16, 3, 200, {}),
     (1 << 16, 3, 1000, {}), (1 << 16, 1, 8192, {}), (1 << 16, 3, 8192, {}), (5000, 3, 15, {"nonfinite": True}),
     (5000, 3, 2000, {"nonfinite": True}), (3000, 3, 7, {"zero": 1.0}), (77, 3, 1, {})],
)
def test_weighted_bincount_kernel_matches_plain(card, n, k, c, kw):
    x, w = _weighted(n, k, c, seed=n + k + c, **kw)
    got = kernels.weighted_bincount(x.to(card), w.to(card), c)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.dtype == torch.float32 and got.shape == (k, c)
    torch.testing.assert_close(got.cpu(), kernels.weighted_bincount_plain(x, w, c), rtol=WEIGHTED_RTOL, atol=0,
                               equal_nan=True)
    counts = kernels.weighted_bincount(x.to(card), (w != 0).to(torch.float32).to(card), c)
    assert torch.equal(counts.cpu(), kernels.weighted_bincount_plain(x, (w != 0).to(torch.float32), c))


@pytest.mark.parametrize("n, c", [(0, 5), (1000, 1), (1 << 16, 100), (1 << 16, 6980), (1 << 16, 12288),
                                  (1 << 16, 12289), (1 << 16, 1 << 16)])
def test_bincount_kernel_matches_plain(card, n, c):
    x, w = _weighted(n, 1, c, seed=n + c, out_of_range=0.05)
    got = kernels.bincount(x.to(card), None, c)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got.cpu(), kernels.bincount_plain(x, c))
    valid = w[0] > 0.5
    masked = kernels.bincount(x.to(card), valid.to(card), c)
    assert torch.equal(masked.cpu(), kernels.bincount(x, valid, c))


METRICS = {
    "accuracy_micro": lambda **k: tc.MulticlassAccuracy(7, average="micro", **k),
    "accuracy_macro": lambda **k: tc.MulticlassAccuracy(7, average="macro", ignore_index=-1, **k),
    "f1_weighted_top2": lambda **k: tc.MulticlassF1Score(7, average="weighted", top_k=2, **k),
    "confmat": lambda **k: tc.MulticlassConfusionMatrix(7, normalize="true", **k),
    "auroc_binned": lambda **k: tc.MulticlassAUROC(7, thresholds=50, **k),
    "pr_curve_micro": lambda **k: tc.MulticlassPrecisionRecallCurve(7, average="micro", thresholds=[0.9, 0.1, 0.5], **k),
    "auroc_exact": lambda **k: tc.MulticlassAUROC(7, **k),
    "calibration_l2": lambda **k: tc.MulticlassCalibrationError(7, n_bins=15, norm="l2", **k),
    "precision_macro": lambda **k: tc.MulticlassPrecision(7, average="macro", **k),
    "recall_weighted": lambda **k: tc.MulticlassRecall(7, average="weighted", **k),
    "jaccard_macro": lambda **k: tc.MulticlassJaccardIndex(7, **k),
    "mcc": lambda **k: tc.MulticlassMatthewsCorrCoef(7, **k),
    "kappa_quadratic": lambda **k: tc.MulticlassCohenKappa(7, weights="quadratic", **k),
    "average_precision_binned": lambda **k: tc.MulticlassAveragePrecision(7, thresholds=20, **k),
}


def _compare(card_value, cpu_value) -> None:
    if isinstance(card_value, (tuple, list)):
        for a, b in zip(card_value, cpu_value, strict=True):
            _compare(a, b)
        return
    assert card_value.device.type == "cuda"
    a = card_value.cpu()
    if a.is_floating_point():
        torch.testing.assert_close(a, cpu_value, atol=1e-5, rtol=0)
    else:
        assert torch.equal(a, cpu_value)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_on_the_card_equals_the_cpu(card, name):
    g = torch.Generator().manual_seed(3)
    batches = []
    for _ in range(3):
        target = torch.randint(0, 7, (64,), generator=g)
        target[:4] = -1 if name == "accuracy_macro" else target[:4]
        probs = torch.softmax(torch.randn(64, 7, generator=g), dim=1)
        batches.append((probs, target))
    on_card, on_cpu = METRICS[name](), METRICS[name](device="cpu")
    assert on_card.device.type == "cuda"
    for probs, target in batches:
        _compare(on_card(probs.to(card), target.to(card)), on_cpu(probs, target))
    for key, value in on_card.state_dict(persistent_only=False).items():
        _compare(value, on_cpu.state_dict(persistent_only=False)[key])
    _compare(on_card.compute(), on_cpu.compute())
