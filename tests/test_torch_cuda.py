"""The port on the card: CUDA kernels against their plain versions, metrics on the card
against the same metrics on the CPU.

Every test here needs an NVIDIA GPU and skips without one (the CUDA kernels have no
CPU mode). The file imports no JAX, so on a machine with a card it runs without the
suite's JAX conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

from __future__ import annotations

import ctypes
import importlib
import json
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(2)

from torchmetrics_tpu_torch import MetricCollection  # noqa: E402
from torchmetrics_tpu_torch import classification as tc  # noqa: E402
from torchmetrics_tpu_torch import image as ti  # noqa: E402
from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _linspace_thresholds  # noqa: E402
from torchmetrics_tpu_torch.functional.image import (  # noqa: E402
    multiscale_structural_similarity_index_measure,
    structural_similarity_index_measure,
)
from torchmetrics_tpu_torch.functional.image.utils import _gaussian  # noqa: E402
from torchmetrics_tpu_torch.ops import _build, kernels  # noqa: E402
from torchmetrics_tpu_torch.utils.data import _flexible_bincount  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _labels(n: int, c: int, seed: int, invalid: float = 0.2, dtypes: str = "int32"):
    """CPU preds/target with some out-of-range and negative values, and a mask. ``dtypes``
    makes preds, target or both int64 ("int64_preds", "int64_target", "int64"); int64
    labels also carry multiples of 2^32, which the kernel drops as JAX's int32 does."""
    g = torch.Generator().manual_seed(seed)
    preds = torch.randint(-2, c + 2, (n,), generator=g, dtype=torch.int32)
    target = torch.randint(-1, c + 1, (n,), generator=g, dtype=torch.int32)
    valid = torch.rand(n, generator=g) >= invalid
    if dtypes in ("int64", "int64_preds"):
        preds = preds.long() + (torch.randint(-2, 3, (n,), generator=g) << 32)
    if dtypes in ("int64", "int64_target"):
        target = target.long() + (torch.randint(-2, 3, (n,), generator=g) << 32)
    return preds, target, valid


def _dirty_allocator(card: torch.device, c: int, cells: int = 0) -> None:
    """Leave a freed block of junk in the caching allocator where the next [C, C] output
    (or one of ``cells`` int32 cells) will likely land, so that a cell the kernel left
    unwritten would show."""
    junk = torch.full((max(cells or c * c, 1),), 0x5A5A5A5A, dtype=torch.int32, device=card)
    del junk


def _traced_calls(kernel: str, cases: list) -> list:
    """For each case, the device kernels (name -> count) of one call of ``kernel`` on the
    card: the fullest of five torch.profiler traces of one call each (a trace may drop a
    kernel but never adds one)."""
    from torch.profiler import ProfilerActivity, profile

    card, result = torch.device("cuda"), []
    for case in cases:
        if kernel == "confusion_matrix":
            n, c, dtypes = case
            preds, target, valid = (a.to(card) for a in _labels(n, c, seed=4, dtypes=dtypes))
            call = lambda: kernels.confusion_matrix(preds, target, valid, c)  # noqa: E731
        elif kernel == "binned_curve_counts":
            n, t, variant = case
            arrays = [a.to(card) for a in _curve(n, t, seed=4, **CURVE_VARIANTS[variant])]
            call = lambda: kernels.binned_curve_counts(*arrays)  # noqa: E731
        elif kernel == "grouped_imagenet_step":
            col = MetricCollection(_imagenet_set(card))
            probs, target = (a.to(card) for a in _imagenet_batches(1, n=case)[0])
            call = lambda: col.update(probs, target)  # noqa: E731
        elif kernel == "bincount":
            n, c, ids = case
            x = _bincount_ids(n, c, seed=4, ids=ids).to(card)
            call = lambda: kernels.bincount(x, None, c)  # noqa: E731
        else:
            x, w = (a.to(card) for a in _weighted(case, 3, 15, seed=4))
            call = lambda: kernels.weighted_bincount(x, w, 15)  # noqa: E731
        call()  # the scratch exists
        torch.cuda.synchronize()
        traces = []
        for _ in range(5):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            traces.append({e.key: e.count for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA and e.count})
        result.append(max(traces, key=lambda names: sum(names.values())))
    return result


def _traced_in_a_new_process(kernel: str, cases: list) -> list:
    """``_traced_calls`` run in a new Python process. A process that has run many
    torch.profiler traces and kernels may record no device event in its later traces, so
    the count is taken where the profiler starts fresh."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import json, sys; sys.path[:0] = sys.argv[1:3]; import test_torch_cuda as t; "
            "print(json.dumps(t._traced_calls(sys.argv[3], json.loads(sys.argv[4]))))")
    done = subprocess.run([sys.executable, "-c", code, here, os.path.dirname(here), kernel, json.dumps(cases)],
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    return json.loads(done.stdout.strip().splitlines()[-1])


# each side of every mode's limit: one block up to N = 8192; per-lane copies up to
# C = 19, one copy per block up to C = 110, the output zeroed before counting above
CONFMAT_SHAPES = [
    (0, 4, 0.2), (300, 5, 1.0), (1500, 130, 0.2), (7, 3, 0.2), (1 << 16, 10, 0.2), (1000, 2, 0.2),
    (20000, 110, 0.2), (20000, 111, 0.2), (50000, 1000, 0.2),
    (0, 1, 0.2), (1, 1, 0.0), (1, 2, 0.0), (0, 1000, 0.2), (1, 1000, 0.0), (500, 1000, 0.2),
    (8192, 19, 0.2), (8193, 19, 0.2), (8192, 20, 0.2), (8193, 20, 0.2), (8192, 110, 0.2), (8193, 110, 0.2),
    (8192, 111, 0.2), (8193, 111, 0.2), (1 << 18, 2, 0.2), (1 << 18, 1, 0.2), (1 << 20, 10, 0.2),
    (1 << 20, 100, 0.2), (1 << 20, 1000, 0.2),
]


@pytest.mark.parametrize("dtypes", ["int32", "int64", "int64_preds", "int64_target"])
@pytest.mark.parametrize("n, c, invalid", CONFMAT_SHAPES)
def test_confusion_matrix_kernel_matches_plain(card, n, c, invalid, dtypes):
    preds, target, valid = _labels(n, c, seed=n + c, invalid=invalid, dtypes=dtypes)
    _dirty_allocator(card, c)
    got = kernels.confusion_matrix(preds.to(card), target.to(card), valid.to(card), c)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got.cpu(), kernels.confusion_matrix_plain(preds, target, valid, c))


CONFMAT_LAYOUTS = {
    "uint8_mask": lambda p, t, v: (p, t, v.to(torch.uint8)),
    "int64_mask_with_high_bits": lambda p, t, v: (p, t, v.long() + (torch.arange(v.numel()) % 3 << 32)),
    "int32_mask": lambda p, t, v: (p, t, v.int() * 7),
    "strided_labels": lambda p, t, v: (torch.stack([p, p], dim=1)[:, 0], t.repeat(2)[::2], v),
    "strided_mask": lambda p, t, v: (p, t, torch.stack([v, ~v], dim=1)[:, 0]),
    "2d_labels_and_mask": lambda p, t, v: (p.reshape(-1, 8), t.reshape(8, -1), v.reshape(4, -1)),
    "int16_labels": lambda p, t, v: (p.to(torch.int16), t.to(torch.int16), v),
    "uint8_labels": lambda p, t, v: (p.clamp(min=0).to(torch.uint8), t.clamp(min=0).to(torch.uint8), v),
    "bool_labels": lambda p, t, v: (p > 2, t > 2, v),
}


@pytest.mark.parametrize("n, c", [(4096, 5), (1 << 16, 10), (1 << 16, 111)])
@pytest.mark.parametrize("layout", sorted(CONFMAT_LAYOUTS))
def test_confusion_matrix_kernel_takes_masks_and_layouts(card, layout, n, c):
    preds, target, valid = CONFMAT_LAYOUTS[layout](*_labels(n, c, seed=c, dtypes="int64_preds"))
    got = kernels.confusion_matrix(preds.to(card), target.to(card), valid.to(card), c)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), kernels.confusion_matrix_plain(preds, target, valid, c))


@pytest.mark.parametrize("n, c", [(0, 111), (500, 1000), (1 << 18, 111), (1 << 18, 1000), (3, 4096)])
def test_confusion_matrix_zeroes_a_large_output(card, n, c):
    """The cooperative launch zeroes an output beyond shared memory inside the kernel:
    every cell of an output that the allocator filled with junk is written."""
    preds, target, valid = _labels(n, c, seed=n + c, dtypes="int64_preds")
    _dirty_allocator(card, c)
    got = kernels.confusion_matrix(preds.to(card), target.to(card), valid.to(card), c)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), kernels.confusion_matrix_plain(preds, target, valid, c))


def test_confusion_matrix_calls_of_other_shapes_share_the_scratch(card):
    """Back-to-back calls of other shapes and modes on one stream, each equal to the
    plain version: every grid launch writes the slots it reads, whatever an earlier call
    left in the cached scratch."""
    shapes = [(1 << 18, 2), (1 << 18, 110), (700, 10), (1 << 18, 19), (1 << 17, 1000), (1 << 18, 2), (9000, 110),
              (1 << 18, 20), (8193, 1)]
    cases = [(_labels(n, c, seed=i, dtypes=("int32", "int64")[i % 2]), c) for i, (n, c) in enumerate(shapes)]
    got = [kernels.confusion_matrix(p.to(card), t.to(card), v.to(card), c) for (p, t, v), c in cases]
    torch.cuda.synchronize()
    for out, ((p, t, v), c) in zip(got, cases):
        assert torch.equal(out.cpu(), kernels.confusion_matrix_plain(p, t, v, c))


def test_confusion_matrix_refuses_a_scratch_too_small_for_its_grid(card):
    """The C entry point checks the slots' size that the wrapper computes: a null or a
    short scratch is refused before any launch, the exact size counts."""
    n, c = 1 << 16, 10
    preds, target, valid = (a.to(card) for a in _labels(n, c, seed=3))
    need = kernels._confusion_slots_bytes(torch.cuda.current_device(), n, c)
    scratch = torch.empty(need, dtype=torch.uint8, device=card)
    out = torch.empty((c, c), dtype=torch.int32, device=card)
    fn = kernels._entry_point("confusion_matrix")
    stream = kernels._raw_stream(torch.cuda.current_device())

    def call(slots, nbytes):
        return fn(preds.data_ptr(), 4, target.data_ptr(), 4, valid.data_ptr(), n, c, slots, nbytes, out.data_ptr(),
                  stream)

    assert need > 0 and call(None, 0) != 0 and call(scratch.data_ptr(), need - 4) != 0
    assert call(scratch.data_ptr(), need) == 0
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), kernels.confusion_matrix_plain(preds.cpu(), target.cpu(), valid.cpu(), c))


def test_confusion_matrix_on_two_streams_interleaved(card):
    """Each stream has its own scratch: calls queued alternately on two streams, which
    may run at once, each equal to the plain version."""
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    cases = []
    for i, c in enumerate([2, 10, 110, 1000, 2, 19]):
        p, t, v = _labels(1 << 18, c, seed=c + i, dtypes="int64_preds")
        cases.append((p.to(card), t.to(card), v.to(card), c))
    torch.cuda.synchronize()
    outs = []
    for i, (p, t, v, c) in enumerate(cases * 3):
        with torch.cuda.stream(streams[i % 2]):
            outs.append((kernels.confusion_matrix(p, t, v, c), p, t, v, c))
    torch.cuda.synchronize()
    assert len({key for key in kernels._CONFUSION_SCRATCH if key[1] in {s.cuda_stream for s in streams}}) == 2
    for out, p, t, v, c in outs:
        assert torch.equal(out.cpu(), kernels.confusion_matrix_plain(p.cpu(), t.cpu(), v.cpu(), c))


CONFMAT_TRACED = [(500, 1000, "int64_preds"), (1 << 18, 2, "int32"), (1 << 20, 10, "int32"), (8192, 100, "int64"),
                  (1 << 20, 1000, "int32")]


@pytest.fixture(scope="module")
def confusion_matrix_traces() -> list:
    return _traced_in_a_new_process("confusion_matrix", CONFMAT_TRACED)


@pytest.mark.parametrize("case", range(len(CONFMAT_TRACED)), ids=[f"{n}-{c}-{d}" for n, c, d in CONFMAT_TRACED])
def test_one_confusion_matrix_call_runs_one_device_kernel(card, confusion_matrix_traces, case):
    """One kernel per call, nothing else: no cast, no fill, no memset."""
    ran = confusion_matrix_traces[case]
    kernel_names = [name for name in ran if "confusion_matrix" in name]
    assert len(kernel_names) == 1 and ran[kernel_names[0]] == 1, ran
    assert sum(ran.values()) == 1, ran


def test_a_cuda_tensor_never_reaches_the_plain_confusion_matrix(card, monkeypatch):
    def refuse(*args):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(kernels, "confusion_matrix_plain", refuse)
    for n, c in [(0, 3), (100, 2), (1 << 16, 50), (500, 1000)]:
        preds, target, valid = (a.to(card) for a in _labels(n, c, seed=5, dtypes="int64_preds"))
        kernels.confusion_matrix(preds, target, valid, c)
    torch.cuda.synchronize()


def _curve(n: int, t: int, seed: int, unsorted: bool = False, ties: bool = False, nan: bool = False,
           invalid: float = 0.2, thresholds=None, int64: bool = False, specials: bool = False,
           scores_dtype: torch.dtype = torch.float32):
    """CPU scores, labels, mask and thresholds: the default grid of ``t`` thresholds, or
    the ``thresholds`` given. ``ties`` sets half the scores to thresholds, ``specials``
    puts +-inf, NaN and +-0.0 among them, ``int64`` makes int64 labels that carry
    multiples of 2^32 (the kernel takes their low 32 bits, as JAX does)."""
    g = torch.Generator().manual_seed(seed)
    if thresholds is None:
        thresholds = _linspace_thresholds(t)
        scores = torch.rand(n, generator=g)
    else:
        thresholds = torch.tensor(thresholds, dtype=torch.float32)
        scores = torch.randn(n, generator=g) * 1.5
    t = thresholds.numel()
    if unsorted:
        thresholds = thresholds[torch.randperm(t, generator=g)]
    if ties and n:
        scores[: n // 2] = thresholds[torch.randint(0, t, (n // 2,), generator=g)]
    if nan and n:
        scores[torch.rand(n, generator=g) < 0.05] = float("nan")
    if specials and n:
        picks = torch.randint(0, n, (max(1, n // 50),), generator=g)
        special = torch.tensor([float("inf"), float("-inf"), float("nan"), 0.0, -0.0])
        scores[picks] = special[torch.arange(picks.numel()) % 5]
    labels = torch.randint(0, 2, (n,), generator=g, dtype=torch.int32)
    if int64:
        labels = labels.long() + (torch.randint(-2, 3, (n,), generator=g) << 32)
    valid = torch.rand(n, generator=g) >= invalid
    return scores.to(scores_dtype), labels, valid, thresholds


@pytest.mark.parametrize(
    "n, t, kw",
    [(0, 5, {}), (200, 11, {"invalid": 1.0}), (1000, 37, {"unsorted": True}), (1024, 21, {"ties": True}),
     (777, 300, {"ties": True, "unsorted": True}), (500, 11, {"nan": True}), (1 << 16, 1000, {}),
     (3, 4096, {}),
     # the search mode's edges: one block up to N = 8192, a grid past it; T up to 4096
     (8192, 1000, {"ties": True}), (8193, 1000, {"ties": True, "unsorted": True}), (1 << 18, 1000, {}),
     (500_000, 200, {"ties": True}), (1 << 16, 4096, {"ties": True, "unsorted": True}), (1 << 16, 0, {"thresholds": [0.5], "ties": True}),
     (1 << 16, 2, {"ties": True, "unsorted": True}), (1 << 16, 255, {"unsorted": True, "nan": True}),
     # past 4096 thresholds: the compare mode, one block and a grid
     (3000, 4097, {"ties": True}), (2000, 5000, {"ties": True, "unsorted": True}),
     (3000, 20_000, {"ties": True, "unsorted": True}), (50_000, 5000, {"ties": True}),
     # int64 labels read in place
     (1 << 16, 200, {"int64": True, "ties": True}), (5000, 1000, {"int64": True, "unsorted": True}),
     (3000, 20_000, {"int64": True})],
)
def test_binned_curve_counts_kernel_matches_plain(card, n, t, kw):
    arrays = _curve(n, t, seed=n + t, **kw)
    got = kernels.binned_curve_counts(*(a.to(card) for a in arrays))
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got.cpu(), kernels.binned_curve_counts_plain(*arrays))


NAN = float("nan")
INF = float("inf")
# threshold lists a user may pass: NaN at the tail (sorted) and in the middle (unsorted),
# duplicates, one threshold, signed zeros, infinities, values outside [0, 1]
CURVE_EDGES = {
    "nan_thresholds_tail": [0.0, 0.25, 0.5, 0.75, 1.0, NAN, NAN],
    "nan_thresholds_middle": [0.0, 0.25, NAN, 0.75, 1.0, 0.5],
    "all_nan_thresholds": [NAN] * 5,
    "duplicate_thresholds": [0.3, 0.3, 0.3, 0.7, 0.7, 0.1, 0.1, 0.3],
    "sorted_duplicates": [0.1, 0.1, 0.3, 0.3, 0.3, 0.7],
    "one_threshold": [0.5],
    "signed_zeros": [0.0, -0.0, 0.25, -0.0, 0.0],
    "infinite_thresholds": [-INF, 0.0, 0.5, 1.0, INF],
    "outside_unit": [1.5, -2.0, 0.5, 3.0, -0.5, 0.0, 1.0],
}


@pytest.mark.parametrize("n", [1000, 1 << 16])
@pytest.mark.parametrize("labels", ["int32", "int64", "float64_scores"])
@pytest.mark.parametrize("edge", sorted(CURVE_EDGES))
def test_binned_curve_counts_kernel_edge_cases(card, edge, labels, n):
    """Bitwise the plain version on +-inf, NaN and +-0.0 scores, half of them tied to a
    threshold, in one block and on a grid."""
    arrays = _curve(n, 0, seed=n + len(edge), thresholds=CURVE_EDGES[edge], ties=True, specials=True,
                    int64=labels == "int64", scores_dtype=torch.float64 if labels == "float64_scores" else torch.float32)
    _dirty_allocator(card, len(CURVE_EDGES[edge]) * 2)
    got = kernels.binned_curve_counts(*(a.to(card) for a in arrays))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), kernels.binned_curve_counts_plain(*arrays))


def test_binned_curve_counts_calls_of_other_shapes_share_the_scratch(card):
    """Back-to-back calls of other N and T on one stream, each equal to the plain
    version: every grid launch leaves its cached scratch zero for the next."""
    shapes = [(1 << 18, 1000), (700, 10), (1 << 17, 200), (1 << 16, 5000), (1 << 18, 1000), (9000, 4096), (8193, 2)]
    cases = [_curve(n, t, seed=i, ties=True, unsorted=i % 2 == 1, int64=i % 3 == 0) for i, (n, t) in enumerate(shapes)]
    got = [kernels.binned_curve_counts(*(a.to(card) for a in arrays)) for arrays in cases]
    torch.cuda.synchronize()
    for out, arrays in zip(got, cases):
        assert torch.equal(out.cpu(), kernels.binned_curve_counts_plain(*arrays))


def test_binned_curve_counts_on_two_streams_interleaved(card):
    """Each stream has its own scratch: calls queued alternately on two streams, which
    may run at once, each equal to the plain version."""
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    cases = [[a.to(card) for a in _curve(1 << 18, t, seed=t, ties=True)] for t in (1000, 200, 5000, 100)]
    torch.cuda.synchronize()
    outs = []
    for i, arrays in enumerate(cases * 3):
        with torch.cuda.stream(streams[i % 2]):
            outs.append((kernels.binned_curve_counts(*arrays), arrays))
    torch.cuda.synchronize()
    assert len({key for key in kernels._CURVE_SCRATCH if key[1] in {s.cuda_stream for s in streams}}) == 2
    for out, arrays in outs:
        assert torch.equal(out.cpu(), kernels.binned_curve_counts_plain(*(a.cpu() for a in arrays)))


def test_binned_curve_counts_refuses_a_scratch_too_small(card):
    """The C entry point checks the scratch's size that the wrapper computes: a null or a
    short scratch is refused before any launch, the exact size counts."""
    n, t = 1 << 16, 200
    scores, labels, valid, thr = (a.to(card) for a in _curve(n, t, seed=3))
    need = kernels._curve_scratch_bytes(t)
    scratch = torch.zeros(need, dtype=torch.uint8, device=card)
    out = torch.empty((t, 2), dtype=torch.int32, device=card)
    fn = kernels._entry_point("binned_curve_counts")
    stream = kernels._raw_stream(torch.cuda.current_device())

    def call(ptr, nbytes):
        return fn(scores.data_ptr(), labels.data_ptr(), 4, valid.data_ptr(), n, thr.data_ptr(), t, ptr, nbytes,
                  out.data_ptr(), stream)

    assert call(None, 0) != 0 and call(scratch.data_ptr(), need - 4) != 0
    assert call(scratch.data_ptr(), need) == 0
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), kernels.binned_curve_counts_plain(scores.cpu(), labels.cpu(), valid.cpu(), thr.cpu()))


CURVE_VARIANTS = {"sorted": {}, "unsorted_ties": {"unsorted": True, "ties": True}, "int64": {"int64": True}}
CURVE_TRACED = [(500_000, 200, "sorted"), (1 << 18, 1000, "sorted"), (1 << 20, 200, "unsorted_ties"),
                (500_000, 200, "int64"), (5000, 100, "unsorted_ties"), (1 << 16, 5000, "unsorted_ties")]


@pytest.fixture(scope="module")
def binned_curve_counts_traces() -> list:
    return _traced_in_a_new_process("binned_curve_counts", CURVE_TRACED)


@pytest.mark.parametrize("case", range(len(CURVE_TRACED)), ids=[f"{n}-{t}-{v}" for n, t, v in CURVE_TRACED])
def test_one_binned_curve_counts_call_runs_one_device_kernel(card, binned_curve_counts_traces, case):
    """One kernel per call, nothing else: no label cast, no fill, no sort, no memset."""
    ran = binned_curve_counts_traces[case]
    assert sum(ran.values()) == 1 and all("curve_" in name for name in ran), ran


def test_a_cuda_tensor_never_reaches_the_plain_binned_curve_counts(card, monkeypatch):
    def refuse(*args):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(kernels, "binned_curve_counts_plain", refuse)
    for n, t, kw in [(0, 5, {}), (100, 0, {"thresholds": [0.3]}), (1 << 16, 200, {"int64": True}), (1 << 16, 1000, {"unsorted": True}),
                     (3000, 5000, {})]:
        kernels.binned_curve_counts(*(a.to(card) for a in _curve(n, t, seed=5, **kw)))
    metric = tc.BinaryAUROC(thresholds=100)
    metric.update(torch.rand(1000, device=card), torch.randint(0, 2, (1000,), device=card))
    metric.compute()
    torch.cuda.synchronize()


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
    planes = torch.rand(2, 12, 13, device=card)
    window = torch.ones(3, device=card) / 3
    kernels.ssim_moments(planes, planes, window, window)
    kernels.ssim_moments(planes[:0], planes[:0], window, window)  # no planes: nothing to launch
    kernels.ssim_moments(planes.cpu(), planes.cpu(), window.cpu(), window.cpu())  # CPU: not counted
    assert kernels.LAUNCHES == {
        "confusion_matrix": 1, "binned_curve_counts": 1, "weighted_bincount": 2, "bincount": 1, "ssim_moments": 1,
    }
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


def _single_block_max() -> int:
    fn = _build.library("weighted_bincount").tm_weighted_bincount_single_block_max
    fn.restype = ctypes.c_longlong
    return int(fn())


def _weighted_matches_plain(x, w, c) -> None:
    got = kernels.weighted_bincount(x, w, c)
    torch.cuda.synchronize()
    want = kernels.weighted_bincount_plain(x.cpu(), w.cpu(), c)
    torch.testing.assert_close(got.cpu(), want, rtol=WEIGHTED_RTOL, atol=0, equal_nan=True)


@pytest.mark.parametrize("side", [-1, 0, 1, 2])
@pytest.mark.parametrize("k, c", [(3, 15), (3, 1000), (3, 8192), (1, 65536)])  # each scatter mode
def test_weighted_bincount_on_both_sides_of_the_single_block_limit(card, side, k, c):
    n = _single_block_max() + side
    x, w = _weighted(n, k, c, seed=n + k + c, nonfinite=True)
    _weighted_matches_plain(x.to(card), w.to(card), c)
    counts = (w != 0).to(torch.float32)
    got = kernels.weighted_bincount(x.to(card), counts.to(card), c)
    assert torch.equal(got.cpu(), kernels.weighted_bincount_plain(x, counts, c))


@pytest.mark.parametrize("c", [1, 15, 1000, 8192, 65536])
@pytest.mark.parametrize("n", [500, 1 << 18])
def test_weighted_bincount_bin_counts(card, n, c):
    x, w = _weighted(n, 3, c, seed=n + c)
    _weighted_matches_plain(x.to(card), w.to(card), c)


@pytest.mark.parametrize("n", [5000, 1 << 18])
@pytest.mark.parametrize("c", [15, 2000, 65536])
def test_weighted_bincount_nonfinite_on_the_grid_and_in_one_block(card, n, c):
    x, w = _weighted(n, 3, c, seed=n + c + 1, nonfinite=True)
    w[1, 7] = float("-inf")
    _weighted_matches_plain(x.to(card), w.to(card), c)


def test_weighted_bincount_scratch_resets_between_calls(card):
    """Back-to-back calls of other shapes on one stream, each equal to the plain version:
    every call leaves its cached scratch zero for the next."""
    shapes = [(1 << 18, 3, 15), (1 << 18, 1, 8192), (700, 3, 15), (1 << 17, 3, 1000), (1 << 18, 3, 15),
              (1 << 16, 2, 65536), (1 << 18, 3, 8192)]
    cases = [(_weighted(n, k, c, seed=i, nonfinite=i % 2 == 0), c) for i, (n, k, c) in enumerate(shapes)]
    got = [kernels.weighted_bincount(x.to(card), w.to(card), c) for (x, w), c in cases]
    torch.cuda.synchronize()
    for out, ((x, w), c) in zip(got, cases):
        torch.testing.assert_close(out.cpu(), kernels.weighted_bincount_plain(x, w, c), rtol=WEIGHTED_RTOL, atol=0,
                                   equal_nan=True)


def test_weighted_bincount_on_two_streams_interleaved(card):
    """Each stream has its own scratch: calls queued alternately on two streams, which
    may run at once, each equal to the plain version."""
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    cases = []
    for i, c in enumerate([15, 1000, 8192, 15, 1000, 8192]):
        x, w = _weighted(1 << 18, 3, c, seed=c + i)
        cases.append((x.to(card), w.to(card), c))
    torch.cuda.synchronize()
    outs = []
    for i, (x, w, c) in enumerate(cases * 3):
        stream = streams[i % 2]
        with torch.cuda.stream(stream):
            outs.append((kernels.weighted_bincount(x, w, c), x, w, c))
    torch.cuda.synchronize()
    assert len({key for key in kernels._WEIGHTED_SCRATCH if key[1] in {s.cuda_stream for s in streams}}) == 2
    for out, x, w, c in outs:
        torch.testing.assert_close(out.cpu(), kernels.weighted_bincount_plain(x.cpu(), w.cpu(), c),
                                   rtol=WEIGHTED_RTOL, atol=0)


WEIGHTED_TRACED = [500, 1 << 18]


@pytest.fixture(scope="module")
def weighted_bincount_traces() -> list:
    return _traced_in_a_new_process("weighted_bincount", WEIGHTED_TRACED)


@pytest.mark.parametrize("n", WEIGHTED_TRACED)
def test_one_weighted_bincount_call_runs_one_device_kernel(card, weighted_bincount_traces, n):
    ran = weighted_bincount_traces[WEIGHTED_TRACED.index(n)]
    assert sum(ran.values()) == 1 and all("weighted_bincount_kernel" in name for name in ran), ran


def _bincount_ids(n: int, c: int, seed: int, ids: str = "int32", out_of_range: float = 0.05) -> torch.Tensor:
    """CPU indices for the bincount kernel, about ``out_of_range`` of them below 0 or at or
    above C: "int32"; "int64", the same plus multiples of 2^32 (the kernel keeps the low
    32 bits, as JAX does), and the two int64 values next to the int32 range's ends;
    "equal", one index in range for all; "runs", ids sorted in runs of 1000."""
    g = torch.Generator().manual_seed(seed)
    if ids == "equal":
        return torch.full((n,), c // 2, dtype=torch.int32)
    if ids == "runs":
        return (torch.arange(n, dtype=torch.int32) // 1000) % (c + 1) - 1  # -1 counts nowhere
    x = torch.randint(0, c, (n,), generator=g, dtype=torch.int32)
    bad = torch.rand(n, generator=g) < out_of_range
    x = torch.where(bad, torch.where(x % 2 == 0, c + 3, -2), x).to(torch.int32)
    if ids == "int64":
        x = x.long() + (torch.randint(-2, 3, (n,), generator=g) << 32)
        x[:2] = torch.tensor([1 << 31, -(1 << 31) - 1])[:n]  # int32 -2^31 and 2^31 - 1
    return x


def _bincount_matches_plain(x: torch.Tensor, c: int) -> None:
    got = kernels.bincount(x, None, c)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.dtype == torch.int32 and got.shape == (c,)
    assert torch.equal(got.cpu(), kernels.bincount_plain(x.cpu(), c))


# each side of every mode's limit: one block up to N = 8192; per-lane copies up to
# C = 384, one copy per block up to C = 57,856, atomics into the zeroed output above
BINCOUNT_SHAPES = [
    (0, 5), (1, 1), (5, 3), (1000, 1), (1 << 16, 100), (1 << 16, 6980), (1 << 16, 12288), (1 << 16, 12289),
    (1 << 16, 1 << 16), (8192, 384), (8193, 384), (8192, 385), (8193, 385), (1 << 18, 384), (1 << 18, 385),
    (8192, 57856), (8193, 57856), (8192, 57857), (8193, 57857), (1 << 18, 57856), (1 << 18, 57857),
    (3, 1 << 20), (1 << 20, 1 << 20),
]


@pytest.mark.parametrize("ids", ["int32", "int64"])
@pytest.mark.parametrize("n, c", BINCOUNT_SHAPES)
def test_bincount_kernel_matches_plain(card, n, c, ids):
    x = _bincount_ids(n, c, seed=n + c, ids=ids)
    _dirty_allocator(card, c, cells=c)
    _bincount_matches_plain(x.to(card), c)
    valid = torch.rand(n, generator=torch.Generator().manual_seed(n)) > 0.5
    masked = kernels.bincount(x.to(card), valid.to(card), c)
    assert torch.equal(masked.cpu(), kernels.bincount(x, valid, c))


BINCOUNT_VIEWS = {
    "offset_1": lambda x: x[1:], "offset_2": lambda x: x[2:], "offset_3": lambda x: x[3:-1],
    "strided": lambda x: x[::2], "2d": lambda x: x[: x.numel() // 8 * 8].reshape(8, -1),
    "2d_transposed": lambda x: x[: x.numel() // 8 * 8].reshape(8, -1).t(), "int16": lambda x: x.to(torch.int16),
    "bool": lambda x: x > 0,
}


@pytest.mark.parametrize("n, c", [(11, 7), (8200, 100), (1 << 18, 100), (1 << 18, 6980), (1 << 18, 1 << 20)])
@pytest.mark.parametrize("ids", ["int32", "int64"])
@pytest.mark.parametrize("view", sorted(BINCOUNT_VIEWS))
def test_bincount_kernel_takes_views(card, view, ids, n, c):
    """Views at element offsets (not 16-byte aligned, read in place: the head before the
    first 16-byte boundary and the tail one at a time), non-contiguous views (copied) and
    other integer types (cast)."""
    x = BINCOUNT_VIEWS[view](_bincount_ids(n, c, seed=c, ids=ids).to(card))
    _bincount_matches_plain(x, c)


@pytest.mark.parametrize("ids", ["equal", "runs"])
@pytest.mark.parametrize("n, c", [(5000, 2), (1 << 20, 2), (1 << 20, 384), (1 << 20, 6980), (6980 * 1000, 6980),
                                  (1 << 18, 57856), (1 << 20, 1 << 20)])
def test_bincount_kernel_under_contention(card, ids, n, c):
    """Every index equal, or sorted in runs of 1000 (retrieval ids grouped by query): whole
    warps add one index; the counts stay exact."""
    x = _bincount_ids(n, c, seed=0, ids=ids)
    _bincount_matches_plain(x.to(card), c)
    _bincount_matches_plain(x.to(card).long() + (3 << 32), c)


@pytest.mark.parametrize("n, c", [(3, 1 << 20), (1 << 18, 1 << 20), (1 << 18, 57857), (5000, 57856),
                                  (1 << 18, 57856), (1 << 18, 6980), (100, 384)])
def test_bincount_writes_every_bin_of_a_large_output(card, n, c):
    """Every bin of an output that the allocator filled with junk is written: where no
    index counted, the kernel writes 0 (beyond shared memory, the cooperative launch
    zeroes the output before it counts)."""
    x = _bincount_ids(n, c, seed=n + c, ids="int64")[: max(1, n // 2)]
    _dirty_allocator(card, c, cells=c)
    _bincount_matches_plain(x.to(card), c)


def test_bincount_calls_of_other_shapes_share_the_scratch(card):
    """Back-to-back calls of other shapes and modes on one stream, each equal to the
    plain version: every grid launch writes the slots it reads, whatever an earlier call
    left in the cached scratch."""
    shapes = [(1 << 18, 6980), (1 << 18, 100), (700, 10), (1 << 18, 57856), (1 << 17, 1 << 20), (1 << 18, 2),
              (9000, 384), (1 << 18, 385), (8193, 1)]
    cases = [(_bincount_ids(n, c, seed=i, ids=("int32", "int64")[i % 2]), c) for i, (n, c) in enumerate(shapes)]
    got = [kernels.bincount(x.to(card), None, c) for x, c in cases]
    torch.cuda.synchronize()
    for out, (x, c) in zip(got, cases):
        assert torch.equal(out.cpu(), kernels.bincount_plain(x, c))


def test_bincount_refuses_a_scratch_too_small_for_its_grid(card):
    """The C entry point checks the slots' size that the wrapper computes: a null or a
    short scratch is refused before any launch, the exact size counts."""
    n, c = 1 << 16, 6980
    x = _bincount_ids(n, c, seed=3).to(card)
    need = kernels._bincount_slots_bytes(torch.cuda.current_device(), n, c)
    scratch = torch.empty(need, dtype=torch.uint8, device=card)
    out = torch.empty(c, dtype=torch.int32, device=card)
    fn = kernels._entry_point("bincount")
    stream = kernels._raw_stream(torch.cuda.current_device())

    def call(slots, nbytes, x_bytes=4):
        return fn(x.data_ptr(), x_bytes, n, c, slots, nbytes, out.data_ptr(), stream)

    assert need > 0 and call(None, 0) != 0 and call(scratch.data_ptr(), need - 4) != 0
    assert call(scratch.data_ptr(), need, x_bytes=2) != 0  # only int32 and int64 are read
    assert call(scratch.data_ptr(), need) == 0
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), kernels.bincount_plain(x.cpu(), c))


def test_bincount_on_two_streams_interleaved(card):
    """Each stream has its own scratch: calls queued alternately on two streams, which
    may run at once, each equal to the plain version."""
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    cases = [(_bincount_ids(1 << 18, c, seed=c + i, ids=("int32", "int64")[i % 2]).to(card), c)
             for i, c in enumerate([2, 100, 6980, 57856, 1 << 20, 385])]
    torch.cuda.synchronize()
    outs = []
    for i, (x, c) in enumerate(cases * 3):
        with torch.cuda.stream(streams[i % 2]):
            outs.append((kernels.bincount(x, None, c), x, c))
    torch.cuda.synchronize()
    assert len({key for key in kernels._BINCOUNT_SCRATCH if key[1] in {s.cuda_stream for s in streams}}) == 2
    for out, x, c in outs:
        assert torch.equal(out.cpu(), kernels.bincount_plain(x.cpu(), c))


BINCOUNT_TRACED = [(6980 * 1000, 6980, "int32"), (6980 * 1000, 6980, "int64"), (6980 * 1000, 6980, "runs"),
                   (5000, 100, "int64"), (1 << 20, 100, "int32"), (1 << 20, 8192, "int32"),
                   (1 << 20, 1 << 16, "int64"), (1 << 20, 1 << 20, "int32")]


@pytest.fixture(scope="module")
def bincount_traces() -> list:
    return _traced_in_a_new_process("bincount", BINCOUNT_TRACED)


@pytest.mark.parametrize("case", range(len(BINCOUNT_TRACED)), ids=[f"{n}-{c}-{i}" for n, c, i in BINCOUNT_TRACED])
def test_one_bincount_call_runs_one_device_kernel(card, bincount_traces, case):
    """One kernel per call, nothing else: no cast of int64 ids, no fill, no memset."""
    ran = bincount_traces[case]
    assert sum(ran.values()) == 1 and all("bincount_" in name for name in ran), ran


def test_a_cuda_tensor_never_reaches_the_plain_bincount(card, monkeypatch):
    def refuse(*args):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(kernels, "bincount_plain", refuse)
    for n, c, ids in [(0, 3, "int32"), (100, 2, "int64"), (1 << 16, 6980, "int32"), (1 << 16, 1 << 20, "int64"),
                      (5000, 1000, "runs")]:
        kernels.bincount(_bincount_ids(n, c, seed=5, ids=ids).to(card), None, c)
    _flexible_bincount(_bincount_ids(1 << 16, 500, seed=6).to(card))
    torch.cuda.synchronize()


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


# The SSIM moments kernel against its plain version: float32 sums of up to 71 taps per
# pass, in the same order, on inputs in [0, 1]; the card fuses each multiply-add.
MOMENTS_ATOL = 1e-5


def _window(kind: str, size: int, sigma: float) -> torch.Tensor:
    if kind == "uniform":
        return torch.full((size,), 1.0 / size)
    return _gaussian(size, sigma)[0]


@pytest.mark.parametrize(
    "planes, hp, wp, wh, ww",
    [(3, 38, 38, ("uniform", 7, 0), ("uniform", 7, 0)),  # 32 x 32 images, 7 x 7 uniform
     (48, 266, 266, ("gauss", 11, 1.5), ("gauss", 11, 1.5)),  # 16 RGB 256^2 crops
     (3, 200, 210, ("gauss", 11, 1.5), ("gauss", 23, 3.0)),  # sigma = (1.5, 3.0): 11 x 23
     (2, 150, 170, ("gauss", 71, 10.0), ("gauss", 71, 10.0)),  # sigma = 10: 71 x 71
     (2, 90, 260, ("gauss", 5, 1.0), ("gauss", 151, 21.5)),  # a columns window past one chunk
     (5, 77, 101, ("gauss", 11, 1.5), ("gauss", 11, 1.5)),  # no multiple of the tile
     (1, 11, 11, ("gauss", 11, 1.5), ("gauss", 11, 1.5)),  # one output
     (2, 40, 45, ("gauss", 1, 1.0), ("uniform", 3, 0))],
)
def test_ssim_moments_kernel_matches_plain(card, planes, hp, wp, wh, ww):
    g = torch.Generator().manual_seed(planes + hp + wp)
    p, t = torch.rand(planes, hp, wp, generator=g), torch.rand(planes, hp, wp, generator=g)
    wh, ww = _window(*wh), _window(*ww)
    got = kernels.ssim_moments(p.to(card), t.to(card), wh.to(card), ww.to(card))
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), kernels.ssim_moments_plain(p, t, wh, ww), atol=MOMENTS_ATOL, rtol=0)


def _planes(planes: int, hp: int, wp: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(planes, hp, wp, generator=g), torch.rand(planes, hp, wp, generator=g)


@pytest.mark.parametrize("wp", [2052, 2050, 2049])  # rows 16-, 8- and 4-byte aligned
def test_ssim_moments_kernel_takes_any_row_alignment(card, wp):
    p, t = _planes(2, 40, wp, seed=wp)
    w = _gaussian(11, 1.5)[0]
    got = kernels.ssim_moments(p.to(card), t.to(card), w.to(card), w.to(card))
    torch.testing.assert_close(got.cpu(), kernels.ssim_moments_plain(p, t, w, w), atol=MOMENTS_ATOL, rtol=0)


@pytest.mark.parametrize(
    "planes, hp, wp",
    [(1, 69, 253),  # ragged tiles in both directions (53 x 243 outputs), fewer tiles than SMs
     (3, 26, 126),  # exactly one 16 x 116 tile per plane
     (12, 349, 520),  # an MS-SSIM scale: many tiles, more than the card holds at once
     (3, 200, 700),  # 71 tiles per plane
     (5, 77, 101)],  # odd widths: 4-byte copies
)
def test_ssim_moments_kernel_tiles(card, planes, hp, wp):
    p, t = _planes(planes, hp, wp, seed=hp + wp)
    p[-1, hp - 1, wp - 1] = float("nan")  # the last pixel: only the last output reads it
    w = _gaussian(11, 1.5)[0]
    got = kernels.ssim_moments(p.to(card), t.to(card), w.to(card), w.to(card)).cpu()
    want = kernels.ssim_moments_plain(p, t, w, w)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    torch.testing.assert_close(got, want, atol=MOMENTS_ATOL, rtol=0, equal_nan=True)


@pytest.mark.parametrize("wh, ww", [(("gauss", 71, 10.0), ("gauss", 71, 10.0)),  # 192-float pitch
                                    (("gauss", 5, 1.0), ("gauss", 151, 21.5)),  # 256-float pitch
                                    (("gauss", 3, 1.0), ("uniform", 231, 0)),  # two columns chunks
                                    (("gauss", 11, 1.5), ("gauss", 23, 3.0)),  # 104 columns a tile
                                    (("gauss", 33, 5.0), ("uniform", 7, 0))])  # three rows bands
def test_ssim_moments_kernel_large_windows_with_nan(card, wh, ww):
    p, t = _planes(2, 230, 420, seed=7)
    t[1, 120, 300] = float("nan")
    wh, ww = _window(*wh), _window(*ww)
    got = kernels.ssim_moments(p.to(card), t.to(card), wh.to(card), ww.to(card)).cpu()
    want = kernels.ssim_moments_plain(p, t, wh, ww)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    torch.testing.assert_close(got, want, atol=MOMENTS_ATOL, rtol=0, equal_nan=True)


def test_ssim_moments_kernel_spreads_a_nan_as_the_plain_version(card):
    g = torch.Generator().manual_seed(5)
    p, t = torch.rand(3, 60, 70, generator=g), torch.rand(3, 60, 70, generator=g)
    p[1, 33, 40] = float("nan")
    w = _gaussian(11, 1.5)[0]
    got = kernels.ssim_moments(p.to(card), t.to(card), w.to(card), w.to(card)).cpu()
    want = kernels.ssim_moments_plain(p, t, w, w)
    assert torch.equal(torch.isnan(got), torch.isnan(want)) and int(torch.isnan(want).sum()) == 3 * 11 * 11
    torch.testing.assert_close(got, want, atol=MOMENTS_ATOL, rtol=0, equal_nan=True)


def test_a_cuda_tensor_never_reaches_the_plain_moments(card, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the plain SSIM moments ran on the card's path")

    monkeypatch.setattr(kernels, "ssim_moments_plain", refuse)
    g = torch.Generator().manual_seed(6)
    p = torch.rand(2, 3, 200, 200, generator=g).to(card)
    t = (p * 0.8 + 0.1).requires_grad_()
    kernels.reset_launch_counts()
    structural_similarity_index_measure(p, t, data_range=1.0).backward()
    multiscale_structural_similarity_index_measure(p, t.detach(), data_range=1.0)
    assert kernels.LAUNCHES["ssim_moments"] == 1 + 5 and t.grad is not None


IMAGE_METRICS = {
    "ssim": lambda **k: ti.StructuralSimilarityIndexMeasure(data_range=1.0, **k),
    "ssim_none_uniform": lambda **k: ti.StructuralSimilarityIndexMeasure(reduction="none", gaussian_kernel=False, **k),
    "ms_ssim": lambda **k: ti.MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, betas=(0.3, 0.4, 0.3), **k),
    "psnr": lambda **k: ti.PeakSignalNoiseRatio(data_range=1.0, **k),
    "uqi": lambda **k: ti.UniversalImageQualityIndex(**k),
    "rmse_sw": lambda **k: ti.RootMeanSquaredErrorUsingSlidingWindow(**k),
}


@pytest.mark.parametrize("name", sorted(IMAGE_METRICS))
def test_image_metric_on_the_card_equals_the_cpu(card, name):
    g = torch.Generator().manual_seed(8)
    batches = []
    for _ in range(2):
        target = torch.rand(2, 3, 96, 96, generator=g)
        preds = (target + 0.05 * torch.randn(2, 3, 96, 96, generator=g)).clamp(0, 1)
        batches.append((preds, target))
    on_card, on_cpu = IMAGE_METRICS[name](), IMAGE_METRICS[name](device="cpu")
    for preds, target in batches:
        _compare(on_card(preds.to(card), target.to(card)), on_cpu(preds, target))
    _compare(on_card.compute(), on_cpu.compute())


def _imagenet_set(device) -> dict:
    """``chip_smoke.py``'s ImageNet metric set (1000 classes)."""
    c, kw = 1000, {"validate_args": False, "device": device}
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


def _binary_set(device) -> dict:
    """``chip_smoke.py``'s CTR metric set."""
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


def _imagenet_batches(steps: int, n: int = 500):
    g = torch.Generator().manual_seed(21)
    out = []
    for _ in range(steps):
        target = torch.randint(0, 1000, (n,), generator=g)
        logits = torch.randn(n, 1000, generator=g)
        logits[torch.arange(n), target] += 3.0
        out.append((torch.softmax(logits, dim=1), target))
    return out


def _binary_batches(steps: int, n: int = 1 << 14):
    g = torch.Generator().manual_seed(22)
    out = []
    for _ in range(steps):
        target = torch.randint(0, 2, (n,), generator=g)
        scores = torch.sigmoid(torch.randn(n, generator=g) + 1.2 * target - 0.6)
        out.append((scores, torch.where(torch.rand(n, generator=g) < 0.01, -1, target)))
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    t = t.cpu().contiguous()
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def _assert_bitwise(a, b, where: str) -> None:
    if isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            _assert_bitwise(x, y, f"{where}[{i}]")
        return
    assert a.dtype == b.dtype and a.shape == b.shape, where
    assert torch.equal(_bits(a), _bits(b)), where


@pytest.mark.parametrize("kind", ["imagenet", "binary"])
def test_a_collection_on_the_card_equals_the_per_metric_loop(card, kind):
    """Integer states and every grouped member's value bitwise; the leader updates alone."""
    make, batches = (_imagenet_set, _imagenet_batches(3)) if kind == "imagenet" else (_binary_set, _binary_batches(3))
    col, singles = MetricCollection(make(card)), make(card)
    assert any(len(members) > 1 for members in col.compute_groups.values())
    for probs, target in batches:
        probs, target = probs.to(card), target.to(card)
        col.update(probs, target)
        for m in singles.values():
            m.update(probs, target)
    values = col.compute()
    for name, m in singles.items():
        for key, want in m.state_dict(persistent_only=False).items():
            got = col[name].state_dict(persistent_only=False)[key]
            assert got.device.type == "cuda"
            if not want.is_floating_point():
                assert torch.equal(got.cpu(), want.cpu()), f"{name}.{key}"
    for members in col.compute_groups.values():
        if len(members) > 1:
            for name in members:
                _assert_bitwise(values[name], singles[name].compute(), name)


def test_a_grouped_imagenet_step_launches_the_confusion_matrix_twice(card):
    """Eight metrics launch K1 each step one by one; grouped, the stat-scores and the
    confusion-matrix leaders launch it once each. Counted by the wrappers, and by a
    torch.profiler trace of one step in a new process."""
    probs, target = (a.to(card) for a in _imagenet_batches(1)[0])
    launches = {}
    for side, metrics in (("per_metric", _imagenet_set(card)), ("grouped", MetricCollection(_imagenet_set(card)))):
        kernels.reset_launch_counts()
        for m in ([metrics] if side == "grouped" else metrics.values()):
            m.update(probs, target)
        launches[side] = dict(kernels.LAUNCHES)
    assert launches["per_metric"]["confusion_matrix"] == 8 and launches["grouped"]["confusion_matrix"] == 2
    assert launches["grouped"]["binned_curve_counts"] == launches["per_metric"]["binned_curve_counts"] == 1
    assert launches["grouped"]["weighted_bincount"] == launches["per_metric"]["weighted_bincount"] == 1
    (ran,) = _traced_in_a_new_process("grouped_imagenet_step", [500])
    assert sum(n for name, n in ran.items() if "confusion_matrix" in name) == 2, ran


# ------------------------------------------------------------- CUDA graph capture

# Each kernel's wrapper captured in a torch.cuda.CUDAGraph and replayed on fresh inputs
# copied into the captured ones: the cooperative launches of K1 and K4 (grid barrier),
# K2's and K3's last-block tickets (their scratch must be left zero for the next
# replay), K5's opted-in shared memory. The wrapper runs once on the capture stream
# before the capture, so that its scratch and its function attributes exist by then.
GRAPH_CASES = {
    "confusion_matrix_one_block": ("confusion_matrix", (4096, 10)),
    "confusion_matrix_slots": ("confusion_matrix", (1 << 18, 10)),  # cooperative, slots merged after grid.sync()
    "confusion_matrix_zeroed": ("confusion_matrix", (1 << 18, 1000)),  # cooperative, output zeroed in the launch
    "binned_curve_counts": ("binned_curve_counts", (1 << 18, 1000)),  # last-block ticket
    "binned_curve_counts_one_block": ("binned_curve_counts", (3000, 200)),
    "weighted_bincount": ("weighted_bincount", (1 << 18, 15)),  # last-block ticket
    "weighted_bincount_one_block": ("weighted_bincount", (500, 15)),
    "bincount_slots": ("bincount", (1 << 18, 6980)),  # cooperative, slots merged after grid.sync()
    "bincount_atomics": ("bincount", (1 << 18, 1 << 16)),  # cooperative, output zeroed, global atomics
    "ssim_moments": ("ssim_moments", (12, 266, 266)),
}


def _graph_inputs(kernel: str, shape: tuple, seed: int) -> tuple:
    """CPU inputs of one call of ``kernel`` at ``shape``."""
    if kernel == "confusion_matrix":
        return _labels(shape[0], shape[1], seed=seed)
    if kernel == "binned_curve_counts":
        return _curve(shape[0], shape[1], seed=seed)
    if kernel == "weighted_bincount":
        return _weighted(shape[0], 3, shape[1], seed=seed)
    if kernel == "bincount":
        return (_bincount_ids(shape[0], shape[1], seed=seed),)
    p, t = _planes(*shape, seed=seed)
    w = _window("gauss", 11, 1.5)
    return p, t, w, w


def _graph_call(kernel: str, shape: tuple):
    """(the wrapper's call on the inputs, its plain version)."""
    if kernel == "confusion_matrix":
        c = shape[1]
        return (lambda p, t, v: kernels.confusion_matrix(p, t, v, c),
                lambda p, t, v: kernels.confusion_matrix_plain(p, t, v, c))
    if kernel == "binned_curve_counts":
        return kernels.binned_curve_counts, kernels.binned_curve_counts_plain
    if kernel == "weighted_bincount":
        c = shape[1]
        return (lambda x, w: kernels.weighted_bincount(x, w, c), lambda x, w: kernels.weighted_bincount_plain(x, w, c))
    if kernel == "bincount":
        c = shape[1]
        return lambda x: kernels.bincount(x, None, c), lambda x: kernels.bincount_plain(x, c)
    return kernels.ssim_moments, kernels.ssim_moments_plain


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_kernel_captured_in_a_graph_replays_as_its_plain_version(card, case):
    kernel, shape = GRAPH_CASES[case]
    call, plain = _graph_call(kernel, shape)
    static = [a.to(card) for a in _graph_inputs(kernel, shape, seed=0)]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call(*static)  # the scratch and the function attributes exist before the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    before = dict(kernels.LAUNCHES)
    with torch.cuda.graph(graph, stream=stream):
        out = call(*static)
    assert kernels.LAUNCHES[kernel] == before[kernel] + 1  # the wrapper counted the captured launch
    for seed in (1, 2, 3):
        fresh = _graph_inputs(kernel, shape, seed=seed)
        for dst, src in zip(static, fresh):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        want = plain(*fresh)
        if kernel == "ssim_moments":
            torch.testing.assert_close(out.cpu(), want, atol=MOMENTS_ATOL, rtol=0)
        elif kernel == "weighted_bincount":
            torch.testing.assert_close(out.cpu(), want, rtol=WEIGHTED_RTOL, atol=0, equal_nan=True)
        else:
            assert torch.equal(out.cpu(), want), f"{case}: replay {seed}"


def test_launches_are_counted_through_replays(card):
    """A captured variant adds the launches its capture recorded at every replay."""
    from torchmetrics_tpu_torch.core.jit import StaticLeafJit

    def fn(state, preds, target, valid):
        return state + kernels.confusion_matrix(preds, target, valid, 10)

    cached = StaticLeafJit(fn)
    state = torch.zeros((10, 10), dtype=torch.int32, device=card)
    kernels.reset_launch_counts()
    for seed in range(4):
        p, t, v = (a.to(card) for a in _labels(1 << 16, 10, seed=seed))
        state = cached(state, p, t, v)
    torch.cuda.synchronize()
    info = cached.cache_info()
    assert (info["misses"], info["hits"], info["replays"]) == (1, 3, 4)
    # the warm run before the capture launched the kernel once, each replay once
    assert kernels.LAUNCHES["confusion_matrix"] == 1 + 4


def _scratch_step(state, preds, target, valid, scores, labels, thresholds, ids, weights, classes, bins):
    """K1 (cooperative slots past N = 8192), K2 and K3 (last-block tickets): the three
    wrappers whose scratch the capture stream keeps."""
    return (kernels.confusion_matrix(preds, target, valid, classes),
            kernels.binned_curve_counts(scores, labels, valid, thresholds),
            kernels.weighted_bincount(ids, weights, bins))


def _scratch_inputs(n: int, classes: int, thresholds: int, bins: int, seed: int) -> tuple:
    preds, target, valid = _labels(n, classes, seed=seed)
    scores, labels, _, thr = _curve(n, thresholds, seed=seed)
    ids, weights = _weighted(n, 3, bins, seed=seed)
    return preds, target, valid, scores, labels, thr, ids, weights


def _scratch_plain(inputs: tuple, classes: int, bins: int) -> tuple:
    preds, target, valid, scores, labels, thr, ids, weights = inputs
    return (kernels.confusion_matrix_plain(preds, target, valid, classes),
            kernels.binned_curve_counts_plain(scores, labels, valid, thr),
            kernels.weighted_bincount_plain(ids, weights, bins))


def _assert_scratch_step(got: tuple, inputs: tuple, classes: int, bins: int, where: str) -> None:
    want = _scratch_plain(inputs, classes, bins)
    assert torch.equal(got[0].cpu(), want[0]), f"{where}: confusion matrix"
    assert torch.equal(got[1].cpu(), want[1]), f"{where}: binned curve"
    torch.testing.assert_close(got[2].cpu(), want[2], rtol=WEIGHTED_RTOL, atol=0)


def test_graphs_replayed_from_two_streams_at_once_equal_their_plain_versions(card):
    """Two capture caches whose graphs share the capture stream's scratch, called in turn
    from two streams with no synchronise between the calls: every replay is ordered on
    the capture stream, so none races another on K1's slots or K2's and K3's tickets."""
    from torchmetrics_tpu_torch.core.jit import StaticLeafJit

    shapes = {"a": (1 << 18, 10, 1000, 15), "b": (1 << 17, 10, 200, 15)}
    caches = {name: StaticLeafJit(_scratch_step) for name in shapes}
    streams = {name: torch.cuda.Stream() for name in shapes}
    results = []
    for step in range(6):
        for name, (n, classes, thresholds, bins) in shapes.items():
            inputs = _scratch_inputs(n, classes, thresholds, bins, seed=10 * step + len(name) + ord(name))
            with torch.cuda.stream(streams[name]):
                out = caches[name]((), *(a.to(card) for a in inputs), classes=classes, bins=bins)
            results.append((f"{name} step {step}", out, inputs, classes, bins))
    torch.cuda.synchronize()
    for where, out, inputs, classes, bins in results:
        _assert_scratch_step(out, inputs, classes, bins, where)
    assert all(c.cache_info()["replays"] == 6 for c in caches.values())


def test_a_graph_replays_right_after_its_scratch_grew_and_was_freed(card):
    """A graph keeps the address of the scratch its capture used. A later capture that
    needs more scratch on the same stream replaces it, and the allocator is then
    emptied and filled with junk: the first graph still replays as its plain version
    and writes none of the junk (the replaced scratch is kept, not freed)."""
    from torchmetrics_tpu_torch.core.jit import StaticLeafJit, capture_stream

    cache = StaticLeafJit(_scratch_step)
    small, large = (16384, 10, 200, 15), (1 << 18, 100, 4000, 1000)
    n, classes, thresholds, bins = small
    first = _scratch_inputs(n, classes, thresholds, bins, seed=0)
    _assert_scratch_step(cache((), *(a.to(card) for a in first), classes=classes, bins=bins), first, classes, bins,
                         "capture")
    stream = capture_stream(card)
    sizes = {name: store[(card.index or 0, stream.cuda_stream)].numel()
             for name, store in (("K1", kernels._CONFUSION_SCRATCH), ("K2", kernels._CURVE_SCRATCH),
                                 ("K3", kernels._WEIGHTED_SCRATCH))}
    n, classes, thresholds, bins = large
    grown = _scratch_inputs(n, classes, thresholds, bins, seed=1)
    _assert_scratch_step(cache((), *(a.to(card) for a in grown), classes=classes, bins=bins), grown, classes, bins,
                         "larger capture")
    for name, store in (("K1", kernels._CONFUSION_SCRATCH), ("K2", kernels._CURVE_SCRATCH),
                        ("K3", kernels._WEIGHTED_SCRATCH)):
        assert store[(card.index or 0, stream.cuda_stream)].numel() > sizes[name], f"{name}'s scratch did not grow"
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    junk = []
    for on in (torch.cuda.current_stream(card), stream):
        with torch.cuda.stream(on):
            junk += [torch.full((cells,), 0x5A5A5A5A, dtype=torch.int32, device=card)
                     for cells in (1024, 1600, 4096, 13200, 1 << 16) for _ in range(8)]
    n, classes, thresholds, bins = small
    for seed in (2, 3, 4):
        inputs = _scratch_inputs(n, classes, thresholds, bins, seed=seed)
        _assert_scratch_step(cache((), *(a.to(card) for a in inputs), classes=classes, bins=bins), inputs, classes,
                             bins, f"replay {seed}")
    torch.cuda.synchronize()
    assert all(bool((j == 0x5A5A5A5A).all()) for j in junk), "a replay wrote into memory the allocator gave away"
    assert cache.cache_info()["replays"] == 5


def test_a_collection_inside_a_capture_frees_no_graph(card):
    """A dropped pipeline's graphs are freed by the garbage collector (its fused function
    refers to it). A collection inside another capture would destroy them there, a call
    the capture forbids and fails on; the cache holds the collector off while it
    captures. Here a graph in a reference cycle is garbage when a capture starts, and
    the captured function asks for a collection at the next allocation."""
    import gc

    from torchmetrics_tpu_torch.core.jit import StaticLeafJit

    def counts(state, preds, target, valid):
        if torch.cuda.is_current_stream_capturing():
            gc.set_threshold(1)
        return state + kernels.confusion_matrix(preds, target, valid, 10)

    class Cycle:
        pass

    p, t, v = (a.to(card) for a in _labels(4096, 10, seed=0))
    want = kernels.confusion_matrix_plain(*_labels(4096, 10, seed=0), 10)
    kernels.confusion_matrix(p, t, v, 10)  # loaded and warm before the first capture
    state = torch.zeros((10, 10), dtype=torch.int32, device=card)
    thresholds = gc.get_threshold()
    try:
        for _ in range(3):
            gc.collect()
            garbage = Cycle()
            garbage.cycle, garbage.graph = garbage, torch.cuda.CUDAGraph()
            with torch.cuda.graph(garbage.graph):
                garbage.out = kernels.confusion_matrix(p, t, v, 10)
            del garbage
            state = StaticLeafJit(counts)(state, p, t, v)  # a new cache: a capture
            gc.set_threshold(*thresholds)
    finally:
        gc.set_threshold(*thresholds)
    gc.collect()
    torch.cuda.synchronize()
    assert torch.equal(state.cpu(), 3 * want)


def _pipeline_batches(kind: str, steps: int):
    return _imagenet_batches(steps, n=64) if kind == "imagenet" else _binary_batches(steps, n=1 << 12)


@pytest.mark.parametrize("fuse", [1, 4])
@pytest.mark.parametrize("kind", ["imagenet", "binary"])
def test_pipeline_on_the_card_equals_the_collection_loop(card, kind, fuse):
    """chip_smoke.py's sets through MetricPipeline on the card: every batch one replay of
    a captured graph (fuse=1) or one per chunk of up to four, padded tail included;
    integer states and every value bitwise the eager collection loop's."""
    from torchmetrics_tpu_torch.engine import MetricPipeline, PipelineConfig

    make = _imagenet_set if kind == "imagenet" else _binary_set
    batches = [(p.to(card), t.to(card)) for p, t in _pipeline_batches(kind, 7)]
    eager, driven = MetricCollection(make(card)), MetricCollection(make(card))
    for p, t in batches:
        eager.update(p, t)
    pipe = MetricPipeline(driven, PipelineConfig(fuse=fuse))
    report = pipe.run(batches)
    replays = sum(info["replays"] for info in pipe.cache_info())
    assert replays == (7 if fuse == 1 else 2) and report.chunks_replayed == 0
    for name in eager.keys(keep_base=True):
        for key, want in eager[name].state_dict(persistent_only=False).items():
            _assert_bitwise(driven[name].state_dict(persistent_only=False)[key], want, f"{name}.{key}")
    got, want = driven.compute(), eager.compute()
    for name in want:
        _assert_bitwise(got[name], want[name], name)


def test_a_state_held_across_a_replay_is_not_overwritten(card):
    from torchmetrics_tpu_torch.engine import MetricPipeline, PipelineConfig

    metric = tc.MulticlassAccuracy(1000, average="macro", validate_args=False)
    pipe = MetricPipeline(metric, PipelineConfig(fuse=2))
    batches = [(p.to(card), t.to(card)) for p, t in _imagenet_batches(4, n=64)]
    for p, t in batches[:2]:
        pipe.feed(p, t)
    held, snapshot = metric.tp, metric.tp.clone()
    for p, t in batches[2:]:
        pipe.feed(p, t)
    torch.cuda.synchronize()
    assert torch.equal(held, snapshot)
    assert not torch.equal(metric.tp, held)  # the second chunk moved the state
    eager = tc.MulticlassAccuracy(1000, average="macro", validate_args=False)
    for p, t in batches:
        eager.update(p, t)
    assert torch.equal(metric.tp, eager.tp) and torch.equal(metric.fn, eager.fn)


def test_buffered_auroc_through_a_fused_pipeline_equals_its_eager_loop(card):
    """A MaskedBuffer state through fused chunks: its write offset rides into the graph
    as a device count; an overflow raises before the replay and leaves the state."""
    from torchmetrics_tpu_torch.engine import MetricPipeline, PipelineConfig

    batches = [(p.to(card), t.to(card)) for p, t in _binary_batches(6, n=1000)]
    eager = tc.BinaryAUROC(buffer_capacity=6000, ignore_index=-1)
    driven = tc.BinaryAUROC(buffer_capacity=6000, ignore_index=-1)
    for p, t in batches:
        eager.update(p, t)
    pipe = MetricPipeline(driven, PipelineConfig(fuse=4))
    pipe.run(batches)  # a chunk of 4 and a padded chunk of 2
    assert driven.preds.count == eager.preds.count == 6000
    for key in ("preds", "target", "valid"):
        assert torch.equal(getattr(driven, key).data, getattr(eager, key).data), key
    assert torch.equal(driven.compute(), eager.compute())

    small = tc.BinaryAUROC(buffer_capacity=5000, ignore_index=-1)
    pipe = MetricPipeline(small, PipelineConfig(fuse=2))
    pipe.run(batches[:4])  # 4000 of 5000
    replays = sum(info["replays"] for info in pipe.cache_info())
    before = small.preds.data.clone()
    with pytest.raises(ValueError, match="overflowed"):
        pipe.run(batches[4:])  # 2000 more: refused before the replay
    assert sum(info["replays"] for info in pipe.cache_info()) == replays
    assert small.preds.count == 4000 and torch.equal(small.preds.data, before)


def test_a_jit_update_metric_replays_its_capture_and_equals_eager(card):
    batches = [(p.to(card), t.to(card)) for p, t in _imagenet_batches(3, n=64)]
    eager = tc.MulticlassConfusionMatrix(1000, validate_args=False)
    jitted = tc.MulticlassConfusionMatrix(1000, validate_args=True, jit_update=True)
    for p, t in batches:
        eager.update(p, t)
        jitted.update(p, t)  # value checks run in the warm call, not in the capture
    info = jitted._jitted_update.cache_info()
    assert (info["misses"], info["hits"], info["replays"]) == (1, 2, 3)
    assert torch.equal(jitted.confmat, eager.confmat)


# ------------------------------------------------------------------ sessions


def _session_states(col) -> dict:
    return {name: col[name].state_dict(persistent_only=False) for name in col.keys(keep_base=True)}


def _assert_states_bitwise(got: dict, want: dict, where: str) -> None:
    for name, states in want.items():
        for key, value in states.items():
            _assert_bitwise(got[name][key], value, f"{where}.{name}.{key}")


@pytest.mark.parametrize("kind", ["imagenet", "binary"])
def test_a_drain_right_after_a_fused_flush_equals_the_eager_loop(card, kind, tmp_path):
    """The eighth batch dispatches a full chunk (a replay on the capture stream); a drain
    right after it must wait on every ticket before the bundle copies the state back, so
    the bundle and the live state are the eager loop's, bit for bit."""
    import numpy as np

    from torchmetrics_tpu_torch.engine import MetricPipeline, PipelineConfig
    from torchmetrics_tpu_torch.engine.migrate import checkpoint_session
    from torchmetrics_tpu_torch.utils.checkpoint import _decode_tree, _host_states

    make = _imagenet_set if kind == "imagenet" else _binary_set
    batches = [(p.to(card), t.to(card)) for p, t in _pipeline_batches(kind, 8)]
    eager, driven = MetricCollection(make(card)), MetricCollection(make(card))
    for p, t in batches:
        eager.update(p, t)
    pipe = MetricPipeline(driven, PipelineConfig(fuse=8))
    for p, t in batches:
        pipe.feed(p, t)  # the last feed flushes the chunk into a replay
    assert pipe.drain() == []
    manifest = checkpoint_session(pipe, str(tmp_path / "bundle"))
    assert manifest["cursor"]["batches_ingested"] == 8 and pipe.report().dispatches == 1
    _assert_states_bitwise(_session_states(driven), _session_states(eager), "live")
    with np.load(tmp_path / "bundle" / "state.npz") as payload:
        arrays = {key: payload[key] for key in payload.files}
    tree = _decode_tree(manifest["state_skeleton"], arrays)
    for name in eager.keys(keep_base=True):
        want = _host_states(eager[name])["states"]
        for key, value in want.items():
            got = tree[name]["states"][key]
            assert got.dtype == value.dtype and got.shape == value.shape, f"{name}.{key}"
            assert np.array_equal(np.atleast_1d(got).view(np.uint8), np.atleast_1d(value).view(np.uint8)), f"{name}.{key}"


@pytest.mark.parametrize("kind", ["imagenet", "binary"])
def test_a_restored_session_replays_k1_k2_k3_and_equals_its_plain_versions(card, kind, tmp_path):
    """A session checkpointed after 4 batches with 2 behind its cursor, restored onto
    fresh metrics on the card: its replays launch K1, K2 and K3 (counted through the
    replays), and its states and values equal the same stream on the CPU, where every
    kernel runs its plain version (integers exactly, floats within 1e-5)."""
    from torchmetrics_tpu_torch.engine import MetricPipeline, PipelineConfig
    from torchmetrics_tpu_torch.engine.migrate import checkpoint_session, restore_session

    make = _imagenet_set if kind == "imagenet" else _binary_set
    cpu_batches = _pipeline_batches(kind, 12)
    batches = [(p.to(card), t.to(card)) for p, t in cpu_batches]
    origin = MetricPipeline(MetricCollection(make(card)), PipelineConfig(fuse=4, tenant=f"card-{kind}"))
    for p, t in batches[:4]:
        origin.feed(p, t)
    checkpoint_session(origin, str(tmp_path / "bundle"), tail=batches[4:6])
    origin.close()
    restored = MetricCollection(make(card))
    pipe, _ = restore_session(restored, str(tmp_path / "bundle"))  # the tail waits in the open chunk
    pipe.warmup(*batches[6])  # a new capture around the restored state
    kernels.reset_launch_counts()
    pipe.run(batches[6:])
    launches = dict(kernels.LAUNCHES)
    per_step = {"imagenet": (2, 1, 1), "binary": (1, 1, 1)}[kind]
    assert [launches[k] for k in ("confusion_matrix", "binned_curve_counts", "weighted_bincount")] == \
        [8 * n for n in per_step]  # 8 steps: a chunk of 4 (2 tail + 2) and one of 4
    assert sum(info["replays"] for info in pipe.cache_info()) == 2
    plain = MetricCollection(make("cpu"))
    for p, t in cpu_batches:
        plain.update(p, t)
    got, want = _session_states(restored), _session_states(plain)
    for name, states in want.items():
        for key, value in states.items():
            mine = got[name][key].cpu()
            if value.is_floating_point():
                assert torch.allclose(mine, value, atol=1e-5, rtol=1e-6 if key == "bins" else 0.0), f"{name}.{key}"
            else:
                assert torch.equal(mine, value), f"{name}.{key}"
    values, plain_values = restored.compute(), plain.compute()
    for name, value in plain_values.items():
        for a, b in zip(value if isinstance(value, tuple) else (value,),
                        values[name] if isinstance(values[name], tuple) else (values[name],)):
            assert torch.allclose(b.cpu().double(), a.double(), atol=1e-5, rtol=0, equal_nan=True), name


def test_a_periodic_bundle_written_between_replays_is_chunk_consistent(card, tmp_path):
    """Bundles every 4 batches at commit boundaries, chunks of 4, replays in flight: each
    bundle holds exactly the fold of the batches its cursor names, bit for bit."""
    from torchmetrics_tpu_torch.engine import MetricPipeline, PipelineConfig
    from torchmetrics_tpu_torch.engine.migrate import CheckpointPolicy, restore_session

    batches = [(p.to(card), t.to(card)) for p, t in _pipeline_batches("imagenet", 10)]
    policy = CheckpointPolicy(directory=str(tmp_path / "stream"), every_batches=4, full_every=2, keep=8)
    pipe = MetricPipeline(MetricCollection(_imagenet_set(card)), PipelineConfig(fuse=4, checkpoint=policy))
    for p, t in batches:
        pipe.feed(p, t)  # commits at 4 and 8 write bundle-000000 and the delta bundle-000001
    names = sorted(os.listdir(tmp_path / "stream"))
    assert names == ["bundle-000000", "bundle-000001"]
    for name, cursor in zip(names, (4, 8)):
        restored = MetricCollection(_imagenet_set(card))
        _, manifest = restore_session(restored, str(tmp_path / "stream" / name), replay=False)
        assert manifest["cursor"]["batches_ingested"] == cursor
        eager = MetricCollection(_imagenet_set(card))
        for p, t in batches[:cursor]:
            eager.update(p, t)
        _assert_states_bitwise(_session_states(restored), _session_states(eager), name)
    pipe.close()


# ------------------------------------------------------------- the tenant multiplexer


def test_a_four_wide_group_replays_k1_k2_k3_four_times_as_their_plain_versions(card):
    """A multiplexer group of four rows is one graph holding each row's K1, K2 and K3
    launches back to back: K2's and K3's tickets must leave their scratch at zero
    between the rows of one replay, and every row must equal its plain versions."""
    from torchmetrics_tpu_torch.core.jit import StaticLeafJit

    classes, thresholds, bins, n = 10, 50, 15, 1 << 14

    def group(state, rows):
        return tuple(_scratch_step(state, *row, classes, bins) for row in rows)

    cached = StaticLeafJit(group)
    state = torch.zeros((), device=card)
    kernels.reset_launch_counts()
    for replay in range(3):
        inputs = [_scratch_inputs(n, classes, thresholds, bins, seed=10 * replay + row) for row in range(4)]
        got = cached(state, tuple(tuple(a.to(card) for a in row) for row in inputs))
        torch.cuda.synchronize()
        for row, (out, raw) in enumerate(zip(got, inputs)):
            _assert_scratch_step(out, raw, classes, bins, f"replay {replay}, row {row}")
    info = cached.cache_info()
    assert (info["misses"], info["replays"]) == (1, 3)
    # the warm run before the capture and every replay: four rows, one launch each
    assert {k: kernels.LAUNCHES[k] for k in ("confusion_matrix", "binned_curve_counts", "weighted_bincount")} == \
        dict.fromkeys(("confusion_matrix", "binned_curve_counts", "weighted_bincount"), 4 * (1 + 3))


@pytest.mark.parametrize("kind", ["imagenet", "binary"])
def test_the_mux_on_the_card_is_bitwise_the_per_tenant_eager_loop(card, kind):
    """Six tenants of chip_smoke.py's grouped collection through a multiplexer of width
    4 (full groups and padded ones) on the card: every tenant's states and values
    bitwise its own eager loop's, no group degraded, one replay per group."""
    from torchmetrics_tpu_torch.engine import MuxConfig, TenantMultiplexer

    make = _imagenet_set if kind == "imagenet" else _binary_set
    raw = _imagenet_batches(18, n=64) if kind == "imagenet" else _binary_batches(18, n=1 << 12)
    batches = [(p.to(card), t.to(card)) for p, t in raw]
    tenants = [f"t{i}" for i in range(6)]
    mux = TenantMultiplexer(lambda: MetricCollection(make(card)), MuxConfig(max_width=4))
    eager = {t: MetricCollection(make(card)) for t in tenants}
    for t in tenants:
        mux.adopt(t)
    for rnd in range(3):
        for i, t in enumerate(tenants):
            p, y = batches[6 * rnd + i]
            mux.feed(t, p, y)
            eager[t].update(p, y)
    report = mux.close()
    assert report.replayed_updates == 0 and report.eager_updates == 0 and report.fused_updates == 18
    assert mux.cache_info()["replays"] == report.dispatches
    for t in tenants:
        driven = mux.metric(t)
        for name in eager[t].keys(keep_base=True):
            for key, want in eager[t][name].state_dict(persistent_only=False).items():
                _assert_bitwise(driven[name].state_dict(persistent_only=False)[key], want, f"{t} {name}.{key}")
        got, want = mux.compute(t), eager[t].compute()
        for name in want:
            _assert_bitwise(got[name], want[name], f"{t} {name}")


def test_the_copy_in_of_a_retuned_ladder_is_right(card):
    """A ladder retuned mid-stream pads the next groups to other widths with other
    always-real rows: each width's graph copies in its own rows and states, and every
    tenant stays bitwise its eager loop."""
    from torchmetrics_tpu_torch.engine import MuxConfig, TenantMultiplexer

    raw = _imagenet_batches(15, n=64)
    batches = [(p.to(card), t.to(card)) for p, t in raw]
    tenants = [f"t{i}" for i in range(5)]
    mux = TenantMultiplexer(lambda: MetricCollection(_imagenet_set(card)), MuxConfig(max_width=8))
    eager = {t: MetricCollection(_imagenet_set(card)) for t in tenants}
    for t in tenants:
        mux.adopt(t)
    for rnd in range(3):
        if rnd == 1:
            assert mux.retune_width_buckets((3, 6)) == (3, 6, 8)  # five rows: width 6, not 8
        for i, t in enumerate(tenants):
            p, y = batches[5 * rnd + i]
            mux.feed(t, p, y)
            eager[t].update(p, y)
        mux.flush()
    report = mux.close()
    assert report.padded_rows == 3 + 1 + 1 and report.dispatches == 3
    assert mux.cache_info()["compiled_variants"] == 2  # width 8, then width 6
    for t in tenants:
        got, want = mux.compute(t), eager[t].compute()
        for name in want:
            _assert_bitwise(got[name], want[name], f"{t} {name}")


def test_a_captured_variants_count_equals_the_cpu_routes(card):
    """The cost ledger's estimate of one function is the same from the warm run before
    its capture on the card as from its first run on the CPU route."""
    from torchmetrics_tpu_torch.core.jit import StaticLeafJit
    from torchmetrics_tpu_torch.obs import cost

    def step(state, preds, target, valid, scores, labels, thresholds, ids, weights):
        cm, curve, hist = _scratch_step(state, preds, target, valid, scores, labels, thresholds, ids, weights, 10, 15)
        return state + cm.sum() + curve.sum() + hist.sum()

    inputs = _scratch_inputs(1 << 14, 10, 50, 15, seed=3)
    cost.get_ledger().clear()
    StaticLeafJit(step)(torch.zeros(()), *inputs)
    StaticLeafJit(step)(torch.zeros((), device=card), *(a.to(card) for a in inputs))
    torch.cuda.synchronize()
    cpu, gpu = sorted(cost.get_ledger().entries(), key=lambda e: e.backend)
    assert (cpu.backend, gpu.backend) == ("cpu", "cuda")
    assert cpu.flops == gpu.flops and cpu.bytes_accessed == gpu.bytes_accessed
    assert gpu.compile_seconds > 0 and gpu.argument_bytes == cpu.argument_bytes


# ---------------------------------------------------------------- multilabel


def _multilabel_set(device, buffer_capacity=None) -> dict:
    """``chip_smoke.py``'s multilabel_eval metrics (80 labels), the exact mAP buffered."""
    labels, kw = 80, {"validate_args": False, "device": device}
    return {
        "map_exact": tc.MultilabelAveragePrecision(labels, "macro", buffer_capacity=buffer_capacity, **kw),
        "map_t200": tc.MultilabelAveragePrecision(labels, "macro", thresholds=200, **kw),
        "auroc_macro_t200": tc.MultilabelAUROC(labels, "macro", thresholds=200, **kw),
        "auroc_micro_t200": tc.MultilabelAUROC(labels, "micro", thresholds=200, **kw),
        "cp": tc.MultilabelPrecision(labels, average="macro", **kw),
        "cr": tc.MultilabelRecall(labels, average="macro", **kw),
        "cf1": tc.MultilabelF1Score(labels, average="macro", **kw),
        "op": tc.MultilabelPrecision(labels, average="micro", **kw),
        "or": tc.MultilabelRecall(labels, average="micro", **kw),
        "of1": tc.MultilabelF1Score(labels, average="micro", **kw),
        "accuracy": tc.MultilabelAccuracy(labels, **kw),
        "confusion_matrix": tc.MultilabelConfusionMatrix(labels, **kw),
        "jaccard": tc.MultilabelJaccardIndex(labels, **kw),
        "matthews": tc.MultilabelMatthewsCorrCoef(labels, **kw),
    }


def _multilabel_batches(steps: int, n: int = 256):
    g = torch.Generator().manual_seed(23)
    prevalence = torch.rand(80, generator=g) ** 2 * 3 * 2.9 / 80
    out = []
    for _ in range(steps):
        target = (torch.rand(n, 80, generator=g) < prevalence).to(torch.int32)
        out.append((torch.sigmoid(torch.randn(n, 80, generator=g) + 3.0 * target - 2.0), target))
    return out


def test_a_multilabel_collection_through_fused_chunks_is_bitwise_its_eager_loop(card):
    """The multilabel_eval collection (4 compute groups) through MetricPipeline(fuse=8):
    a chunk of 8 and a padded chunk of 2, every state and value bitwise the eager
    collection loop's, and no K1-K5 launch on either side."""
    from torchmetrics_tpu_torch.engine import MetricPipeline, PipelineConfig

    batches = [(p.to(card), t.to(card)) for p, t in _multilabel_batches(10)]
    eager, driven = MetricCollection(_multilabel_set(card, 2560)), MetricCollection(_multilabel_set(card, 2560))
    assert sorted(len(g) for g in driven.compute_groups.values()) == [1, 3, 3, 7]
    kernels.reset_launch_counts()
    for p, t in batches:
        eager.update(p, t)
    pipe = MetricPipeline(driven, PipelineConfig(fuse=8))
    report = pipe.run(batches)
    assert sum(info["replays"] for info in pipe.cache_info()) == 2 and report.chunks_replayed == 0
    assert not any(kernels.LAUNCHES.values()), dict(kernels.LAUNCHES)
    for name in eager.keys(keep_base=True):
        for key, want in eager[name].state_dict(persistent_only=False).items():
            got = driven[name].state_dict(persistent_only=False)[key]
            if isinstance(want, dict):  # a MaskedBuffer: data and count
                _assert_bitwise([got["data"], got["count"]], [want["data"], want["count"]], f"{name}.{key}")
            else:
                _assert_bitwise(got, want, f"{name}.{key}")
    got, want = driven.compute(), eager.compute()
    for name in want:
        _assert_bitwise(got[name], want[name], name)


def test_a_buffered_multilabel_map_replays_its_capture(card):
    """The exact mAP's [capacity, 80] buffers through fused chunks: the write offset
    rides into the graph, the replays write what the eager appends write, and an
    overflow raises before the replay."""
    from torchmetrics_tpu_torch.engine import MetricPipeline, PipelineConfig

    batches = [(p.to(card), t.to(card)) for p, t in _multilabel_batches(6, n=100)]
    eager = tc.MultilabelAveragePrecision(80, buffer_capacity=600, validate_args=False)
    driven = tc.MultilabelAveragePrecision(80, buffer_capacity=600, validate_args=False)
    for p, t in batches:
        eager.update(p, t)
    pipe = MetricPipeline(driven, PipelineConfig(fuse=4))
    pipe.run(batches)  # a chunk of 4 and a padded chunk of 2
    assert sum(info["replays"] for info in pipe.cache_info()) == 2
    assert driven.preds.count == eager.preds.count == 600
    for key in ("preds", "target", "valid"):
        assert torch.equal(getattr(driven, key).data, getattr(eager, key).data), key
    _assert_bitwise(driven.compute(), eager.compute(), "map")

    small = tc.MultilabelAveragePrecision(80, buffer_capacity=450, validate_args=False)
    pipe = MetricPipeline(small, PipelineConfig(fuse=2))
    pipe.run(batches[:4])
    with pytest.raises(ValueError, match="overflowed"):
        pipe.run(batches[4:])
    assert small.preds.count == 400


def test_multilabel_value_checks_skip_in_a_capture_and_run_eagerly(card, monkeypatch):
    """With validate_args, a jitted multilabel update checks the target's values in its
    warm run, not inside the capture and not at a replay; an eager one checks every
    update and raises on a value outside {0, 1}."""
    # the modules, not the functions of the same names that the package exports
    stat_scores = importlib.import_module("torchmetrics_tpu_torch.functional.classification.stat_scores")
    confusion_matrix = importlib.import_module("torchmetrics_tpu_torch.functional.classification.confusion_matrix")
    seen = []

    def counting(x):
        assert not torch.cuda.is_current_stream_capturing()
        seen.append(x.shape)
        return set(torch.unique(x).tolist())

    monkeypatch.setattr(stat_scores, "_unique_values", counting)
    monkeypatch.setattr(confusion_matrix, "_unique_values", counting)
    batches = [(p.to(card), t.to(card)) for p, t in _multilabel_batches(3, n=64)]
    for make in (lambda **k: tc.MultilabelF1Score(80, **k), lambda **k: tc.MultilabelConfusionMatrix(80, **k)):
        eager, jitted = make(), make(jit_update=True)
        seen.clear()
        for p, t in batches:
            jitted.update(p, t)
        assert len(seen) == 1  # the warm run's check
        info = jitted._jitted_update.cache_info()
        assert (info["misses"], info["replays"]) == (1, 3)
        seen.clear()
        for p, t in batches:
            eager.update(p, t)
        assert len(seen) == 3
        for key, want in eager.state_dict(persistent_only=False).items():
            assert torch.equal(jitted.state_dict(persistent_only=False)[key], want), key
        with pytest.raises(RuntimeError, match="Detected the following values in `target`"):
            eager.update(batches[0][0], batches[0][1] * 2)


# ------------------------------------------------------- the rest of the family


def _fairness_case(n: int, groups: int, seed: int, invalid: float = 0.1):
    g = torch.Generator().manual_seed(seed)
    preds = torch.randint(0, 2, (n,), generator=g, dtype=torch.int32)
    target = torch.randint(0, 2, (n,), generator=g, dtype=torch.int32)
    segments = torch.randint(0, groups, (n,), generator=g, dtype=torch.int32)
    valid = torch.rand(n, generator=g) >= invalid
    return preds, target, segments, valid


@pytest.mark.parametrize("n, groups, invalid", [(1 << 18, 8, 0.01), (4096, 1000, 0.1), (100_000, 1000, 0.5),
                                                (4096, 8, 1.0), (1, 2, 0.0)])
def test_fairness_counts_through_the_bincount_kernel_equal_its_plain_version(card, n, groups, invalid):
    """The per-group counts on the card: one bincount launch of 4 * G + 1 bins, equal to
    the same update on the CPU (the plain version), also for a batch whose samples all
    land in the spare bin (invalid = 1) and for G = 1000."""
    from torchmetrics_tpu_torch.functional.classification import group_fairness as gf

    args = _fairness_case(n, groups, seed=groups + n, invalid=invalid)
    want = gf._binary_groups_stat_scores_update(*args, groups)
    kernels.reset_launch_counts()
    got = gf._binary_groups_stat_scores_update(*(a.to(card) for a in args), groups)
    torch.cuda.synchronize()
    assert (kernels.LAUNCHES["bincount"], kernels.LAUNCHES["weighted_bincount"]) == (1, 0)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32 and torch.equal(a.cpu(), b)
    assert int(sum(c.sum() for c in want)) == int(args[3].sum())


def test_fairness_metrics_on_the_card_equal_the_cpu(card):
    batches = [_fairness_case(1 << 14, 8, seed=s) for s in range(3)]
    for make in (lambda d: tc.BinaryGroupStatRates(8, device=d), lambda d: tc.BinaryFairness(8, device=d)):
        on_card, on_cpu = make(card), make("cpu")
        kernels.reset_launch_counts()
        for preds, target, segments, _ in batches:
            on_card.update(preds.to(card), target.to(card), segments.to(card))
            on_cpu.update(preds, target, segments)
        assert kernels.LAUNCHES["bincount"] == len(batches)
        for key, want in on_cpu.state_dict(persistent_only=False).items():
            assert torch.equal(on_card.state_dict(persistent_only=False)[key].cpu(), want), key
        got, want = on_card.compute(), on_cpu.compute()
        assert list(got) == list(want)
        for key in want:
            assert torch.equal(got[key].cpu(), want[key]), key


def _family_set(kind: str, device) -> dict:
    """``chip_smoke.py``'s family_eval metrics of one loop (full widths)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    return chip_smoke.family_metrics(kind, device)


def _family_batches(kind: str, steps: int):
    g = torch.Generator().manual_seed(31)
    out = []
    for _ in range(steps):
        if kind == "ctr":
            target = torch.randint(0, 2, (4096,), generator=g)
            preds = torch.sigmoid(torch.randn(4096, generator=g) + 1.2 * target - 0.6)
            target = torch.where(torch.rand(4096, generator=g) < 0.01, -1, target)
        elif kind == "imagenet":
            target = torch.randint(0, 1000, (64,), generator=g)
            preds = torch.softmax(torch.randn(64, 1000, generator=g) + 3.0 * torch.eye(1000)[target], dim=1)
        else:
            target = (torch.rand(64, 80, generator=g) < 0.04).to(torch.int32)
            preds = torch.sigmoid(torch.randn(64, 80, generator=g) + 3.0 * target - 2.0)
        out.append((preds, target))
    return out


@pytest.mark.parametrize("kind", ["ctr", "imagenet", "coco"])
def test_a_family_collection_through_fused_chunks_is_bitwise_its_eager_loop(card, kind):
    """The family_eval collection of each loop through MetricPipeline(fuse=4): a chunk of
    4 and a padded chunk of 2, every state and value bitwise the eager collection loop's
    and its launches those of the eager loop (nothing syncs inside the capture)."""
    from torchmetrics_tpu_torch.engine import MetricPipeline, PipelineConfig

    batches = [(p.to(card), t.to(card)) for p, t in _family_batches(kind, 6)]
    eager, driven = MetricCollection(_family_set(kind, card)), MetricCollection(_family_set(kind, card))
    kernels.reset_launch_counts()
    for p, t in batches:
        eager.update(p, t)
    eager_launches = dict(kernels.LAUNCHES)
    pipe = MetricPipeline(driven, PipelineConfig(fuse=4))
    pipe.warmup(*batches[0])
    kernels.reset_launch_counts()
    report = pipe.run(batches)
    info = pipe.cache_info()
    assert sum(i["replays"] for i in info) == 2 and not sum(i["misses"] for i in info)
    assert report.chunks_replayed == 0
    assert dict(kernels.LAUNCHES) == eager_launches
    for name in eager.keys(keep_base=True):
        for key, want in eager[name].state_dict(persistent_only=False).items():
            _assert_bitwise(driven[name].state_dict(persistent_only=False)[key], want, f"{name}.{key}")
    got, want = driven.compute(), eager.compute()
    for name in want:
        _assert_bitwise(got[name], want[name], name)


# ------------------------------------------------------------- robust and obs planes


def _capture_spies(monkeypatch) -> dict:
    """Record, for every audit note and every ``record_function`` range entered, whether
    a CUDA graph capture was recording at that moment."""
    from torchmetrics_tpu_torch.obs import audit

    seen = {"note_fold": [], "record_function": []}
    real_note, real_range = audit.note_fold, torch.profiler.record_function

    def note_fold(*args, **kwargs):
        seen["note_fold"].append(torch.cuda.is_current_stream_capturing())
        return real_note(*args, **kwargs)

    def record_function(name, *args, **kwargs):
        seen["record_function"].append((name, torch.cuda.is_current_stream_capturing()))
        return real_range(name, *args, **kwargs)

    monkeypatch.setattr(audit, "note_fold", note_fold)
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    return seen


def test_an_audited_fused_pipeline_and_mux_balance_their_ledger(card, monkeypatch):
    """The auditor over a fused ImageNet pipeline (one NaN batch quarantined) and a
    4-wide CTR multiplexer on the card: every tenant's ledger balances, no invariant is
    violated, and every fold was noted on the host, outside any capture."""
    from torchmetrics_tpu_torch.engine import MetricPipeline, MuxConfig, PipelineConfig, TenantMultiplexer
    from torchmetrics_tpu_torch.obs import audit, lineage, scope
    from torchmetrics_tpu_torch.robust import faults

    seen = _capture_spies(monkeypatch)
    lineage.enable()
    auditor = audit.ConservationAuditor(cadence_seconds=1e-6)
    audit.install_auditor(auditor)
    try:
        col = MetricCollection(_imagenet_set(card))
        for m in col.values(copy_state=False):
            m.error_policy = "quarantine"
        pipe = MetricPipeline(col, PipelineConfig(fuse=4, tenant="imagenet"))
        batches = [(p.to(card), t.to(card)) for p, t in _pipeline_batches("imagenet", 9)]
        with faults.inject_nan_updates(indices=(5,)), pytest.warns(RuntimeWarning):
            report = pipe.run(batches)
        assert report.chunks_replayed == 1
        mux = TenantMultiplexer(lambda: MetricCollection(_binary_set(card)), MuxConfig(max_width=4))
        ctr = [(p.to(card), t.to(card)) for p, t in _pipeline_batches("binary", 3)]
        for r, (p, t) in enumerate(ctr):
            for j in range(4):
                mux.feed(f"ctr-{j}", p, t)
        mux.flush()
        torch.cuda.synchronize()
        auditor.tick(now=1.0)
        auditor.tick(now=2.0)
        pipe.close()
        mux.close()
        auditor.tick(now=3.0)
        result = auditor.report()
    finally:
        audit.install_auditor(None)
        lineage.disable()
        scope.reset()
    assert result["violations"] == [] and all(row["passed"] for row in result["invariants"])
    for tenant, entry in result["tenants"].items():
        totals = entry["totals"]
        assert totals["fed"] == sum(totals[k] for k in ("processed", "shed", "deferred_pending", "quarantined",
                                                        "skipped", "in_flight", "handed_off")), tenant
    assert result["tenants"]["imagenet"]["totals"]["fed"] == 9
    assert result["tenants"]["imagenet"]["totals"]["quarantined"] == len(col.compute_groups)
    assert {t: result["tenants"][t]["totals"]["fed"] for t in ("ctr-0", "ctr-3")} == {"ctr-0": 3, "ctr-3": 3}
    assert seen["note_fold"] and not any(seen["note_fold"])


def test_a_captured_update_records_no_range_and_no_audit_note_inside_its_capture(card, monkeypatch, tmp_path):
    """With a profile session live and the auditor on, a ``jit_update`` metric and a fused
    pipeline capture their graphs: the metric ranges are entered in the warm call and
    on the eager path, never while the capture records, and no fold is noted there."""
    from torchmetrics_tpu_torch.engine import MetricPipeline, PipelineConfig
    from torchmetrics_tpu_torch.obs import audit, lineage, profile

    seen = _capture_spies(monkeypatch)
    batches = [(p.to(card), t.to(card)) for p, t in _imagenet_batches(4, n=64)]
    lineage.enable()
    audit.install_auditor(audit.ConservationAuditor())
    try:
        assert profile.start_trace(str(tmp_path))
        jitted = tc.MulticlassConfusionMatrix(1000, validate_args=False, jit_update=True)
        for p, t in batches:
            jitted.update(p, t)
        pipe = MetricPipeline(MetricCollection(_imagenet_set(card)), PipelineConfig(fuse=2))
        pipe.run(batches)
        pipe.close()
        torch.cuda.synchronize()
        assert profile.stop_trace()
    finally:
        profile.reset()
        audit.install_auditor(None)
        lineage.disable()
    assert jitted._jitted_update.cache_info()["replays"] == 4
    names = {name for name, _ in seen["record_function"]}
    assert "MulticlassConfusionMatrix.update" in names
    assert not any(capturing for _, capturing in seen["record_function"])
    assert seen["note_fold"] and not any(seen["note_fold"])
    with open(profile.last_trace_path(), encoding="utf-8") as fh:
        assert json.load(fh)["traceEvents"]


def test_device_memory_stats_has_both_keys_for_the_card(card):
    from torchmetrics_tpu_torch.obs import memory

    block = torch.zeros(1 << 20, dtype=torch.float32, device=card)
    stats = memory.device_memory_stats()
    row = stats["cuda:0"]
    assert set(row) == {"bytes_in_use", "peak_bytes_in_use"}
    assert row["peak_bytes_in_use"] >= row["bytes_in_use"] >= block.numel() * 4
    assert memory.peak_device_bytes() == max(r["peak_bytes_in_use"] for r in stats.values())
    col = MetricCollection(_imagenet_set(card))
    cpu = MetricCollection(_imagenet_set("cpu"))
    assert col.memory_footprint() == cpu.memory_footprint()


def test_guard_thread_runs_a_card_collective_on_the_callers_stream(card):
    """With a timeout set, the sync guard's worker thread enters the caller's current
    stream for a CUDA payload (an NCCL collective is ordered against it)."""
    import threading

    from torchmetrics_tpu_torch.robust import degraded

    side = torch.cuda.Stream(device=card)
    seen = []

    def collective(parts, tensor, group=None):
        seen.append((threading.current_thread().name, torch.cuda.current_device(), torch.cuda.current_stream()))
        parts[0].copy_(tensor)

    with torch.cuda.stream(side):
        payload = torch.arange(1024.0, device=card)
        parts = [torch.empty_like(payload)]
        with degraded.sync_guard(30.0, 0):
            degraded.guarded_collective(collective, parts, payload, group=None, description="probe")
    torch.cuda.synchronize()
    name, device, stream = seen[0]
    assert name == "guarded-probe" and device == payload.device.index and stream == side
    assert torch.equal(parts[0], payload)


def _profiled_update_ranges(log_dir: str) -> dict:
    """One profile session over three eager updates of a macro accuracy (K1) and a
    micro-averaged PR curve (K2) at 1000 classes: each range's count and the K1/K2
    kernels whose launch (CUDA runtime call, by correlation id) lies inside a range."""
    from torchmetrics_tpu_torch.obs import profile

    card = torch.device("cuda")
    acc = tc.MulticlassAccuracy(1000, average="macro", validate_args=False, device=card)
    curve = tc.MulticlassPrecisionRecallCurve(1000, average="micro", thresholds=200, validate_args=False,
                                              device=card)
    batches = [(p.to(card), t.to(card)) for p, t in _imagenet_batches(4, n=500)]
    acc.update(*batches[0])
    curve.update(*batches[0])
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with profile.profile_session(log_dir, host=False) as session:
        for p, t in batches[1:]:
            acc.update(p, t)
            curve.update(p, t)
        torch.cuda.synchronize()
    assert session["device"]
    with open(profile.last_trace_path(), encoding="utf-8") as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    ranges = [e for e in events if e.get("cat") == "user_annotation" and e["name"].endswith(".update")]
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("cat") == "cuda_runtime" and "correlation" in (e.get("args") or {})}
    inside: dict = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        kernel = "K1" if "confusion_matrix_" in e["name"] else "K2" if "curve_" in e["name"] else None
        host = runtime.get((e.get("args") or {}).get("correlation"))
        if kernel is None or host is None:
            continue
        owner = next((r["name"] for r in ranges if r.get("tid") == host.get("tid")
                      and r["ts"] <= host["ts"] <= r["ts"] + r["dur"]), None)
        inside.setdefault(kernel, {}).setdefault(str(owner), 0)
        inside[kernel][str(owner)] += 1
    return {"ranges": sorted({r["name"] for r in ranges}), "inside": inside,
            "launches": {k: kernels.LAUNCHES[k] for k in ("confusion_matrix", "binned_curve_counts")}}


def test_a_profile_of_an_eager_update_shows_the_metric_range_around_its_kernels(card, tmp_path):
    """In a new process (the profiler starts fresh there): the trace holds the metrics'
    ``<Class>.update`` ranges, and every K1 launch lies inside the accuracy's, every K2
    launch inside the PR curve's."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import json, sys; sys.path[:0] = sys.argv[1:3]; import test_torch_cuda as t; "
            "print(json.dumps(t._profiled_update_ranges(sys.argv[3])))")
    done = subprocess.run([sys.executable, "-c", code, here, os.path.dirname(here), str(tmp_path)],
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    got = json.loads(done.stdout.strip().splitlines()[-1])
    assert {"MulticlassAccuracy.update", "MulticlassPrecisionRecallCurve.update"} <= set(got["ranges"])
    assert got["launches"] == {"confusion_matrix": 3, "binned_curve_counts": 3}
    assert got["inside"]["K1"] == {"MulticlassAccuracy.update": 3}
    assert got["inside"]["K2"] == {"MulticlassPrecisionRecallCurve.update": 3}


# ------------------------------------------------------------------ served fleet


def test_a_scrape_during_a_captured_replay_records_nothing_inside_the_capture(card, monkeypatch):
    """A scraper thread reads the server's routes (each ``/metrics`` ticking an
    installed fleet sampler) while a fused ImageNet pipeline captures and replays its
    graphs: every scrape answers 200, no recorder write happens on a stream that is
    capturing, the graphs replay as captured, and the states are bitwise the eager
    loop's."""
    import threading
    import urllib.request

    from torchmetrics_tpu_torch.engine import MetricPipeline, PipelineConfig
    from torchmetrics_tpu_torch.obs import fleet, lineage, server, trace

    seen = []
    for name in ("inc", "set_gauge", "observe_duration", "add_event"):
        real = getattr(trace.TraceRecorder, name)

        def spy(self, *args, _real=real, **kwargs):
            seen.append(torch.cuda.is_current_stream_capturing())
            return _real(self, *args, **kwargs)

        monkeypatch.setattr(trace.TraceRecorder, name, spy)
    batches = [(p.to(card), t.to(card)) for p, t in _imagenet_batches(8, n=256)]
    eager, driven = MetricCollection(_imagenet_set(card)), MetricCollection(_imagenet_set(card))
    trace.enable()
    lineage.enable()
    fleet.install_sampler(fleet.FleetSampler(cadence_seconds=0.01))
    srv = server.IntrospectionServer([driven], port=0).start()
    stop, answers = threading.Event(), []

    def scrape():
        while not stop.is_set():
            for route in ("/metrics", "/healthz", "/memory", "/fleet", "/tenants", "/traces"):
                with urllib.request.urlopen(srv.url + route, timeout=30) as resp:
                    answers.append(resp.status)

    scraper = threading.Thread(target=scrape, daemon=True)
    scraper.start()
    try:
        pipe = MetricPipeline(driven, PipelineConfig(fuse=2))
        pipe.run(batches)
        replays = sum(info["replays"] for info in pipe.cache_info())
        pipe.close()
        torch.cuda.synchronize()
    finally:
        stop.set()
        scraper.join(60)
        srv.stop()
        fleet.install_sampler(None)
        lineage.disable()
        trace.disable()
    assert answers and set(answers) == {200}
    assert srv.recorder.counter_value("server.errors") == 0
    assert seen and not any(seen)
    assert replays == 4
    for p, t in batches:
        eager.update(p, t)
    _assert_states_bitwise(_session_states(driven), _session_states(eager), "served")


@pytest.mark.parametrize("kind", ["imagenet", "binary"])
def test_a_served_session_equals_its_plain_version_run(card, kind):
    """A tenant session under the fleet plane on the card (server, sampler, placement
    controller, a ``/metrics`` scrape per batch) against the same batches through the
    CPU, where every kernel runs its plain version: integer states equal, floats within
    1e-5."""
    import urllib.request

    from torchmetrics_tpu_torch import fleet as placement
    from torchmetrics_tpu_torch.engine import MetricPipeline, PipelineConfig
    from torchmetrics_tpu_torch.obs import fleet, server

    make = _imagenet_set if kind == "imagenet" else _binary_set
    batches = _imagenet_batches(6, n=256) if kind == "imagenet" else _binary_batches(6)
    served, plain = MetricCollection(make(card)), MetricCollection(make("cpu"))
    sampler = fleet.FleetSampler(cadence_seconds=0.01, placement={f"{kind}-0": "host-a"}, hosts=("host-a", "host-b"))
    fleet.install_sampler(sampler)
    controller = placement.PlacementController(placement.PlacementConfig(hosts=("host-a", "host-b")), sampler=sampler)
    controller.seed({f"{kind}-0": "host-a"})
    placement.install_controller(controller)
    srv = server.IntrospectionServer([served], port=0).start()
    try:
        pipe = MetricPipeline(served, PipelineConfig(fuse=4, tenant=f"{kind}-0"))
        for p, t in batches:
            pipe.feed(p.to(card), t.to(card))
            with urllib.request.urlopen(srv.url + "/metrics", timeout=30) as resp:
                assert resp.status == 200
        pipe.close()
    finally:
        srv.stop()
        placement.install_controller(None)
        fleet.install_sampler(None)
    assert sampler.samples_taken >= 1
    for p, t in batches:
        plain.update(p, t)
    for name in plain.keys(keep_base=True):
        for key, want in plain[name].state_dict(persistent_only=False).items():
            _compare(served[name].state_dict(persistent_only=False)[key], want)


def test_a_restore_from_a_scrape_thread_mid_feed_replays_bitwise_its_unmoved_control(card, monkeypatch):
    """The flash-crowd chaos replay on the card: the placement controller, ticked by a
    ``/metrics`` scrape on a server thread, moves sessions (drain, checkpoint, restore,
    swap) while the schedule's feeding loop runs. Each restore runs off the main thread,
    inside the run, under the replay's device lock; the restored sessions replay their
    captured graphs, and every moved session computes bitwise its unmoved shadow
    control fed the same stream."""
    import threading
    import time

    from torchmetrics_tpu_torch import chaos
    from torchmetrics_tpu_torch.engine import migrate

    restores, real = [], migrate.restore_session

    def spy(*args, **kwargs):
        pipe, manifest = real(*args, **kwargs)
        restores.append((threading.current_thread() is threading.main_thread(), time.time(), pipe))
        return pipe, manifest

    monkeypatch.setattr(migrate, "restore_session", spy)
    result = chaos.replay(chaos.generate(chaos.flash_crowd_config()), chaos.ReplayConfig(flash_crowd=True))
    torch.cuda.synchronize()
    placement = result["placement"]
    assert placement["moves_completed"] >= 1 and restores
    end = result["wall_start_unix"] + result["wall_seconds"]
    assert all(not on_main and result["wall_start_unix"] <= at <= end for on_main, at, _ in restores)
    assert sum(info["replays"] for _, _, pipe in restores for info in pipe.cache_info()) > 0
    assert placement["zero_loss"] is True and placement["controls"]
    assert all(row["bit_identical"] for row in placement["controls"].values())


def test_a_default_chaos_replay_on_the_card_equals_the_same_schedule_on_the_cpu(card):
    """The default chaos scenario (the JAX suite's small schedule) on the card and on the
    CPU: the same batches fed, faults, named poisoned batches, fired-and-resolved alert
    episodes and robust counters, and every tenant's final states and value (counts and
    accuracies bitwise, the victim's MSE within 1e-6 relative)."""
    import importlib

    from torchmetrics_tpu_torch import chaos

    replay_mod = importlib.import_module("torchmetrics_tpu_torch.chaos.replay")
    schedule = chaos.generate(chaos.ScheduleConfig(seed=0, tenants=8, warm_batches=2, churn_batches=2,
                                                   drain_batches=3, hang_seconds=0.5, absent_after_seconds=0.15,
                                                   idle_gap_seconds=0.01))
    runs = {}
    for device in ("cuda", "cpu"):
        built, original = {}, replay_mod._build_tenants

        def build(*args, _original=original, _built=built, **kwargs):
            out = _original(*args, **kwargs)
            _built["metrics"] = out[0]
            return out

        replay_mod._build_tenants = build
        try:
            result = chaos.replay(schedule, chaos.ReplayConfig(fuse=1, scrape_interval_seconds=0.03,
                                                                sync_timeout_seconds=0.02, device=device))
        finally:
            replay_mod._build_tenants = original
        runs[device] = (result, built["metrics"])

    def events(result):
        return (result["batches_fed"], [(f["fault"], f["tenant"], f.get("batch_index")) for f in result["faults"]],
                {(d["tenant"], i) for d in result["flight"]["dumps"] for i in d["poisoned_batches"]},
                {(e["rule"], e["tenant"]) for e in result["alerts"]["episodes"]
                 if e.get("fired_at") is not None and e.get("resolved_at") is not None},
                result["robust"])

    (card_result, card_metrics), (cpu_result, cpu_metrics) = runs["cuda"], runs["cpu"]
    assert events(card_result) == events(cpu_result)
    assert card_result["robust"]["sync_degraded"] == [schedule.hung]
    for tenant in sorted(cpu_metrics):
        got = {**card_metrics[tenant].state_dict(persistent_only=False), "value": card_metrics[tenant].compute()}
        want = {**cpu_metrics[tenant].state_dict(persistent_only=False), "value": cpu_metrics[tenant].compute()}
        assert sorted(got) == sorted(want)
        for key in want:
            g, w = got[key].cpu(), want[key]
            if tenant == schedule.victim and w.is_floating_point():
                torch.testing.assert_close(g, w, rtol=1e-6, atol=0.0)
            else:
                assert g.dtype == w.dtype and torch.equal(g, w), (tenant, key)


def test_plot_of_card_metrics_copies_to_the_host_or_raises_without_matplotlib(card):
    """``plot`` of metrics whose states and values live on the card: with matplotlib the
    figure holds the CPU twin's data (values copied to the host first); without it (the
    chip machine has none) ``plot`` raises the JAX package's error."""
    from torchmetrics_tpu_torch.utils import plot as plot_mod

    g = torch.Generator().manual_seed(5)
    preds, target = torch.rand(64, 4, generator=g), torch.randint(0, 4, (64,), generator=g)
    pairs = []
    for make in (lambda d: tc.MulticlassConfusionMatrix(4, device=d), lambda d: tc.MulticlassROC(4, device=d),
                 lambda d: tc.MulticlassAccuracy(4, average=None, device=d)):
        on_card, on_cpu = make(card), make("cpu")
        on_card.update(preds.to(card), target.to(card))
        on_cpu.update(preds, target)
        pairs.append((on_card, on_cpu))
    if not plot_mod._MATPLOTLIB_AVAILABLE:
        for on_card, _ in pairs:
            with pytest.raises(ModuleNotFoundError, match="matplotlib is required for plotting but is not installed."):
                on_card.plot()
        return
    import matplotlib

    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    for on_card, on_cpu in pairs:
        (fig_a, ax_a), (fig_b, ax_b) = on_card.plot()[:2], on_cpu.plot()[:2]
        for a, b in zip(fig_a.axes, fig_b.axes):
            assert [ln.get_label() for ln in a.lines] == [ln.get_label() for ln in b.lines]
            for la, lb in zip(a.lines, b.lines):
                torch.testing.assert_close(torch.as_tensor(la.get_ydata()), torch.as_tensor(lb.get_ydata()))
            for ia, ib in zip(a.images, b.images):
                assert (ia.get_array() == ib.get_array()).all()
            assert [t.get_text() for t in a.texts] == [t.get_text() for t in b.texts]
        plt.close(fig_a)
        plt.close(fig_b)


# ------------------------------------------------------------------ retrieval and wrappers


def _retrieval_run(queries: int = 300, candidates: int = 200, seed: int = 23) -> list:
    """CPU batches (scores rounded to 2 decimals so that ties occur, binary labels, sparse
    query ids) of 50 queries each, rows shuffled within a batch."""
    g = torch.Generator().manual_seed(seed)
    qids = torch.randperm(1_100_000, generator=g)[:queries].to(torch.int32)
    labels = (torch.rand(queries, candidates, generator=g) < 0.01).to(torch.int32)
    scores = torch.round(torch.randn(queries, candidates, generator=g) + 2.0 * labels, decimals=2)
    batches = []
    for start in range(0, queries, 50):
        order = torch.randperm(50 * candidates, generator=g)
        ids = qids[start:start + 50].repeat_interleave(candidates)
        batches.append((scores[start:start + 50].reshape(-1)[order], labels[start:start + 50].reshape(-1)[order],
                        ids[order]))
    return batches


def _retrieval_set(device) -> dict:
    from torchmetrics_tpu_torch import retrieval as tr

    return {
        "mrr": tr.RetrievalMRR(top_k=10, device=device), "recall": tr.RetrievalRecall(top_k=100, device=device),
        "ndcg": tr.RetrievalNormalizedDCG(top_k=10, device=device), "map": tr.RetrievalMAP(device=device),
        "precision": tr.RetrievalPrecision(top_k=10, adaptive_k=True, device=device),
        "hit_rate": tr.RetrievalHitRate(top_k=10, device=device), "fall_out": tr.RetrievalFallOut(top_k=10, device=device),
        "r_precision": tr.RetrievalRPrecision(device=device), "auroc": tr.RetrievalAUROC(top_k=50, device=device),
        "curve": tr.RetrievalPrecisionRecallCurve(max_k=20, device=device),
        "fixed": tr.RetrievalRecallAtFixedPrecision(min_precision=0.05, max_k=20, device=device),
    }


def test_retrieval_compute_launches_k3_and_k4_and_equals_its_plain_run(card):
    """Every retrieval metric's batched compute on the card: K3 and K4 launched, a fixed
    number of launches, every value within 1e-6 of the same run on the CPU (counts and
    the best k exactly)."""
    batches = _retrieval_run()
    on_card, on_cpu = _retrieval_set(card), _retrieval_set("cpu")
    for preds, target, ids in batches:
        for m in on_card.values():
            m.update(preds.to(card), target.to(card), indexes=ids.to(card))
        for m in on_cpu.values():
            m.update(preds, target, indexes=ids)
    kernels.reset_launch_counts()
    values = {name: m.compute() for name, m in on_card.items()}
    launches = dict(kernels.LAUNCHES)
    assert launches["bincount"] == 11 and launches["weighted_bincount"] == 15, launches
    for name, m in on_cpu.items():
        want = m.compute()
        got = values[name]
        for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            if g.dtype == torch.int32:
                assert torch.equal(g.cpu(), w), name
            else:
                torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-6)


def test_retrieval_batched_scores_on_the_card_equal_its_single_query_loop(card):
    from torchmetrics_tpu_torch.retrieval import segments
    from torchmetrics_tpu_torch.retrieval.base import RetrievalMetric

    preds, target, ids = (a.to(card) for a in _retrieval_run(queries=50)[0])
    seg = segments.QuerySegments(ids, preds, target)
    for name, m in _retrieval_set(card).items():
        if not isinstance(m, RetrievalMetric):
            continue
        scores, empty = m._query_scores(seg)
        loop_scores, loop_empty = RetrievalMetric._query_scores(m, seg)
        assert torch.equal(empty, loop_empty), name
        torch.testing.assert_close(torch.where(empty, torch.zeros_like(scores), scores), loop_scores, rtol=0,
                                   atol=1e-5 if name == "auroc" else 1e-6)


def test_retrieval_a_captured_buffered_update_equals_the_eager_one(card):
    """A buffered MAP whose update is captured (``jit_update=True``) and one whose chunks
    replay through ``MetricPipeline(fuse=4)`` hold the eager buffer's rows and value."""
    from torchmetrics_tpu_torch import retrieval as tr
    from torchmetrics_tpu_torch.engine import MetricPipeline, PipelineConfig

    batches = [tuple(a.to(card) for a in b) for b in _retrieval_run()]
    rows = sum(b[0].numel() for b in batches)
    eager = tr.RetrievalMAP(buffer_capacity=rows, device=card)
    captured = tr.RetrievalMAP(buffer_capacity=rows, jit_update=True, device=card)
    piped = tr.RetrievalMAP(buffer_capacity=rows, jit_update=True, device=card)
    for preds, target, ids in batches:
        eager.update(preds, target, indexes=ids)
        captured.update(preds, target, indexes=ids)
    pipe = MetricPipeline(piped, PipelineConfig(fuse=4))
    pipe.run(batches)
    assert sum(info["replays"] for info in pipe.cache_info()) == 2
    for m in (captured, piped):
        assert m.preds.count == eager.preds.count == rows
        for key in ("indexes", "preds", "target", "valid"):
            assert torch.equal(getattr(m, key).data, getattr(eager, key).data), key
        _assert_bitwise(m.compute(), eager.compute(), "map")


def test_wrappers_of_a_macro_metric_launch_k1_and_equal_their_cpu_twins(card):
    """BootStrapper (same seed), ClasswiseWrapper and MultitaskWrapper around macro
    classification metrics at 1000 classes: K1 launched, every value its CPU twin's."""
    import numpy as np

    from torchmetrics_tpu_torch import regression as tr
    from torchmetrics_tpu_torch import wrappers as tw

    def build(device):
        np.random.seed(3)
        return {
            "bootstrap": tw.BootStrapper(tc.MulticlassAccuracy(1000, average="macro", device=device), num_bootstraps=5),
            "classwise": tw.ClasswiseWrapper(tc.MulticlassF1Score(1000, average=None, device=device)),
            "multitask": tw.MultitaskWrapper({"cls": tc.MulticlassRecall(1000, average="macro", device=device),
                                              "reg": tr.MeanSquaredError(device=device)}),
        }

    g = torch.Generator().manual_seed(8)
    data = [(torch.rand(500, 1000, generator=g), torch.randint(0, 1000, (500,), generator=g)) for _ in range(3)]
    results = {}
    for device in (card, "cpu"):
        metrics = build(device)
        kernels.reset_launch_counts()
        for preds, target in data:
            p, t = preds.to(device), target.to(device)
            metrics["bootstrap"].update(p, t)
            metrics["classwise"].update(p, t)
            metrics["multitask"].update({"cls": p, "reg": p[:, 0]}, {"cls": t, "reg": p[:, 1]})
        results[str(device)] = ({k: m.compute() for k, m in metrics.items()}, dict(kernels.LAUNCHES))
    (card_values, launches), (cpu_values, _) = results[str(card)], results["cpu"]
    assert launches["confusion_matrix"] > 0, launches

    def close(a, b, where):
        if isinstance(b, dict):
            assert list(a) == list(b), where
            for k in b:
                close(a[k], b[k], f"{where}.{k}")
            return
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-5, msg=where)

    close(card_values, cpu_values, "wrappers")


# ------------------------------------------------------- clustering, nominal, segmentation, pairwise


def test_segmentation_tables_on_the_bincount_kernel_equal_its_plain_version(card):
    """Cityscapes-like index maps with 255 and negative labels on both sides: one K4
    launch a batch, its (C+1)^2 tables equal to the CPU's plain version, and the
    index-route scores equal to the CPU's."""
    from torchmetrics_tpu_torch.functional import segmentation as fs
    from torchmetrics_tpu_torch.functional.segmentation import scores

    g = torch.Generator().manual_seed(31)
    preds = torch.randint(-2, 21, (4, 256, 512), generator=g)
    target = torch.where(torch.rand(4, 256, 512, generator=g) < 0.1, 255, torch.randint(0, 19, (4, 256, 512),
                                                                                            generator=g))
    kernels.reset_launch_counts()
    on_card = scores._index_class_sums(preds.to(card), target.to(card), 19)
    assert kernels.LAUNCHES["bincount"] == 1
    for got, want in zip(on_card, scores._index_class_sums(preds, target, 19)):
        assert got.dtype == torch.int32 and torch.equal(got.cpu(), want)
    for fn in (fs.mean_iou, fs.generalized_dice_score):
        torch.testing.assert_close(fn(preds.to(card), target.to(card), 19, input_format="index").cpu(),
                                   fn(preds, target, 19, input_format="index"), rtol=0, atol=1e-6)


def test_a_1000_by_1000_contingency_table_on_the_bincount_kernel_equals_the_cpu(card):
    from torchmetrics_tpu_torch.functional import clustering as fc
    from torchmetrics_tpu_torch.functional.clustering.utils import calculate_contingency_matrix

    g = torch.Generator().manual_seed(32)
    target = torch.randint(0, 1000, (50_000,), generator=g)
    preds = torch.where(torch.rand(50_000, generator=g) < 0.6, target, torch.randint(0, 1000, (50_000,), generator=g))
    kernels.reset_launch_counts()
    table = calculate_contingency_matrix(preds.to(card), target.to(card))
    assert kernels.LAUNCHES["bincount"] == 1 and table.shape == (1000, 1000) and table.dtype == torch.float64
    assert torch.equal(table.cpu(), calculate_contingency_matrix(preds, target))
    for name in ("rand_score", "adjusted_rand_score", "fowlkes_mallows_index", "v_measure_score"):
        torch.testing.assert_close(getattr(fc, name)(preds.to(card), target.to(card)).cpu(),
                                   getattr(fc, name)(preds, target), rtol=0, atol=1e-6)


def test_the_expected_mutual_information_on_the_card_equals_the_cpu(card):
    from torchmetrics_tpu_torch.functional.clustering import extrinsic
    from torchmetrics_tpu_torch.functional.clustering.utils import calculate_contingency_matrix

    g = torch.Generator().manual_seed(33)
    preds, target = torch.randint(0, 300, (20_000,), generator=g), torch.randint(0, 250, (20_000,), generator=g)
    table = calculate_contingency_matrix(preds, target)
    on_cpu = extrinsic.expected_mutual_info_score(table, 20_000)
    on_card = extrinsic.expected_mutual_info_score(table.to(card), 20_000)
    assert on_card.device.type == "cuda"
    torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=0, atol=1e-5)
    torch.testing.assert_close(extrinsic.adjusted_mutual_info_score(preds.to(card), target.to(card)).cpu(),
                               extrinsic.adjusted_mutual_info_score(preds, target), rtol=0, atol=1e-5)


def test_a_nominal_matrix_launches_k1_once_a_pair_and_equals_the_cpu(card):
    from torchmetrics_tpu_torch.functional import nominal as fn

    g = torch.Generator().manual_seed(34)
    columns = [torch.randint(0, c, (4096,), generator=g).to(torch.float32) for c in (9, 16, 7, 2)]
    columns[0] = torch.where(torch.rand(4096, generator=g) < 0.07, float("nan"), columns[0])
    matrix = torch.stack(columns, dim=1)
    for name, pairs in (("cramers_v_matrix", 6), ("theils_u_matrix", 12)):
        for strategy in ("replace", "drop"):
            kernels.reset_launch_counts()
            got = getattr(fn, name)(matrix.to(card), nan_strategy=strategy)
            assert kernels.LAUNCHES["confusion_matrix"] == pairs, (name, strategy, kernels.LAUNCHES)
            torch.testing.assert_close(got.cpu(), getattr(fn, name)(matrix, nan_strategy=strategy), rtol=0, atol=1e-6)


def test_pairwise_products_on_the_card_run_in_full_float32(card):
    """The linear similarity on the card within float32 rounding of a float64 product,
    which TF32 (10-bit mantissas) would miss by ~1e-3 relative, even with TF32 on
    process-wide (the product then runs in float64); the flag is never written."""
    from torchmetrics_tpu_torch.functional import pairwise as fp

    g = torch.Generator().manual_seed(35)
    x, y = torch.randn(512, 768, generator=g) + 1.0, torch.randn(1024, 768, generator=g) + 1.0
    want = (x.double() @ y.double().T)
    matmul = torch.backends.cuda.matmul
    before = matmul.fp32_precision
    try:
        matmul.fp32_precision = "tf32"
        got = fp.pairwise_linear_similarity(x.to(card), y.to(card)).cpu().double()
        assert matmul.fp32_precision == "tf32"
    finally:
        matmul.fp32_precision = before
    assert float(((got - want).abs() / want.abs().max()).max()) < 1e-6
    torch.testing.assert_close(fp.pairwise_minkowski_distance(x.to(card), y.to(card), exponent=3).cpu(),
                               fp.pairwise_minkowski_distance(x, y, exponent=3), rtol=1e-5, atol=0)


CUDNN_KERNEL_MARKS = ("cudnn", "xmma", "implicit_convolve", "sm80_", "sm90_")
CONV_CASES = [(dims, channels, planes) for dims in (2, 3) for channels in (1, 3) for planes in (1, 5)]


def _conv_inputs(dims: int, channels: int, planes: int):
    g = torch.Generator().manual_seed(dims * 10 + channels + planes)
    spatial = (96, 80) if dims == 2 else (12, 40, 36)
    x = torch.rand(planes, channels, *spatial, generator=g)
    kernel = torch.rand(channels, 1, *([7] * dims), generator=g) / 49.0
    return x, kernel


def _conv_kernel_names(cases: list) -> list:
    """For each (dims, channels, planes), the device kernels of one ``_conv2d``/``_conv3d``
    call on the card with cuDNN's TF32 flag on: the fullest of three traces."""
    from torch.profiler import ProfilerActivity, profile

    from torchmetrics_tpu_torch.functional.image import utils as iu

    torch.backends.cudnn.allow_tf32 = True
    result = []
    for dims, channels, planes in cases:
        x, kernel = (t.cuda() for t in _conv_inputs(dims, channels, planes))
        conv = iu._conv2d if dims == 2 else iu._conv3d
        conv(x, kernel, groups=channels)
        torch.cuda.synchronize()
        traces = []
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                conv(x, kernel, groups=channels)
                torch.cuda.synchronize()
            traces.append([e.key for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA and e.count])
        result.append(max(traces, key=len))
    assert torch.backends.cudnn.allow_tf32 is True
    return result


@pytest.fixture(scope="module")
def conv_kernel_names() -> dict:
    """``_conv_kernel_names`` of every case, traced in a new process (a process that has
    run many traces may record no device event in its later ones)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import json, sys; sys.path[:0] = sys.argv[1:3]; import test_torch_cuda as t; "
            "print(json.dumps(t._conv_kernel_names(json.loads(sys.argv[3]))))")
    done = subprocess.run([sys.executable, "-c", code, here, os.path.dirname(here), json.dumps(CONV_CASES)],
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    return dict(zip(CONV_CASES, json.loads(done.stdout.strip().splitlines()[-1])))


@pytest.mark.parametrize("dims, channels, planes", CONV_CASES)
def test_image_convolutions_reach_no_cudnn_kernel(card, conv_kernel_names, dims, channels, planes):
    """``_conv2d``/``_conv3d`` with one channel a group, as UQI, SSIM's 3D branch and the
    uniform filter call them, run on PyTorch's native depthwise kernels (which have no
    TF32 path) with cuDNN's TF32 flag on, and equal the CPU; a single channel is folded
    into depthwise form. The flag is never written."""
    from torchmetrics_tpu_torch.functional.image import utils as iu

    names = conv_kernel_names[(dims, channels, planes)]
    assert not [n for n in names if any(mark in n for mark in CUDNN_KERNEL_MARKS)], names
    assert any("conv_depthwise" in n for n in names), names
    x, kernel = _conv_inputs(dims, channels, planes)
    conv = iu._conv2d if dims == 2 else iu._conv3d
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32
    try:
        cudnn.allow_tf32 = True
        got = conv(x.to(card), kernel.to(card), groups=channels).cpu()
        assert cudnn.allow_tf32 is True
    finally:
        cudnn.allow_tf32 = before
    torch.testing.assert_close(got, conv(x, kernel, groups=channels), rtol=1e-5, atol=1e-6)
    exact = (torch.nn.functional.conv2d if dims == 2 else torch.nn.functional.conv3d)(
        x.double(), kernel.double(), groups=channels)
    # TF32 (10-bit mantissas) would miss by ~1e-3 of the largest output
    assert float((got.double() - exact).abs().max()) < 1e-5 * float(exact.abs().max())


def test_uqi_of_a_grayscale_image_on_the_card_equals_the_cpu(card):
    from torchmetrics_tpu_torch.functional.image import universal_image_quality_index

    g = torch.Generator().manual_seed(36)
    preds, target = torch.rand(2, 1, 64, 72, generator=g), torch.rand(2, 1, 64, 72, generator=g)
    got = universal_image_quality_index(preds.to(card), target.to(card))
    torch.testing.assert_close(got.cpu(), universal_image_quality_index(preds, target), rtol=1e-5, atol=1e-6)


def _lm_batch(vocab: int, shape: tuple, seed: int):
    g = torch.Generator().manual_seed(seed)
    target = torch.randint(0, vocab, shape, generator=g)
    logits = torch.randn(*shape, vocab, generator=g)
    logits.scatter_add_(-1, target[..., None], torch.full((*shape, 1), 8.0))
    target[-1, -shape[1] // 4:] = -100
    return logits, target


def test_perplexity_at_llama_vocabulary_on_the_card_equals_the_cpu(card):
    from torchmetrics_tpu_torch.text import Perplexity

    on_card, on_cpu = Perplexity(ignore_index=-100, device=card), Perplexity(ignore_index=-100, device="cpu")
    for seed in range(2):
        logits, target = _lm_batch(32_000, (2, 256), seed)
        on_card.update(logits.to(card), target.to(card))
        on_cpu.update(logits, target)
    assert on_card.count.device.type == "cuda" and torch.equal(on_card.count.cpu(), on_cpu.count)
    torch.testing.assert_close(on_card.total_log_probs.cpu(), on_cpu.total_log_probs, rtol=1e-5, atol=0)
    torch.testing.assert_close(on_card.compute().cpu(), on_cpu.compute(), rtol=1e-5, atol=0)


def test_a_captured_perplexity_update_equals_the_eager_one_bitwise(card):
    from torchmetrics_tpu_torch.text import Perplexity

    eager = Perplexity(ignore_index=-100, device=card)
    captured = Perplexity(ignore_index=-100, device=card, jit_update=True)
    for seed in range(4):
        logits, target = (t.to(card) for t in _lm_batch(32_000, (2, 128), 10 + seed))
        eager.update(logits, target)
        captured.update(logits, target)
    for key in ("total_log_probs", "count"):
        assert torch.equal(getattr(eager, key), getattr(captured, key)), key
    assert torch.equal(eager.compute(), captured.compute())
    info = captured._jitted_update.cache_info()
    assert info["misses"] == 1 and info["replays"] >= 3, info


TEXT_CARD_CASES = {
    "WordErrorRate": ({}, "error"), "CharErrorRate": ({}, "error"), "MatchErrorRate": ({}, "error"),
    "WordInfoLost": ({}, "error"), "WordInfoPreserved": ({}, "error"), "EditDistance": ({}, "error"),
    "EditDistance_none": ({"reduction": "none"}, "error"), "BLEUScore": ({}, "mt"), "SacreBLEUScore": ({}, "mt"),
    "CHRFScore": ({"return_sentence_level_score": True}, "mt"),
    "TranslationEditRate": ({"return_sentence_level_score": True}, "mt"),
    "ExtendedEditDistance": ({"return_sentence_level_score": True}, "mt"), "ROUGEScore": ({"rouge_keys": (
        "rouge1", "rougeL")}, "mt"), "SQuAD": ({}, "qa"),
}


@pytest.mark.parametrize("name", sorted(TEXT_CARD_CASES))
def test_the_states_of_a_string_metric_live_on_the_card(card, name):
    from torchmetrics_tpu_torch import text as tt

    kw, kind = TEXT_CARD_CASES[name]
    cls = getattr(tt, name.split("_")[0])
    preds = ["the cat is on the mat", "über a dog walks", ""]
    batch = {
        "error": (preds, ["there is a cat on the mat", "a dog walks", "x"]),
        "mt": (preds, [["there is a cat on the mat", "a cat is on the mat"], ["a dog walks in the park"], ["x"]]),
        "qa": ([{"prediction_text": "the 1976", "id": "1"}], [{"answers": {"text": ["1976", "a"]}, "id": "1"}]),
    }[kind]
    on_card, on_cpu = cls(device=card, **kw), cls(device="cpu", **kw)
    for metric in (on_card, on_cpu):
        metric.update(*batch)
        metric.update(*batch)
    for key, state in on_card.state_dict(persistent_only=False).items():
        for t in state if isinstance(state, list) else [state]:
            assert t.device.type == "cuda", key
    got, want = on_card.compute(), on_cpu.compute()
    flat = lambda v: list(v.values()) if isinstance(v, dict) else (list(v) if isinstance(v, tuple) else [v])  # noqa: E731
    for a, b in zip(flat(got), flat(want)):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-6)


# ------------------------------------------------------------- audio and image quality

SLICE_CONV_CASES = ("stoi_resample", "stoi", "scc", "vif", "d_s", "srmr")


def _slice_signals(case: str):
    g = torch.Generator().manual_seed(SLICE_CONV_CASES.index(case) + 40)
    if case.startswith("stoi"):
        clean = torch.randn(2, 16000, generator=g)
        return clean + 0.5 * torch.randn(2, 16000, generator=g), clean
    if case == "srmr":
        return (torch.randn(2, 8000, generator=g),)
    if case == "d_s":
        return torch.rand(2, 3, 64, 64, generator=g), torch.rand(2, 3, 16, 16, generator=g), \
            torch.rand(2, 3, 64, 64, generator=g)
    target = torch.rand(2, 3, 64, 64, generator=g)
    return (target + 0.1 * torch.randn(2, 3, 64, 64, generator=g)).clamp(0, 1), target


def _slice_call(case: str):
    from torchmetrics_tpu_torch.functional import audio as fa
    from torchmetrics_tpu_torch.functional import image as fi
    from torchmetrics_tpu_torch.functional.audio.stoi import resample_poly

    return {
        "stoi_resample": lambda x, _: resample_poly(x, 16000, 10000),
        "stoi": lambda p, t: fa.short_time_objective_intelligibility(p, t, 16000),
        "scc": fi.spatial_correlation_coefficient,
        "vif": fi.visual_information_fidelity,
        "d_s": fi.spatial_distortion_index,
        "srmr": lambda x: fa.speech_reverberation_modulation_energy_ratio(x, 8000),
    }[case]


def _slice_kernel_names(cases: list) -> list:
    """For each case, the device kernels of one call of the slice's function on the card
    with cuDNN's TF32 flag on: the fullest of three traces."""
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cudnn.allow_tf32 = True
    result = []
    for case in cases:
        args = [t.cuda() for t in _slice_signals(case)]
        fn = _slice_call(case)
        fn(*args)
        torch.cuda.synchronize()
        traces = []
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn(*args)
                torch.cuda.synchronize()
            traces.append([e.key for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA and e.count])
        result.append(max(traces, key=len))
    assert torch.backends.cudnn.allow_tf32 is True
    return result


@pytest.fixture(scope="module")
def slice_kernel_names() -> dict:
    """``_slice_kernel_names`` of every case, traced in a new process."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import json, sys; sys.path[:0] = sys.argv[1:3]; import test_torch_cuda as t; "
            "print(json.dumps(t._slice_kernel_names(json.loads(sys.argv[3]))))")
    done = subprocess.run([sys.executable, "-c", code, here, os.path.dirname(here), json.dumps(SLICE_CONV_CASES)],
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    return dict(zip(SLICE_CONV_CASES, json.loads(done.stdout.strip().splitlines()[-1])))


@pytest.mark.parametrize("case", SLICE_CONV_CASES)
def test_audio_and_image_quality_convolutions_reach_no_cudnn_kernel(card, slice_kernel_names, case):
    """STOI's strided resample, SCC's and VIF's single-channel convolutions and D-s's
    uniform filter run on PyTorch's native depthwise kernels with cuDNN's TF32 flag on;
    SRMR convolves by FFT and its frame energies are a product. Each equals the CPU; no
    flag is written."""
    names = slice_kernel_names[case]

    def cudnn_like(name: str) -> bool:
        # cuBLAS's float32 products (STOI's band energies, D-s's resize, SRMR's frame
        # energies) share the xmma/sm90_ prefixes; a convolution's kernels name it
        low = name.lower()
        plain_gemm = "gemm" in low and not any(m in low for m in ("fprop", "dgrad", "wgrad", "conv"))
        return any(mark in name for mark in CUDNN_KERNEL_MARKS) and not plain_gemm

    assert names and not [n for n in names if cudnn_like(n) or "tf32" in n.lower()], names
    if case != "srmr":
        assert any("conv_depthwise" in n for n in names), names
    args = _slice_signals(case)
    cudnn = torch.backends.cudnn
    before = cudnn.allow_tf32
    try:
        cudnn.allow_tf32 = True
        got = _slice_call(case)(*(t.to(card) for t in args))
        assert cudnn.allow_tf32 is True
    finally:
        cudnn.allow_tf32 = before
    want = _slice_call(case)(*args)
    rtol = 1e-4 if case == "srmr" else 1e-5
    torch.testing.assert_close(got.cpu(), want, rtol=rtol, atol=1e-5)


def _separation_batch(seed: int, rows: int = 4, samples: int = 16000):
    g = torch.Generator().manual_seed(seed)
    target = torch.randn(rows, 2, samples, generator=g).cumsum(-1) / 50
    preds = target + 0.2 * target.flip(1) + 0.3 * torch.randn(rows, 2, samples, generator=g)
    return preds, target


def test_sdr_with_tf32_on_equals_tf32_off(card):
    """SDR's Toeplitz solve with TF32 turned on process-wide (it then solves in float64 on
    the card) equals the same solve with it off within SDR's 1e-2 dB, and the CPU; the
    flag is never written."""
    from torchmetrics_tpu_torch.functional.audio import signal_distortion_ratio

    preds, target = _separation_batch(50)
    off = signal_distortion_ratio(preds.to(card), target.to(card)).cpu()
    matmul = torch.backends.cuda.matmul
    before = matmul.fp32_precision
    try:
        matmul.fp32_precision = "tf32"
        on = signal_distortion_ratio(preds.to(card), target.to(card)).cpu()
        assert matmul.fp32_precision == "tf32"
    finally:
        matmul.fp32_precision = before
    torch.testing.assert_close(on, off, rtol=0, atol=1e-2)
    torch.testing.assert_close(off, signal_distortion_ratio(preds, target), rtol=0, atol=1e-2)


def test_captured_stoi_and_si_sdr_updates_equal_their_eager_ones_bitwise(card):
    from torchmetrics_tpu_torch import audio as ta

    cases = {"si_sdr": lambda **kw: ta.ScaleInvariantSignalDistortionRatio(**kw),
             "stoi": lambda **kw: ta.ShortTimeObjectiveIntelligibility(16000, **kw)}
    for name, make in cases.items():
        eager, captured = make(device=card), make(device=card, jit_update=True)
        for seed in range(3):
            preds, target = _separation_batch(60 + seed)
            preds, target = preds[:, 0].to(card), target[:, 0].to(card)
            eager.update(preds, target)
            captured.update(preds, target)
        for key in ("sum_score", "total"):
            assert torch.equal(getattr(eager, key), getattr(captured, key)), (name, key)
        info = captured._jitted_update.cache_info()
        assert info["misses"] == 1 and info["replays"] >= 2, (name, info)


def test_pit_under_capture_takes_the_exhaustive_search(card):
    """Three speakers: the eager update assigns on the host (``linear_sum_assignment``), a
    captured one cannot read back to the host and searches every permutation on the card;
    both find the same best permutation's score."""
    from torchmetrics_tpu_torch import audio as ta
    from torchmetrics_tpu_torch.functional.audio import scale_invariant_signal_distortion_ratio

    eager = ta.PermutationInvariantTraining(scale_invariant_signal_distortion_ratio, device=card)
    captured = ta.PermutationInvariantTraining(scale_invariant_signal_distortion_ratio, device=card,
                                               jit_update=True)
    g = torch.Generator().manual_seed(70)
    for _ in range(3):
        target = torch.randn(4, 3, 8000, generator=g)
        preds = (target + 0.3 * torch.randn(4, 3, 8000, generator=g))[:, [2, 0, 1]]
        eager.update(preds.to(card), target.to(card))
        captured.update(preds.to(card), target.to(card))
    assert torch.equal(eager.total, captured.total)
    torch.testing.assert_close(captured.sum_score, eager.sum_score, rtol=1e-6, atol=1e-4)
    assert captured._jitted_update.cache_info()["replays"] >= 2


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("norm", [False, True])
def test_srmr_on_the_card_equals_the_cpu(card, norm, fast):
    from torchmetrics_tpu_torch.functional.audio import speech_reverberation_modulation_energy_ratio as srmr

    g = torch.Generator().manual_seed(80 + norm + 2 * fast)
    t = torch.arange(24000) / 16000
    x = torch.randn(3, 24000, generator=g) * (0.6 + 0.4 * torch.sin(2 * torch.pi * 4 * t))
    got = srmr(x.to(card), 16000, norm=norm, fast=fast)
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), srmr(x, 16000, norm=norm, fast=fast), rtol=1e-4, atol=0)


# ---------------------------------------------------------- detection, ONNX and DNSMOS


def _detections(seed: int, images: int = 10, classes: int = 5, masks: bool = False):
    """Per-image dicts of jittered ground truths and false positives (scores with ties,
    one zero-area pair), on the CPU; ellipse masks of 24 x 32 with ``masks``."""
    g = torch.Generator().manual_seed(seed)
    preds, target = [], []
    for _ in range(images):
        ng, nd = int(torch.randint(0, 8, (1,), generator=g)), int(torch.randint(0, 30, (1,), generator=g))
        xy = torch.rand(ng, 2, generator=g) * 20
        gb = torch.cat([xy, xy + torch.rand(ng, 2, generator=g) * 12 + 1], 1)
        gl = torch.randint(0, classes, (ng,), generator=g)
        src = torch.randint(0, max(ng, 1), (nd,), generator=g)
        db = gb[src] + torch.randn(nd, 4, generator=g) if ng else torch.rand(nd, 4, generator=g) * 20
        db = torch.cat([torch.minimum(db[:, :2], db[:, 2:]), torch.maximum(db[:, :2], db[:, 2:])], 1)
        dl = torch.where(torch.rand(nd, generator=g) < 0.7, gl[src] if ng else 0,
                         torch.randint(0, classes, (nd,), generator=g))
        if nd and ng:
            db[0], gb[0] = torch.tensor([5.0, 5, 5, 5]), torch.tensor([5.0, 5, 5, 5])
        p = {"boxes": db, "scores": torch.round(torch.rand(nd, generator=g), decimals=1), "labels": dl}
        t = {"boxes": gb, "labels": gl}
        if masks:
            yy, xx = torch.meshgrid(torch.arange(24) + 0.5, torch.arange(32) + 0.5, indexing="ij")

            def ellipses(b):
                c, half = (b[:, :2] + b[:, 2:]) / 2, ((b[:, 2:] - b[:, :2]) / 2).clamp(min=0.5)
                return ((xx - c[:, None, None, 0]) / half[:, None, None, 0]) ** 2 + \
                    ((yy - c[:, None, None, 1]) / half[:, None, None, 1]) ** 2 <= 1

            p["masks"], t["masks"] = ellipses(db), ellipses(gb)
        preds.append(p)
        target.append(t)
    return preds, target


def _equal_results(got, want, where: str = "") -> None:
    """Mean AP's surfaces, ``ious`` and ``classes`` bitwise, the summaries within 1e-6."""
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            _equal_results(got[k], want[k], f"{where}.{k}")
        return
    got = got.cpu()
    assert got.dtype == want.dtype and got.shape == want.shape, where
    exact = any(k in where for k in (".precision", ".recall", ".scores", ".classes", ".ious"))
    if exact or not want.is_floating_point():
        assert torch.equal(torch.nan_to_num(got, nan=-7.0), torch.nan_to_num(want, nan=-7.0)), where
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6, msg=where)


MAP_CARD_CASES = {
    "bbox_list": {"extended_summary": True, "class_metrics": True},
    "bbox_micro": {"average": "micro", "class_metrics": True},
    "bbox_buffered": {"buffer_capacity": 400, "extended_summary": True},
    "segm_list": {"iou_type": "segm", "extended_summary": True},
    "segm_buffered": {"iou_type": "segm", "buffer_capacity": 400, "mask_shape": (24, 32), "extended_summary": True},
}


@pytest.mark.parametrize("case", sorted(MAP_CARD_CASES))
def test_mean_ap_on_the_card_equals_the_cpu(card, case):
    """The batched matcher and accumulation on the card equal the CPU's run exactly (every
    IoU, surface and class), the summaries within 1e-6; no K1-K5 launch."""
    from torchmetrics_tpu_torch.detection import MeanAveragePrecision

    kwargs = MAP_CARD_CASES[case]
    preds, target = _detections(90, masks=case.startswith("segm"))
    on_card = MeanAveragePrecision(device=card, **kwargs)
    on_cpu = MeanAveragePrecision(device="cpu", **kwargs)
    kernels.reset_launch_counts()
    for a in range(0, len(preds), 4):
        on_card.update([{k: v.to(card) for k, v in p.items()} for p in preds[a:a + 4]],
                       [{k: v.to(card) for k, v in t.items()} for t in target[a:a + 4]])
        on_cpu.update(preds[a:a + 4], target[a:a + 4])
    got = on_card.compute()
    assert not any(kernels.LAUNCHES.values())
    _equal_results(got, on_cpu.compute())


def test_a_panoptic_update_launches_k4_exactly_once(card):
    """One bincount launch an update of either panoptic metric, whatever the batch; the
    counts equal the CPU's exactly, ``iou_sum`` within 1e-6 relative."""
    from torchmetrics_tpu_torch.detection import ModifiedPanopticQuality, PanopticQuality

    g = torch.Generator().manual_seed(91)
    cats = torch.tensor([0, 1, 3, 6, 7, 255])
    for cls in (PanopticQuality, ModifiedPanopticQuality):
        on_card = cls({0, 1, 3}, {6, 7}, allow_unknown_preds_category=True, device=card)
        on_cpu = cls({0, 1, 3}, {6, 7}, allow_unknown_preds_category=True, device="cpu")
        for batch in (1, 3, 8):
            cat = cats[torch.randint(0, 6, (batch, 40, 48), generator=g)].repeat_interleave(2, 1)
            maps = torch.stack([cat, torch.randint(0, 4, cat.shape, generator=g)], -1)
            preds = maps.clone()
            flip = torch.rand(cat.shape, generator=g) < 0.2
            preds[flip] = maps.flip(1)[flip]
            kernels.reset_launch_counts()
            on_card.update(preds.to(card), maps.to(card))
            assert kernels.LAUNCHES["bincount"] == 1 and sum(kernels.LAUNCHES.values()) == 1
            on_cpu.update(preds, maps)
        for name in ("true_positives", "false_positives", "false_negatives"):
            assert torch.equal(getattr(on_card, name).cpu(), getattr(on_cpu, name))
        torch.testing.assert_close(on_card.iou_sum.cpu(), on_cpu.iou_sum, rtol=1e-6, atol=0)
        torch.testing.assert_close(on_card.compute().cpu(), on_cpu.compute(), rtol=0, atol=1e-6)


def _onnx_cases() -> dict:
    """Graphs of every product and convolution route of the executor, with their input."""
    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import onnx_model as _model
    from chip_smoke import onnx_node as _node

    r = np.random.RandomState(92)
    f = np.float32
    return {
        "conv2d_groups_pads_strides": (_model(
            [_node("Conv", ["x", "w", "b"], ["c"], pads=[1, 0, 2, 1], strides=[2, 1], dilations=[1, 2], group=2),
             _node("MaxPool", ["c"], ["y"], kernel_shape=[2, 2], strides=[2, 2])],
            {"w": r.randn(8, 2, 3, 3).astype(f), "b": r.randn(8).astype(f)}, ["x"], ["y"]),
            r.randn(3, 4, 33, 41).astype(f)),
        "conv1d_strided": (_model(
            [_node("Conv", ["x", "w", "b"], ["c"], strides=[160]),
             _node("AveragePool", ["c"], ["y"], kernel_shape=[3], strides=[2], pads=[1, 1])],
            {"w": r.randn(16, 1, 400).astype(f), "b": r.randn(16).astype(f)}, ["x"], ["y"]),
            r.randn(4, 1, 16160).astype(f)),
        "gemm_matmul": (_model(
            [_node("Gemm", ["x", "w", "b"], ["g"], transB=1, alpha=0.5),
             _node("MatMul", ["g", "m"], ["y"])],
            {"w": r.randn(64, 300).astype(f), "b": r.randn(64).astype(f), "m": r.randn(64, 32).astype(f)},
            ["x"], ["y"]), r.randn(50, 300).astype(f)),
    }


def _onnx_kernel_names(cases: list) -> list:
    """For each case, the device kernels of one executor forward on the card with cuDNN's
    and cuBLAS's TF32 flags on: the fullest of three traces."""
    from torch.profiler import ProfilerActivity, profile

    from torchmetrics_tpu_torch.convert.onnx_reader import parse_onnx
    from torchmetrics_tpu_torch.convert.onnx_torch import OnnxGraph

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    result = []
    for case in cases:
        model, x = _onnx_cases()[case]
        graph = parse_onnx(model)
        module = OnnxGraph(graph, graph["initializers"], device="cuda")
        xt = torch.from_numpy(x).cuda()
        module(xt)
        torch.cuda.synchronize()
        traces = []
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                module(xt)
                torch.cuda.synchronize()
            traces.append([e.key for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA and e.count])
        result.append(max(traces, key=len))
    return result


@pytest.fixture(scope="module")
def onnx_kernel_names() -> dict:
    """``_onnx_kernel_names`` of every case, traced in a new process."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    here = os.path.dirname(os.path.abspath(__file__))
    cases = sorted(_onnx_cases())
    code = ("import json, sys; sys.path[:0] = sys.argv[1:3]; import test_torch_cuda as t; "
            "print(json.dumps(t._onnx_kernel_names(json.loads(sys.argv[3]))))")
    done = subprocess.run([sys.executable, "-c", code, here, os.path.dirname(here), json.dumps(cases)],
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    return dict(zip(cases, json.loads(done.stdout.strip().splitlines()[-1])))


@pytest.mark.parametrize("case", ["conv1d_strided", "conv2d_groups_pads_strides", "gemm_matmul"])
def test_executor_convolutions_and_products_reach_no_tf32_or_cudnn_kernel(card, onnx_kernel_names, case):
    """The ONNX executor's convolutions (im2col and a grouped product) and products run in
    full float32 (float64 where a TF32 flag is on) with both TF32 flags on, off cuDNN, and
    equal the CPU within 1e-5 relative plus 1e-5 of the largest output; no flag is
    written."""
    from torchmetrics_tpu_torch.convert.onnx_reader import parse_onnx
    from torchmetrics_tpu_torch.convert.onnx_torch import OnnxGraph

    names = onnx_kernel_names[case]

    def convolution_or_tf32(name: str) -> bool:
        # cuBLAS's products (float32, or float64 where TF32 is on) share the xmma/sm90_
        # prefixes with cuDNN's convolutions; a convolution's kernels name it
        low = name.lower()
        return "tf32" in low or "cudnn" in low or "implicit_convolve" in low or \
            any(m in low for m in ("fprop", "dgrad", "wgrad", "conv2d", "convolution"))

    assert names and not [n for n in names if convolution_or_tf32(n)], names
    assert any("gemm" in n.lower() for n in names), names
    if case.startswith("conv"):
        assert any("im2col" in n for n in names), names
    model, x = _onnx_cases()[case]
    graph = parse_onnx(model)
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = (cudnn.allow_tf32, matmul.allow_tf32)
    try:
        cudnn.allow_tf32, matmul.allow_tf32 = True, True
        got = OnnxGraph(graph, graph["initializers"], device=card)(torch.from_numpy(x).to(card))[0]
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = before
    want = OnnxGraph(graph, graph["initializers"], device="cpu")(torch.from_numpy(x))[0]
    # the card multiplies in float64 here (TF32 on); TF32 would miss by ~1e-3 relative
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def test_dnsmos_on_the_card_equals_the_cpu(card, tmp_path, monkeypatch):
    """DNSMOS on fabricated P.808 and P.835-shaped graphs (a raw drop converted on first
    use, and a converted directory): the card's per-clip scores equal the CPU's within
    1e-4, at 16 kHz and from 8 kHz, plain and personalized."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke
    from torchmetrics_tpu_torch.functional.audio import dnsmos

    graphs = chip_smoke.dnsmos_graphs(seed=93)
    monkeypatch.setenv("TORCHMETRICS_TPU_DNSMOS_DIR", chip_smoke.dnsmos_dir(str(tmp_path / "dnsmos"), graphs))
    dnsmos._load_model.cache_clear()
    g = torch.Generator().manual_seed(93)
    try:
        for fs, samples, personalized in ((16000, 170000, False), (8000, 30000, True)):
            x = 0.1 * torch.randn(2, samples, generator=g)
            got = dnsmos.deep_noise_suppression_mean_opinion_score(x.to(card), fs, personalized)
            assert got.device.type == "cuda"
            want = dnsmos.deep_noise_suppression_mean_opinion_score(x, fs, personalized)
            torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    finally:
        dnsmos._load_model.cache_clear()


# ------------------------------------------------------------ model-based image

MODEL_CASES = ("inception", "alex", "vgg", "squeeze")


def _model_case(case: str, device) -> tuple:
    """The network of ``case`` (seeded random weights) on ``device`` and its CPU input:
    the FID extractor at its 2048 and logits taps on 3 uint8 images of 64 x 80 (resized
    to 299^2), or an LPIPS pyramid on 2 images of 3 x 96 x 112."""
    from torchmetrics_tpu_torch.functional.image._lpips_backbones import LpipsPyramid
    from torchmetrics_tpu_torch.image._inception_net import InceptionFeatureExtractor

    g = torch.Generator().manual_seed(MODEL_CASES.index(case))
    if case == "inception":
        ext = InceptionFeatureExtractor(feature=2048, device=device)
        ext.net.features_list = ("2048", "logits")
        x = torch.randint(0, 256, (3, 3, 64, 80), generator=g, dtype=torch.uint8)
        return (lambda imgs: ext.net(ext._preprocess(imgs))), x
    net = LpipsPyramid(case).init_random(g).to(device)
    return net, torch.rand(2, 3, 96, 112, generator=g) * 2 - 1


def _model_kernel_names(cases: list) -> list:
    """For each case, the device kernels of one forward on the card with cuDNN's and
    cuBLAS's TF32 flags on: the fullest of three traces."""
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    result = []
    for case in cases:
        fn, x = _model_case(case, "cuda")
        x = x.cuda()
        fn(x)
        torch.cuda.synchronize()
        traces = []
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn(x)
                torch.cuda.synchronize()
            traces.append([e.key for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA and e.count])
        result.append(max(traces, key=len))
    return result


@pytest.fixture(scope="module")
def model_kernel_names() -> dict:
    """``_model_kernel_names`` of every case, traced in a new process."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import json, sys; sys.path[:0] = sys.argv[1:3]; import test_torch_cuda as t; "
            "print(json.dumps(t._model_kernel_names(json.loads(sys.argv[3]))))")
    done = subprocess.run([sys.executable, "-c", code, here, os.path.dirname(here), json.dumps(list(MODEL_CASES))],
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-4000:]
    return dict(zip(MODEL_CASES, json.loads(done.stdout.strip().splitlines()[-1])))


@pytest.mark.parametrize("case", MODEL_CASES)
def test_inception_and_lpips_convolutions_reach_no_cudnn_or_tf32_kernel(card, model_kernel_names, case):
    """The FID Inception-v3's and each LPIPS backbone's convolutions run as im2col (none
    for a 1x1 kernel) and full-float32 products, off cuDNN, with both TF32 flags on
    (the products then multiply in float64), and the forward equals the CPU's within
    1e-4 of each output's largest magnitude; no flag is written."""
    names = model_kernel_names[case]
    low = [n.lower() for n in names]
    assert names and not [n for n in low if "tf32" in n or "cudnn" in n or "implicit_convolve" in n
                          or any(m in n for m in ("fprop", "dgrad", "wgrad", "conv2d", "convolution"))], names
    assert any("gemm" in n for n in low) and any("im2col" in n for n in low), names
    fn, x = _model_case(case, card)
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = (cudnn.allow_tf32, matmul.allow_tf32)
    try:
        cudnn.allow_tf32, matmul.allow_tf32 = True, True
        got = fn(x.to(card))
        assert (cudnn.allow_tf32, matmul.allow_tf32) == (True, True)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = before
    cpu_fn, _ = _model_case(case, "cpu")
    want = cpu_fn(x)
    pairs = zip(got.values(), want.values()) if isinstance(want, dict) else zip(got, want)
    for g, w in pairs:
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-4 * float(w.abs().max()))


def test_inception_features_and_lpips_on_the_card_equal_the_cpu(card, tmp_path):
    """Every tap of the FID extractor (uint8 and ``normalize``) within 1e-4 of its largest
    magnitude, and LPIPS of each backbone through the class within 1e-5 relative."""
    from torchmetrics_tpu_torch.convert import convert_lpips_backbone
    from torchmetrics_tpu_torch.functional.image._lpips_backbones import LpipsPyramid
    from torchmetrics_tpu_torch.image import LearnedPerceptualImagePatchSimilarity
    from torchmetrics_tpu_torch.image._inception_net import InceptionFeatureExtractor

    g = torch.Generator().manual_seed(8)
    taps = ("64", "192", "768", "2048", "logits", "logits_unbiased")
    for normalize, x in ((False, torch.randint(0, 256, (2, 3, 50, 41), generator=g, dtype=torch.uint8)),
                         (True, torch.rand(2, 3, 299, 299, generator=g))):
        out = {}
        for device in (card, "cpu"):
            ext = InceptionFeatureExtractor(feature=2048, normalize=normalize, device=device)
            ext.net.features_list = taps
            out[str(device)] = ext.net(ext._preprocess(x.to(device)))
        for tap in taps:
            want = out["cpu"][tap]
            torch.testing.assert_close(out[str(card)][tap].cpu(), want, rtol=0, atol=1e-4 * float(want.abs().max()))
    img1, img2 = torch.rand(2, 3, 128, 128, generator=g) * 2 - 1, torch.rand(2, 3, 128, 128, generator=g) * 2 - 1
    for seed, net in enumerate(("alex", "vgg", "squeeze")):
        torch.save(LpipsPyramid(net).init_random(torch.Generator().manual_seed(seed)).state_dict(), tmp_path / "b.pth")
        path = convert_lpips_backbone(str(tmp_path / "b.pth"), net, str(tmp_path / f"{net}.npz"))
        values = []
        for device in (card, "cpu"):
            metric = LearnedPerceptualImagePatchSimilarity(net_type=net, weights_path=path, device=device)
            metric.update(img1, img2)
            assert metric.feature_fn.features[next(iter(metric.feature_fn.features))].weight.device.type == \
                torch.device(device).type
            values.append(float(metric.compute()))
        assert abs(values[0] - values[1]) <= 1e-5 * abs(values[1]), (net, values)


def test_an_fid_update_launches_no_custom_kernel(card):
    """The Inception family's path runs no K1-K5: an FID update and ``compute`` on the
    card count no launch and trace no kernel of theirs."""
    from torch.profiler import ProfilerActivity, profile

    from torchmetrics_tpu_torch.image import FrechetInceptionDistance

    fid = FrechetInceptionDistance(feature=64, device=card)
    imgs = torch.randint(0, 256, (4, 3, 32, 32), generator=torch.Generator().manual_seed(2), dtype=torch.uint8)
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fid.update(imgs.to(card), real=True)
        fid.update(imgs.flip(0).to(card), real=False)
        value = fid.compute()
        torch.cuda.synchronize()
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES
    names = [e.key for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert not [n for n in names if any(k in n for k in ("confusion_matrix_", "curve_search", "curve_compare",
                                                         "bincount_", "ssim_moments"))], names
    assert torch.isfinite(value) and value.device.type == "cuda"
