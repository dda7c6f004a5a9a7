"""The port on the card: CUDA kernels against their plain versions, metrics on the card
against the same metrics on the CPU.

Every test here needs an NVIDIA GPU and skips without one (the CUDA kernels have no
CPU mode). The file imports no JAX, so on a machine with a card it runs without the
suite's JAX conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

from __future__ import annotations

import ctypes
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
