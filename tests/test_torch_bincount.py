"""The weighted-bincount and bincount kernels' plain versions, and the port's
``_bincount``/``_flexible_bincount``, held against the JAX package.

On the CPU each wrapper runs its plain PyTorch version. These tests hold it against
the Pallas kernels in interpret mode and against the XLA one-hot contraction, on the
edge cases: empty input, all-zero weights, indices below 0 and at or above C, bin
counts that are not a multiple of 128, and non-finite weights. Inputs come from a
numpy seed. Count rows (0/1 weights) and the int32 bincounts are compared exactly;
float rows at ``FLOAT_RTOL``, because JAX sums them in float32 in the order of its
dot product while the port sums in float64 and rounds once. The CUDA kernels
themselves run only on a card: ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.experimental.pallas  # noqa: E402,F401
import jax.numpy as jnp  # noqa: E402

from torchmetrics_tpu.ops.pallas_kernels import bincount_pallas, weighted_bincount_pallas  # noqa: E402

# Pallas registers its TPU lowering rules when it is first imported, which fails once
# the process has dropped JAX's TPU platform (``tests/test_doctests.py`` imports the JAX
# package's ``convert/__main__.py``, which drops it). Importing it here, while every
# test file is collected, keeps the interpret-mode references below working whichever
# files a test worker ran before this one.
from torchmetrics_tpu.utils.data import _bincount as jax_bincount  # noqa: E402
from torchmetrics_tpu.utils.data import _flexible_bincount as jax_flexible_bincount  # noqa: E402
from torchmetrics_tpu_torch.ops import kernels  # noqa: E402
from torchmetrics_tpu_torch.utils.data import _bincount, _flexible_bincount  # noqa: E402

FLOAT_RTOL = 1e-5


def _case(n: int, k: int, c: int, seed: int, zero: float = 0.2, out_of_range: float = 0.1,
          nonfinite: bool = False, counts: bool = False):
    """int32 indices with some outside [0, C); float32 [K, N] weights with some zeros
    (0/1 weights when ``counts``), and optionally a NaN and an inf in two rows."""
    rng = np.random.RandomState(seed)
    x = rng.randint(0, c, n).astype(np.int32)
    if n:
        bad = rng.rand(n) < out_of_range
        x[bad] = rng.choice([-1, -9, c, c + 5, c + 200], bad.sum())
    w = (rng.rand(k, n) >= 0.5).astype(np.float32) if counts else rng.rand(k, n).astype(np.float32)
    w[rng.rand(k, n) < zero] = 0.0
    if nonfinite and n:
        w[0, n // 2] = np.nan
        w[k - 1, n // 3] = np.inf
    return x, w


def _xla_one_hot(x: np.ndarray, w: np.ndarray, c: int) -> np.ndarray:
    """The one-hot contraction of the JAX package's XLA paths, for K rows."""
    one_hot = jax.nn.one_hot(jnp.asarray(x), c, dtype=jnp.float32)
    return np.asarray(jnp.einsum("kn,nc->kc", jnp.asarray(w), one_hot))


WEIGHTED_CASES = {
    "k1_c15": dict(n=1000, k=1, c=15),
    "k3_c15": dict(n=1000, k=3, c=15),
    "k3_c1": dict(n=300, k=3, c=1),
    "k1_c200": dict(n=2000, k=1, c=200),
    "k3_c200": dict(n=2000, k=3, c=200),
    "k3_c15_counts": dict(n=1500, k=3, c=15, counts=True),
    "k1_c200_counts": dict(n=1500, k=1, c=200, counts=True),
    "empty": dict(n=0, k=3, c=15),
    "all_zero_weights": dict(n=500, k=3, c=15, zero=1.0),
    "all_out_of_range": dict(n=400, k=1, c=15, out_of_range=1.0),
    "nonfinite_k3_c15": dict(n=600, k=3, c=15, nonfinite=True),
    "nonfinite_k1_c200": dict(n=600, k=1, c=200, nonfinite=True),
}


@pytest.mark.parametrize("case", sorted(WEIGHTED_CASES))
def test_weighted_bincount_plain_matches_pallas_and_xla(case):
    kw = WEIGHTED_CASES[case]
    x, w = _case(seed=kw["n"] + kw["k"] + kw["c"], **kw)
    c = kw["c"]
    got = kernels.weighted_bincount(torch.from_numpy(x), torch.from_numpy(w), c)
    assert got.dtype == torch.float32 and got.shape == (kw["k"], c)

    pallas = np.asarray(weighted_bincount_pallas(jnp.asarray(x), jnp.asarray(w), c, interpret=True))
    xla = _xla_one_hot(x, w, c)
    for want in (pallas, xla):
        if kw.get("counts") or kw.get("zero") == 1.0:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=FLOAT_RTOL, atol=0)  # NaN where NaN
    if kw.get("nonfinite"):
        assert np.isnan(got.numpy()[0]).sum() >= c - 1  # the NaN reaches every other bin of its row


def test_weighted_bincount_rounds_a_float64_sum_once():
    # 2^24 + 1 + 1 in float32 steps is 2^24; the float64 sum rounds to 2^24 + 2
    x = torch.zeros(3, dtype=torch.int32)
    w = torch.tensor([[2.0**24, 1.0, 1.0]])
    assert kernels.weighted_bincount(x, w, 1).item() == 2.0**24 + 2


BINCOUNT_CASES = {
    "empty": (0, 5),
    "c1": (100, 1),
    "c100": (3000, 100),
    "c130_not_lane_multiple": (3000, 130),
    "c5000": (4000, 5000),
}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", sorted(BINCOUNT_CASES))
def test_bincount_plain_matches_pallas(case, masked):
    n, c = BINCOUNT_CASES[case]
    x, w = _case(n, 1, c, seed=n + c)
    valid = w[0] > 0.5
    got = kernels.bincount(torch.from_numpy(x), torch.from_numpy(valid) if masked else None, c)
    assert got.dtype == torch.int32 and got.shape == (c,)
    want = bincount_pallas(jnp.asarray(x), jnp.asarray(valid) if masked else None, c, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (n, minlength): the broadcast-compare path (minlength <= 64), the one-hot path below
# the size gate, and the chunked one-hot path above it
JAX_BINCOUNT_CASES = {"compare_c5": (500, 5), "compare_c64": (2000, 64), "one_hot_c100": (2000, 100),
                      "chunked_c5000": (1000, 5000), "empty": (0, 7)}


def _laid_out(x: np.ndarray, layout: str, seed: int) -> torch.Tensor:
    """``x`` as the port receives it: "int32" as it is; "int64_wide" as int64 plus
    multiples of 2^32 (JAX, 64-bit types off, keeps the low 32 bits); "offset_<k>" a view
    that starts k elements into a larger buffer (not 16-byte aligned); "int64_offset_1"
    both; "strided" every other element of a buffer (not contiguous)."""
    rng = np.random.RandomState(seed)
    junk = rng.randint(-5, 5, 3).astype(x.dtype)
    if layout.startswith("int64"):
        x = x.astype(np.int64) + rng.choice([-2, -1, 0, 1, 3], x.shape[0]).astype(np.int64) * (1 << 32)
        junk = junk.astype(np.int64)
    if "offset" in layout:
        k = int(layout[-1])
        return torch.from_numpy(np.concatenate([junk[:k], x]))[k:]
    if layout == "strided":
        return torch.from_numpy(np.stack([x, np.resize(junk, x.shape[0])], axis=1))[:, 0]
    return torch.from_numpy(x)


BINCOUNT_LAYOUTS = ["int32", "int64_wide", "offset_1", "offset_3", "int64_offset_1", "strided"]


@pytest.mark.parametrize("layout", BINCOUNT_LAYOUTS)
@pytest.mark.parametrize("case", sorted(JAX_BINCOUNT_CASES))
def test_bincount_matches_jax(case, layout):
    n, c = JAX_BINCOUNT_CASES[case]
    x, _ = _case(n, 1, c, seed=n * 3 + c)
    got = _bincount(_laid_out(x, layout, seed=n), minlength=c)
    want = jax_bincount(jnp.asarray(x), minlength=c)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if layout != "int32":  # the int64 ids as the JAX kernel takes them (its entry keeps the low 32 bits)
        wide = _laid_out(x, layout, seed=n).numpy()
        np.testing.assert_array_equal(got.numpy(), np.asarray(bincount_pallas(jnp.asarray(wide), None, c,
                                                                              interpret=True)))
    with pytest.raises(ValueError, match="minlength"):
        _bincount(torch.from_numpy(x))


FLEXIBLE_LAYOUTS = {"int32": 0, "int64_beyond_int32": 3 << 32, "int64_below_int32": -(5 << 32), "offset_2": 0,
                    "strided": 0}


@pytest.mark.parametrize("layout", sorted(FLEXIBLE_LAYOUTS))
@pytest.mark.parametrize("offset, spread, n", [(0, 7, 300), (-40, 100, 5000), (1000, 3, 50), (5, 1, 20)])
def test_flexible_bincount_matches_jax(offset, spread, n, layout):
    rng = np.random.RandomState(n + spread)
    ids = (offset + rng.choice(np.arange(spread) * 3, n)).astype(np.int32)  # sparse, shuffled ids
    wide = ids.astype(np.int64) + FLEXIBLE_LAYOUTS[layout] if layout.startswith("int64") else ids
    x = _laid_out(wide, layout if layout in ("offset_2", "strided") else "int32", seed=n)
    got = _flexible_bincount(x)
    want = np.asarray(jax_flexible_bincount(jnp.asarray(wide)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == n


def test_bincount_wrappers_raise_on_other_devices():
    meta_x = torch.empty(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.weighted_bincount(meta_x, torch.empty((3, 8), device="meta"), 4)
    with pytest.raises(ValueError, match="one device"):
        kernels.bincount(meta_x, torch.ones(8, dtype=torch.bool), 4)
