"""Shared numeric helpers.

Counterpart of ``torchmetrics_tpu/utils/compute.py``, cut to what the slices call, and
the full-float32 matmul that stands for the JAX package's ``Precision.HIGHEST``.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

Tensor = torch.Tensor


def _auc_compute_without_check(x: Tensor, y: Tensor, direction: float = 1.0, axis: int = -1) -> Tensor:
    """Area under the curve by the trapezoidal rule (inputs assumed sorted along x).

    The same arithmetic as ``jnp.trapezoid``: half the sum of ``dx * (y[1:] + y[:-1])``.
    """
    x = torch.movedim(x, axis, -1)
    y = torch.movedim(y, axis, -1)
    area = 0.5 * (torch.diff(x, dim=-1) * (y[..., 1:] + y[..., :-1])).sum(-1)
    return (area * direction).to(torch.float32)


@contextmanager
def _full_float32_matmul():
    """``torch.matmul`` in full float32 (no TF32) inside the block, as the JAX package's
    ``Precision.HIGHEST``; the process-wide setting is restored after.

    Not thread-safe: the setting is the process's, so a matmul that another thread runs
    inside the block also runs without TF32, and a change that another thread makes to
    the setting inside the block is undone on the way out."""
    matmul = torch.backends.cuda.matmul
    before = matmul.fp32_precision
    matmul.fp32_precision = "ieee"
    try:
        yield
    finally:
        matmul.fp32_precision = before


def _matmul_full_float32(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` in full float32 (``_full_float32_matmul``)."""
    with _full_float32_matmul():
        return torch.matmul(a, b)
