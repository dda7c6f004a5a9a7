"""Shared numeric helpers.

Counterpart of ``torchmetrics_tpu/utils/compute.py``, cut to what the slices call, and
the full-float32 matmul that stands for the JAX package's ``Precision.HIGHEST``.
"""

from __future__ import annotations

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


def _cuda_matmul_precision() -> str:
    """The float32 precision cuBLAS matmuls run at: ``torch.backends.cuda.matmul``'s
    ``fp32_precision``, or the process-wide ``torch.backends.fp32_precision`` where that
    reads ``"none"`` (inherit); ``"ieee"`` where both do. Only read, never written."""
    precision = torch.backends.cuda.matmul.fp32_precision
    if precision == "none":
        precision = getattr(torch.backends, "fp32_precision", "none")
    return "ieee" if precision == "none" else precision


def _matmul_full_float32(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` in full float32, as the JAX package's ``Precision.HIGHEST``.

    ``torch.matmul`` takes no precision argument, and the setting is the process's, so
    this writes none: where matmuls run in IEEE float32 (PyTorch's default) it is
    ``torch.matmul``; where a caller has turned TF32 (or lower) on, it multiplies in
    float64 and rounds once to float32, which no other thread's product notices. On an
    H100, FP64 on the tensor cores peaks near FP32 without TF32."""
    if _cuda_matmul_precision() == "ieee":
        return torch.matmul(a, b)
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.result_type(a, b))
