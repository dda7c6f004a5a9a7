"""Shared numeric helpers.

Counterpart of ``torchmetrics_tpu/utils/compute.py``, cut to what the slice calls.
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
