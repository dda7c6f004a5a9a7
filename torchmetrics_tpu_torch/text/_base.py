"""Shared base of the string-input text metrics.

Counterpart of ``torchmetrics_tpu/text/_base.py``.
"""

from __future__ import annotations

from typing import Any

from torchmetrics_tpu_torch.core.metric import Metric


class _TextMetric(Metric):
    """Metric whose update consumes Python strings.

    Tokenising cannot be captured into a CUDA graph, so the update runs eagerly
    (``jit_update=False``, as in JAX); the counter states are still tensors on the
    metric's device and sync across ranks like any other metric's.
    """

    def __init__(self, **kwargs: Any) -> None:
        kwargs.setdefault("jit_update", False)
        super().__init__(**kwargs)
