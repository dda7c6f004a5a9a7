"""Task-dispatch base for classification wrapper classes.

Counterpart of ``torchmetrics_tpu/classification/base.py``: ``Accuracy(task="multiclass",
...)`` returns a ``MulticlassAccuracy`` from ``__new__``.
"""

from __future__ import annotations

from typing import Any

from torchmetrics_tpu_torch.core.metric import Metric


class _ClassificationTaskWrapper(Metric):
    """Base class for the wrapper classes that dispatch on ``task``."""

    def __new__(cls, *args: Any, **kwargs: Any):  # noqa: D102
        raise NotImplementedError(f"`__new__` method of {cls.__name__} should be implemented.")

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Never reached: ``__new__`` returns a task subclass."""
        raise NotImplementedError(f"{type(self).__name__} metric does not have an `update` method.")

    def compute(self) -> None:
        """Never reached: ``__new__`` returns a task subclass."""
        raise NotImplementedError(f"{type(self).__name__} metric does not have a `compute` method.")
