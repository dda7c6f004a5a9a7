"""Rank-zero logging helpers.

Counterpart of ``torchmetrics_tpu/utils/prints.py``. The rank comes from
``torch.distributed`` when it is initialised, else from the usual launcher
environment variables; a single process is rank zero.
"""

from __future__ import annotations

import os
import warnings
from functools import wraps
from typing import Any, Callable

import torch


def _get_rank() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank()
    for env in ("RANK", "LOCAL_RANK"):
        if env in os.environ:
            try:
                return int(os.environ[env])
            except ValueError:
                pass
    return 0


def rank_zero_only(fn: Callable) -> Callable:
    """Run ``fn`` only on rank 0."""

    @wraps(fn)
    def wrapped(*args: Any, **kwargs: Any) -> Any:
        if _get_rank() == 0:
            return fn(*args, **kwargs)
        return None

    return wrapped


@rank_zero_only
def rank_zero_warn(message: str, *args: Any, **kwargs: Any) -> None:
    kwargs.setdefault("stacklevel", 5)
    warnings.warn(message, *args, **kwargs)
