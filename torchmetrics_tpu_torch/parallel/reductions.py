"""Reduction vocabulary for metric states.

Counterpart of ``torchmetrics_tpu/parallel/reductions.py``: each tag says how a
state merges pairwise (``forward``'s reduce-state path) and how it reduces across
processes (``parallel/sync.py``).
"""

from __future__ import annotations

from enum import Enum
from typing import Any, Callable, Optional, Union

import torch

from torchmetrics_tpu_torch.core.buffer import MaskedBuffer
from torchmetrics_tpu_torch.utils.data import safe_divide


class Reduction(str, Enum):
    """How a state participates in cross-process sync and pairwise merge."""

    SUM = "sum"
    MEAN = "mean"
    MAX = "max"
    MIN = "min"
    CAT = "cat"
    # stack per-member states along a new leading axis; the metric's compute merges them
    GATHER = "gather"
    NONE = "none"

    @classmethod
    def from_arg(cls, fx: Union[str, Callable, None]) -> "Reduction":
        if fx is None:
            return cls.NONE
        if isinstance(fx, Reduction):
            return fx
        if isinstance(fx, str):
            try:
                return cls(fx)
            except ValueError as err:
                raise ValueError(
                    f"`dist_reduce_fx` must be one of {[m.value for m in cls]} or a callable, got {fx!r}"
                ) from err
        if callable(fx):
            # custom callables get CAT semantics (gather, then user-reduce)
            return cls.CAT
        raise ValueError(f"Unsupported `dist_reduce_fx`: {fx!r}")


def merge_states(
    old: Any, new: Any, reduction: Reduction, old_count, new_count, custom_fn: Optional[Callable] = None
) -> Any:
    """Pairwise-merge two state values under ``reduction``.

    Custom callables reduce a stack of [old, new]; NONE stacks tensors and joins lists.
    """
    if custom_fn is not None and reduction == Reduction.CAT and not isinstance(old, list):
        return custom_fn(torch.stack([old, new]))
    if reduction == Reduction.SUM:
        return old + new
    if reduction == Reduction.MEAN:
        return safe_divide(old * old_count + new * new_count, old_count + new_count)
    if reduction == Reduction.MAX:
        return torch.maximum(old, new)
    if reduction == Reduction.MIN:
        return torch.minimum(old, new)
    if reduction == Reduction.CAT:
        if isinstance(old, MaskedBuffer) and isinstance(new, MaskedBuffer):
            # the batch buffer's valid prefix is appended to the global buffer
            return old.append(new.values())
        if not isinstance(old, list) and not isinstance(new, list):
            return torch.cat([torch.atleast_1d(old), torch.atleast_1d(new)])
        old_list = old if isinstance(old, list) else [old]
        new_list = new if isinstance(new, list) else [new]
        return old_list + new_list
    if reduction in (Reduction.NONE, Reduction.GATHER):
        if isinstance(old, list) or isinstance(new, list):
            old_list = old if isinstance(old, list) else [old]
            new_list = new if isinstance(new, list) else [new]
            return old_list + new_list
        return torch.stack([old, new])
    raise ValueError(f"Unknown reduction {reduction}")
