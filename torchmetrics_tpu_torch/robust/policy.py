"""Update-guard error policies for the ``Metric`` runtime.

Counterpart of ``torchmetrics_tpu/robust/policy.py``. A policy decides what happens
when a batch fails inside ``Metric.update`` — non-finite inputs, shape or type
mismatches, or any exception raised by the subclass ``update`` body:

- ``raise``: guards run and failures raise (non-finite inputs raise
  :class:`UpdateGuardError`; update exceptions propagate). State is rolled back
  so a failed batch never leaves partial mutations behind.
- ``warn_skip``: the batch is dropped with a warning; accumulated state and the
  update count are exactly what a clean-batches-only run would produce.
- ``quarantine``: like ``warn_skip``, but the offending batch (host copies) and
  the failure reason are retained on ``metric.quarantined_batches``.

With **no policy configured** (the default) the update path is the unguarded one:
no input screening (screening reads every batch back to the host), exceptions
propagate. Policies resolve per metric first (``Metric(..., error_policy=
"warn_skip")``), then from the process-global default (:func:`set_error_policy` /
the :func:`error_policy` context manager).
"""

from __future__ import annotations

from contextlib import contextmanager
from enum import Enum
from typing import Any, Optional, Union

import numpy as np
import torch

__all__ = [
    "ErrorPolicy",
    "UpdateGuardError",
    "coerce_policy",
    "effective_policy",
    "error_policy",
    "first_nonfinite",
    "get_error_policy",
    "nonfinite_step_indices",
    "set_error_policy",
]


class ErrorPolicy(str, Enum):
    """What a metric does with a batch that fails its update guards."""

    RAISE = "raise"
    WARN_SKIP = "warn_skip"
    QUARANTINE = "quarantine"


class UpdateGuardError(ValueError):
    """Raised (under the ``raise`` policy) when update input validation fails."""


PolicyLike = Union[None, str, ErrorPolicy]

_GLOBAL_POLICY: Optional[ErrorPolicy] = None


def coerce_policy(value: PolicyLike) -> Optional[ErrorPolicy]:
    """Normalize ``None`` / strings / :class:`ErrorPolicy` to an optional policy."""
    if value is None:
        return None
    try:
        return ErrorPolicy(value)
    except ValueError:
        raise ValueError(
            f"Invalid error policy {value!r}. Expected one of"
            f" {[p.value for p in ErrorPolicy]} or None."
        ) from None


def set_error_policy(policy: PolicyLike) -> Optional[ErrorPolicy]:
    """Set the process-global error policy; returns the previous one.

    ``None`` restores the unconfigured default (the unguarded path).
    """
    global _GLOBAL_POLICY
    previous = _GLOBAL_POLICY
    _GLOBAL_POLICY = coerce_policy(policy)
    return previous


def get_error_policy() -> Optional[ErrorPolicy]:
    """The process-global error policy (``None`` when unconfigured)."""
    return _GLOBAL_POLICY


@contextmanager
def error_policy(policy: PolicyLike):
    """Scoped global error policy: ``with error_policy("warn_skip"): ...``."""
    previous = set_error_policy(policy)
    try:
        yield
    finally:
        set_error_policy(previous)


def effective_policy(metric_policy: PolicyLike) -> Optional[ErrorPolicy]:
    """Resolve a metric's policy: per-metric setting wins, else the global one."""
    resolved = coerce_policy(metric_policy)
    return resolved if resolved is not None else _GLOBAL_POLICY


def _floating(value: Any) -> bool:
    if isinstance(value, torch.Tensor):
        return value.is_floating_point() or value.is_complex()
    return np.issubdtype(value.dtype, np.floating) or np.issubdtype(value.dtype, np.complexfloating)


def _leaf_nonfinite(value: Any) -> bool:
    """True when ``value`` is a floating tensor or array holding non-finite entries.

    Reads a device tensor's verdict back to the host — only ever called on the
    guarded (non-default) update path.
    """
    if value is None or isinstance(value, (bool, int, str, bytes)):
        return False
    if isinstance(value, float):
        return not np.isfinite(value)
    if isinstance(value, torch.Tensor):
        return _floating(value) and not bool(torch.isfinite(value).all())
    if isinstance(value, np.ndarray):
        return _floating(value) and not bool(np.isfinite(value).all())
    return False


def first_nonfinite(args: tuple, kwargs: dict) -> Optional[str]:
    """Name/position of the first update argument holding non-finite values.

    Scans positional and keyword arguments, descending one level into
    lists/tuples (the common ``update(list_of_tensors)`` signature). Returns
    ``None`` when everything is finite.
    """

    def _scan(label: str, value: Any) -> Optional[str]:
        if isinstance(value, (list, tuple)):
            for i, item in enumerate(value):
                if _leaf_nonfinite(item):
                    return f"{label}[{i}]"
            return None
        return label if _leaf_nonfinite(value) else None

    for i, value in enumerate(args):
        hit = _scan(f"positional argument {i}", value)
        if hit is not None:
            return hit
    for name, value in kwargs.items():
        hit = _scan(f"argument {name!r}", value)
        if hit is not None:
            return hit
    return None


def nonfinite_step_indices(stacked_leaves) -> list:
    """Leading-axis indices of a stacked chunk's steps holding non-finite values.

    The streaming engine screens a whole fused chunk with ONE host sync instead of
    one per batch: each leaf carries a leading step axis, non-finite entries are
    reduced per step on the leaf's device, the per-step flags of every leaf are
    combined there, and one read brings them to the host. Non-floating leaves are
    skipped, as :func:`first_nonfinite` skips them.
    """
    flags = None
    for leaf in stacked_leaves:
        if not isinstance(leaf, torch.Tensor) or leaf.ndim == 0 or not _floating(leaf):
            continue
        bad = ~torch.isfinite(leaf.reshape(leaf.shape[0], -1)).all(dim=1)
        flags = bad if flags is None else flags | bad.to(flags.device)
    if flags is None:
        return []
    return [int(i) for i in torch.nonzero(flags).reshape(-1).tolist()]
