"""Deterministic fault injection for the robustness test harness.

Counterpart of ``torchmetrics_tpu/robust/faults.py``. Context managers arm faults
at the three seams the fault-tolerance layer guards; the runtime consults this
module at exactly those seams, so injected faults travel the same code paths real
ones would:

- :func:`inject_nan_updates` — replace floating-point update arguments with
  NaNs on selected update calls (``Metric._wrapped_update`` applies it before
  the guards, so a NaN burst hits the non-finite detector like real bad data).
- :func:`inject_collective_fault` — make the next N guarded eager collectives
  raise, or hang until the guard's timeout. The port's guard around a
  collective (``robust/degraded``) comes with the robust plane; until then the
  plan is armed and consumed by :func:`next_collective_fault` alone.
- :func:`inject_download_fault` — truncate or corrupt the next N fetched
  payloads before validation. The port's fetcher (``robust/retry``) comes with
  the robust plane; :func:`corrupt_download` applies the plan to a payload.

Everything is counter-based and deterministic: no randomness, no wall-clock
dependence (the only real wait is an injected "hang" parking on the guard's —
test-chosen, millisecond — timeout). Faults are process-global and cleared on
context exit; nesting different fault kinds is fine, nesting the same kind is
last-one-wins.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "collective_faults_active",
    "corrupt_download",
    "inject_collective_fault",
    "inject_download_fault",
    "inject_nan_updates",
    "next_collective_fault",
    "apply_update_fault",
    "update_faults_active",
]

# armed fault plans, keyed by seam; None = no fault
_PLANS: Dict[str, Optional[dict]] = {"update": None, "collective": None, "download": None}


# ------------------------------------------------------------------ update faults


@contextmanager
def inject_nan_updates(indices: Optional[Iterable[int]] = None, every: Optional[int] = None):
    """NaN-ify update arguments on selected calls within this context.

    ``indices`` selects 0-based update-call indices (counted per context entry);
    ``every=k`` selects every k-th call instead. With neither, every call is hit.
    """
    plan = {"seen": 0, "indices": None if indices is None else set(indices), "every": every}
    _PLANS["update"] = plan
    try:
        yield plan
    finally:
        _PLANS["update"] = None


def update_faults_active() -> bool:
    return _PLANS["update"] is not None


def _nanify(value: Any):
    if isinstance(value, tuple) and hasattr(value, "_fields"):  # NamedTuple batches
        return type(value)(*(_nanify(v) for v in value))
    if isinstance(value, (list, tuple)):
        return type(value)(_nanify(v) for v in value)
    if isinstance(value, torch.Tensor) and value.is_floating_point():
        return torch.full_like(value, float("nan"))
    if isinstance(value, np.ndarray) and np.issubdtype(value.dtype, np.floating):
        return np.full_like(value, np.nan)
    if isinstance(value, float):
        return float("nan")
    return value


def apply_update_fault(args: tuple, kwargs: dict) -> Tuple[tuple, dict]:
    """Apply the armed NaN-burst plan to one update call's arguments."""
    plan = _PLANS["update"]
    if plan is None:
        return args, kwargs
    index = plan["seen"]
    plan["seen"] = index + 1
    if plan["indices"] is not None:
        hit = index in plan["indices"]
    elif plan["every"] is not None:
        hit = index % plan["every"] == 0
    else:
        hit = True
    if not hit:
        return args, kwargs
    return tuple(_nanify(a) for a in args), {k: _nanify(v) for k, v in kwargs.items()}


# -------------------------------------------------------------- collective faults


@contextmanager
def inject_collective_fault(mode: str = "raise", times: int = 1):
    """Make the next ``times`` guarded eager collectives fail.

    ``mode="raise"`` fails the attempt; ``mode="hang"`` parks the attempt until
    the guard's timeout expires (so the timeout machinery itself is exercised). Subsequent attempts beyond ``times``
    run the real collective — arming ``times=1`` with ``retries>=1`` models a
    transient link failure that recovers on retry.
    """
    if mode not in ("raise", "hang"):
        raise ValueError(f"Expected `mode` to be 'raise' or 'hang', got {mode!r}")
    plan = {"mode": mode, "remaining": int(times)}
    _PLANS["collective"] = plan
    try:
        yield plan
    finally:
        _PLANS["collective"] = None


def collective_faults_active() -> bool:
    plan = _PLANS["collective"]
    return plan is not None and plan["remaining"] > 0


def next_collective_fault() -> Optional[str]:
    """Consume one armed collective fault; returns its mode or ``None``."""
    plan = _PLANS["collective"]
    if plan is None or plan["remaining"] <= 0:
        return None
    plan["remaining"] -= 1
    return plan["mode"]


# ---------------------------------------------------------------- download faults


@contextmanager
def inject_download_fault(mode: str = "truncate", times: int = 1, corruptor: Optional[Callable[[bytes], bytes]] = None):
    """Corrupt the next ``times`` fetched payloads before validation.

    ``mode="truncate"`` halves the payload; ``mode="corrupt"`` flips its first
    byte (checksum mismatch with unchanged size); ``mode="custom"`` applies
    ``corruptor``. Later fetches pass through untouched, so a guarded fetch with
    retries recovers deterministically.
    """
    if mode not in ("truncate", "corrupt", "custom"):
        raise ValueError(f"Expected `mode` to be 'truncate', 'corrupt' or 'custom', got {mode!r}")
    if mode == "custom" and corruptor is None:
        raise ValueError("`corruptor` is required when mode='custom'")
    plan = {"mode": mode, "remaining": int(times), "corruptor": corruptor}
    _PLANS["download"] = plan
    try:
        yield plan
    finally:
        _PLANS["download"] = None


def corrupt_download(data: bytes) -> bytes:
    """Apply the armed download fault to one fetched payload."""
    plan = _PLANS["download"]
    if plan is None or plan["remaining"] <= 0:
        return data
    plan["remaining"] -= 1
    if plan["mode"] == "truncate":
        return data[: len(data) // 2]
    if plan["mode"] == "corrupt":
        return bytes([data[0] ^ 0xFF]) + data[1:] if data else data
    return plan["corruptor"](data)
