"""Timeout + bounded-retry guard for the eager cross-process collectives.

Counterpart of ``torchmetrics_tpu/robust/degraded.py``. Every collective of
``parallel/sync.py`` is a ``torch.distributed.all_gather``, which blocks until every
rank enters it — one preempted rank hangs the whole job until the process group's own
timeout. This module wraps those call sites:

- **Unconfigured (default)**: a direct call.
- **Configured** (:func:`configure_sync_guard` / :func:`sync_guard`): each
  collective runs in a daemon worker thread with a timeout; synchronously-raised
  transport failures get bounded retries. A timed-out collective's thread is
  *abandoned* (Python cannot cancel a blocked gloo or NCCL wait) — leaking one
  parked thread is the price of not hanging the job — and a timeout is **never
  retried**: the abandoned thread may still complete the collective with the
  other ranks later, so a retry could pair with the world's next collective and
  gather mismatched payloads. After a timeout the process group is out of step;
  give a world that can hang its own group and a short ``timeout=``.
- **Exhaustion**: :class:`CollectiveError` propagates to ``Metric.sync``, which
  degrades to local-only state with a loud warning and ``metric.sync_degraded``
  set — observable, not fatal. The degrade is **per rank**: configure the guard
  on every rank (the config is process-global), so the survivors' own guards
  time out their now-short-handed collectives instead of hanging.

The guard never runs inside a CUDA graph capture: no collective is captured. A
worker thread starts on the default CUDA device and stream; where the collective's
payload is a CUDA tensor, the worker enters the caller's device and current stream, so
that an NCCL collective is ordered against the caller's work (a gloo collective of
``parallel/sync.py`` takes host tensors and is unaffected).
"""

from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Any, Callable, Optional, Tuple

import torch

import torchmetrics_tpu_torch.obs.trace as _trace
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

__all__ = [
    "ENV_SYNC_RETRIES",
    "ENV_SYNC_TIMEOUT",
    "CollectiveError",
    "CollectiveTimeoutError",
    "configure_sync_guard",
    "guarded_collective",
    "sync_guard",
]


class CollectiveError(RuntimeError):
    """An eager collective failed all its guarded attempts."""


class CollectiveTimeoutError(CollectiveError):
    """A single guarded collective attempt exceeded its timeout."""


# process-global guard config; None timeout = guard disabled (direct calls).
# `explicit` marks a configure_sync_guard()/sync_guard() call: explicit config
# always beats the TM_TPU_SYNC_* environment defaults below.
_CONFIG = {"timeout": None, "retries": 1, "explicit": False}

# fleet-deployable guard defaults, consulted only while the guard is NOT
# explicitly configured: a launcher can arm every host's guard without code
# changes, and any in-process configure_sync_guard()/sync_guard() still wins
ENV_SYNC_TIMEOUT = "TM_TPU_SYNC_TIMEOUT"
ENV_SYNC_RETRIES = "TM_TPU_SYNC_RETRIES"
# env vars already warned about (bad values warn ONCE per var+value, then
# fall back to the built-in default — a typo must not spam every collective)
_ENV_WARNED: set = set()


def _env_value(name: str, parse: Callable[[str], Any], describe: str) -> Optional[Any]:
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return None
    try:
        return parse(raw.strip())
    except (TypeError, ValueError):
        key = (name, raw)
        if key not in _ENV_WARNED:
            _ENV_WARNED.add(key)
            rank_zero_warn(
                f"Ignoring {name}={raw!r}: expected {describe}. The sync guard"
                " falls back to its built-in default; this warning fires once"
                " per value.",
                RuntimeWarning,
            )
        return None


def _parse_timeout(raw: str) -> float:
    value = float(raw)
    if value <= 0:
        raise ValueError(raw)
    return value


def _parse_retries(raw: str) -> int:
    value = int(raw)
    if value < 0:
        raise ValueError(raw)
    return value


def _resolved_config() -> Tuple[Optional[float], int]:
    """The effective (timeout, retries): explicit config wins, else the
    ``TM_TPU_SYNC_TIMEOUT``/``TM_TPU_SYNC_RETRIES`` environment, else the
    built-in defaults (guard off, one retry)."""
    if _CONFIG["explicit"]:
        return _CONFIG["timeout"], _CONFIG["retries"]
    timeout = _env_value(ENV_SYNC_TIMEOUT, _parse_timeout, "a positive number of seconds")
    if timeout is None:
        timeout = _CONFIG["timeout"]
    retries = _env_value(ENV_SYNC_RETRIES, _parse_retries, "a non-negative integer")
    if retries is None:
        retries = _CONFIG["retries"]
    return timeout, retries


def configure_sync_guard(timeout: Optional[float] = None, retries: int = 1) -> dict:
    """Set the eager-sync guard: per-attempt ``timeout`` seconds and bounded
    ``retries`` after the first attempt. ``timeout=None`` disables the guard.
    Explicit configuration always beats the ``TM_TPU_SYNC_TIMEOUT`` /
    ``TM_TPU_SYNC_RETRIES`` environment defaults. Returns the previous
    configuration (restore it to re-enable the environment defaults)."""
    if timeout is not None and timeout <= 0:
        raise ValueError(f"Expected `timeout` to be positive or None, got {timeout}")
    if retries < 0:
        raise ValueError(f"Expected `retries` to be >= 0, got {retries}")
    previous = dict(_CONFIG)
    _CONFIG["timeout"] = timeout
    _CONFIG["retries"] = retries
    _CONFIG["explicit"] = True
    return previous


@contextmanager
def sync_guard(timeout: Optional[float], retries: int = 1):
    """Scoped guard config: ``with sync_guard(timeout=30.0, retries=2): ...``."""
    previous = configure_sync_guard(timeout, retries)
    try:
        yield
    finally:
        _CONFIG.update(previous)


def _attempt(fn: Callable[..., Any], args: tuple, kwargs: dict, timeout: Optional[float], description: str) -> Any:
    """One guarded attempt: consult fault injection, then run under ``timeout``."""
    from torchmetrics_tpu_torch.robust import faults

    injected = faults.next_collective_fault()
    if injected == "raise":
        raise CollectiveError(f"injected failure in {description}")
    if injected == "hang":
        if timeout is None:
            raise CollectiveTimeoutError(
                f"injected hang in {description} with no timeout configured"
            )
        threading.Event().wait(timeout)  # a real (bounded) wait: exercises the timeout path
        raise CollectiveTimeoutError(f"{description} timed out after {timeout:g}s (injected hang)")

    if timeout is None:
        return fn(*args, **kwargs)

    result: list = []
    error: list = []
    stream = _caller_cuda_stream(args, kwargs)

    def _run() -> None:
        try:
            if stream is None:
                result.append(fn(*args, **kwargs))
            else:
                with torch.cuda.device(stream.device), torch.cuda.stream(stream):
                    result.append(fn(*args, **kwargs))
        except BaseException as err:  # noqa: BLE001 - relayed to the caller below
            error.append(err)

    worker = threading.Thread(target=_run, daemon=True, name=f"guarded-{description}")
    worker.start()
    worker.join(timeout)
    if worker.is_alive():
        # the blocked collective cannot be cancelled; abandon its thread
        raise CollectiveTimeoutError(f"{description} timed out after {timeout:g}s")
    if error:
        raise error[0]
    return result[0]


def _caller_cuda_stream(args: tuple, kwargs: dict) -> Optional[Any]:
    """The caller's current stream on the device of the first CUDA tensor among the
    collective's arguments (a tensor or a list of tensors), else None."""
    for value in (*args, *kwargs.values()):
        for item in value if isinstance(value, (list, tuple)) else (value,):
            if isinstance(item, torch.Tensor) and item.is_cuda:
                return torch.cuda.current_stream(item.device)
    return None


def guarded_collective(fn: Callable[..., Any], *args: Any, description: str = "collective", **kwargs: Any) -> Any:
    """Run an eager collective under the configured guard.

    Direct call when the guard is unconfigured and no fault is injected (the
    default — zero overhead). Otherwise: up to ``1 + retries`` attempts, each
    bounded by ``timeout``; on exhaustion raises :class:`CollectiveError` so the
    caller can degrade instead of hanging.
    """
    from torchmetrics_tpu_torch.robust import faults

    timeout, retries = _resolved_config()
    if timeout is None and not faults.collective_faults_active():
        return fn(*args, **kwargs)

    attempts = 1 + int(retries)
    last_err: Optional[BaseException] = None
    made = 0
    for attempt in range(attempts):
        made += 1
        try:
            return _attempt(fn, args, kwargs, timeout, description)
        except CollectiveTimeoutError as err:
            # NEVER retry a timed-out collective: the abandoned worker thread
            # may still be parked inside it and could complete it later with
            # the other hosts — a retry from this host would then pair with
            # the world's NEXT collective and silently gather mismatched
            # payloads. Degrading immediately keeps this host's view
            # consistent; the other hosts' guards time out their own
            # now-short-handed collectives in turn.
            last_err = err
            if _trace.ENABLED:
                _trace.inc("sync.collective_timeout", op=description)
            break
        except _RETRYABLE as err:  # noqa: PERF203 - bounded retry loop by design
            last_err = err
            if attempt + 1 < attempts:
                if _trace.ENABLED:
                    _trace.inc("sync.collective_retry", op=description)
                rank_zero_warn(
                    f"Eager collective {description} failed (attempt {attempt + 1}/{attempts}):"
                    f" {err}. Retrying.",
                    RuntimeWarning,
                )
    raise CollectiveError(
        f"Eager collective {description} failed after {made} attempt(s): {last_err}"
    ) from last_err


# only transport-shaped failures retry and degrade: timeouts, I/O errors, and
# runtime errors (torch.distributed's DistBackendError subclasses RuntimeError). Determinis-
# tic programming errors (TypeError, ValueError from mismatched shapes, ...)
# propagate immediately — degrading those would turn a loud bug into silently
# local-only metric values.
_RETRYABLE = (CollectiveError, TimeoutError, OSError, RuntimeError, ConnectionError)
