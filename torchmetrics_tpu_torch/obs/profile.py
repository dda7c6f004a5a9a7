"""Profiler sessions: guarded ``torch.profiler`` traces + the host sampler.

Counterpart of ``torchmetrics_tpu/obs/profile.py``. ``start_trace``/``stop_trace``
bracket a region of the run with a ``torch.profiler`` trace (host ops, CUDA runtime
calls and device kernels), written as a Chrome trace JSON file into ``log_dir`` (load
it in Perfetto or ``chrome://tracing``). While such a session is live, :data:`RANGES`
is ``True`` and the ``Metric`` runtime wraps ``update`` / ``compute`` / ``sync`` in
``torch.profiler.record_function`` ranges named after the metric class (e.g.
``MulticlassAccuracy.update``), where the JAX package puts ``jax.named_scope``: the
trace attributes the kernels launched inside them to metric class names. Outside a
session the runtime enters no range (one module-flag branch), and inside a CUDA graph
capture never (:func:`metric_range`).

Wrappers rather than raw calls because profiling must never take down the run it is
observing: an unavailable/duplicate profiler session degrades to a warning and a
``False`` return. Start/stop also land in the obs event log when tracing is enabled,
so exported telemetry shows *when* a trace was captured and where it was written.

:func:`profile_session` is the combined capture: the ``torch.profiler`` trace AND the
continuous host sampler (:mod:`obs.hostprof`) started and stopped together, so one
call covers both sides of a region.

torch is imported lazily — importing :mod:`torchmetrics_tpu_torch.obs` stays
stdlib-only.
"""

from __future__ import annotations

import os
from contextlib import contextmanager, nullcontext
from typing import Any, Iterator, Optional

import torchmetrics_tpu_torch.obs.trace as trace

__all__ = [
    "RANGES",
    "annotate",
    "last_trace_path",
    "metric_range",
    "profile_session",
    "profile_trace",
    "reset",
    "start_trace",
    "stop_trace",
]

# True only while a profiler session of this module is live: the Metric runtime's
# record_function ranges guard on it, so the default update path enters none
RANGES = False

# the in-flight capture (log_dir None when no trace is active) and the last file written
_ACTIVE: dict = {"log_dir": None, "profiler": None, "last_path": None, "count": 0}


def _warn(message: str) -> None:
    from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

    rank_zero_warn(message, RuntimeWarning)


def _capturing() -> bool:
    """Whether the current CUDA stream is recording a graph (never on a CPU-only build)."""
    import torch

    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def metric_range(name: str) -> Any:
    """A ``record_function`` range named ``name`` — or no range while a CUDA graph
    capture records, where a host-side profiler range has no place."""
    if _capturing():
        return nullcontext()
    import torch

    return torch.profiler.record_function(name)


def start_trace(log_dir: str) -> bool:
    """Begin a ``torch.profiler`` trace that :func:`stop_trace` writes into ``log_dir``;
    True on success."""
    global RANGES
    if _ACTIVE["log_dir"] is not None:
        _warn(f"A profiler trace into {_ACTIVE['log_dir']} is already active; ignoring start_trace.")
        return False
    try:
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
    except Exception as err:
        _warn(f"torch.profiler start into {log_dir!r} failed: {err}. Continuing without a device trace.")
        return False
    _ACTIVE["log_dir"] = log_dir
    _ACTIVE["profiler"] = profiler
    RANGES = True
    if trace.ENABLED:
        trace.event("profiler.start", log_dir=log_dir)
    return True


def stop_trace() -> bool:
    """End the in-flight trace and write it as ``log_dir/trace-<pid>-<n>.json``; True on
    success.

    A failed stop KEEPS the active-trace marker, so a later retry can attempt the stop
    again, unless the profiler says no session is running (stopped outside this API):
    then the marker is cleared. A failed write after a good stop clears it too (the
    session is over either way).
    """
    global RANGES
    log_dir = _ACTIVE["log_dir"]
    if log_dir is None:
        _warn("stop_trace called with no active profiler trace; ignoring.")
        return False
    profiler = _ACTIVE["profiler"]
    try:
        profiler.stop()
    except Exception as err:
        message = str(err).lower()
        if "no profile" in message or "not started" in message or "no active" in message:
            reset()
            _warn(f"torch.profiler stop found no active session ({err}); cleared the trace marker.")
        else:
            _warn(f"torch.profiler stop failed: {err}. The trace is still marked active; retry stop_trace().")
        return False
    reset()
    _ACTIVE["count"] += 1
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{_ACTIVE['count']}.json")
    try:
        os.makedirs(log_dir, exist_ok=True)
        profiler.export_chrome_trace(path)
    except Exception as err:
        _warn(f"Writing the torch.profiler trace to {path!r} failed: {err}.")
        return False
    _ACTIVE["last_path"] = path
    if trace.ENABLED:
        trace.event("profiler.stop", log_dir=log_dir, path=path)
    return True


def last_trace_path() -> Optional[str]:
    """The Chrome trace file the last successful :func:`stop_trace` wrote."""
    return _ACTIVE["last_path"]


def reset() -> None:
    """Forget the active-trace marker without touching the profiler.

    Escape hatch: if the underlying session was torn down outside this API and the
    stop error's wording wasn't recognized by :func:`stop_trace`, the marker would
    otherwise block every later :func:`start_trace` forever.
    """
    global RANGES
    _ACTIVE["log_dir"] = None
    _ACTIVE["profiler"] = None
    RANGES = False


@contextmanager
def profile_trace(log_dir: str) -> Iterator[bool]:
    """Scoped trace: ``with profile_trace("/tmp/tb"): run_epoch(...)``.

    Yields whether the capture actually started; the block runs either way.
    """
    started = start_trace(log_dir)
    try:
        yield started
    finally:
        if started:
            stop_trace()


@contextmanager
def profile_session(
    log_dir: Optional[str] = None,
    host: bool = True,
    rate_hz: float = 200.0,
    **host_kwargs: Any,
) -> Iterator[dict]:
    """One scoped capture of BOTH sides: ``torch.profiler`` trace + host sampler.

    ``log_dir`` (optional) brackets the block with the guarded trace exactly like
    :func:`profile_trace`; ``host=True`` (default) additionally installs and starts an
    :class:`obs.hostprof.HostProfiler` at ``rate_hz`` for the same window. Yields
    ``{"device": started, "host": profiler_or_None}`` — the host profiler's tables
    stay readable after the block. Either side degrades independently: a failed trace
    start never blocks the host sampler, and vice versa.
    """
    from torchmetrics_tpu_torch.obs import hostprof as _hostprof

    started = start_trace(log_dir) if log_dir is not None else False
    profiler = None
    previous = None
    if host:
        profiler = _hostprof.HostProfiler(rate_hz=rate_hz, **host_kwargs)
        previous = _hostprof.install(profiler)
        profiler.start()
    try:
        yield {"device": started, "host": profiler}
    finally:
        if profiler is not None:
            profiler.stop()
            _hostprof.install(previous)
        if started:
            stop_trace()


def annotate(name: str) -> Any:
    """A named ``record_function`` range for attributing time in captured traces,
    mirroring the runtime's built-in per-metric ranges."""
    import torch

    return torch.profiler.record_function(name)
