"""Deterministic retry/backoff and validated resource fetching.

Counterpart of ``torchmetrics_tpu/robust/retry.py``. No ported metric fetches
anything yet; the domain slices (BERTScore baselines, nltk punkt, DNSMOS
checkpoint caches, LPIPS backbones) route through these helpers so
transient failures — truncated downloads, half-written cache files, flaky
mirrors — are retried with a bounded, *jitter-free* schedule (deterministic for
tests; jitter matters for thundering herds of thousands of clients, not for a
handful of weight fetches per job) and verified before use.

Injectable ``sleep``/``clock`` keep tests instant; :mod:`.faults` injects
truncation/corruption at the fetcher layer.
"""

from __future__ import annotations

import os
import shutil
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple, Type, Union

import torchmetrics_tpu_torch.obs.trace as _trace
from torchmetrics_tpu_torch.utils.fileio import atomic_write_bytes
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

__all__ = [
    "DEFAULT_SCHEDULE",
    "ResourceIntegrityError",
    "RetryError",
    "RetrySchedule",
    "fetch_bytes",
    "fetch_resource",
    "load_with_cache_recovery",
    "retry_call",
]


class RetryError(RuntimeError):
    """All attempts (or the deadline) exhausted; ``__cause__`` is the last failure."""


class ResourceIntegrityError(RuntimeError):
    """A fetched or cached resource failed checksum/size/loadability validation."""


@dataclass(frozen=True)
class RetrySchedule:
    """Deterministic exponential backoff: ``base_delay * multiplier**attempt``,
    capped at ``max_delay``, at most ``max_attempts`` tries, optionally bounded
    by an overall ``deadline`` (seconds from the first attempt)."""

    max_attempts: int = 3
    base_delay: float = 0.5
    multiplier: float = 2.0
    max_delay: float = 30.0
    deadline: Optional[float] = None

    def delay(self, attempt: int) -> float:
        """Backoff before retry number ``attempt + 1`` (0-based failed attempt)."""
        return min(self.base_delay * self.multiplier**attempt, self.max_delay)


DEFAULT_SCHEDULE = RetrySchedule()


def retry_call(
    fn: Callable[[], Any],
    *,
    schedule: RetrySchedule = DEFAULT_SCHEDULE,
    retry_on: Union[Type[BaseException], Tuple[Type[BaseException], ...]] = Exception,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.monotonic,
    description: str = "operation",
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
) -> Any:
    """Call ``fn`` with deterministic backoff; raise :class:`RetryError` on exhaustion.

    ``sleep``/``clock`` are injectable so tests never really wait. ``on_retry``
    (attempt index, error) fires before each backoff sleep.
    """
    start = clock()
    last_err: Optional[BaseException] = None
    for attempt in range(max(1, schedule.max_attempts)):
        try:
            return fn()
        except retry_on as err:  # noqa: PERF203 - retry loop by design
            last_err = err
            if attempt + 1 >= max(1, schedule.max_attempts):
                break
            delay = schedule.delay(attempt)
            if schedule.deadline is not None and (clock() - start) + delay > schedule.deadline:
                break
            if on_retry is not None:
                on_retry(attempt, err)
            if _trace.ENABLED:
                _trace.inc("retry.attempts", op=description)
            rank_zero_warn(
                f"{description} failed (attempt {attempt + 1}/{schedule.max_attempts}):"
                f" {err}. Retrying in {delay:g}s.",
                RuntimeWarning,
            )
            sleep(delay)
    # `retry.exhausted` signals a retry LOOP giving up, so only schedules that
    # actually retried count: fetch_resource nests a max_attempts=1 fetch_bytes
    # inside its own retry loop, and counting that inner single-shot failure
    # would report exhaustion for fetches the outer loop then recovers.
    if _trace.ENABLED and schedule.max_attempts > 1:
        _trace.inc("retry.exhausted", op=description)
    raise RetryError(
        f"{description} failed after {schedule.max_attempts} attempt(s): {last_err}"
    ) from last_err


def _default_fetcher(url: str, timeout: float = 30.0) -> bytes:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as response:
        return response.read()


def _sha256_bytes(data: bytes) -> str:
    import hashlib

    return hashlib.sha256(data).hexdigest()


def _sha256_file(path: str, chunk: int = 1 << 20) -> str:
    import hashlib

    digest = hashlib.sha256()
    with open(path, "rb") as fh:
        for block in iter(lambda: fh.read(chunk), b""):
            digest.update(block)
    return digest.hexdigest()


def fetch_bytes(
    url: str,
    *,
    schedule: RetrySchedule = DEFAULT_SCHEDULE,
    fetcher: Optional[Callable[[str], bytes]] = None,
    min_size: int = 1,
    expected_sha256: Optional[str] = None,
    sleep: Callable[[float], None] = time.sleep,
    description: Optional[str] = None,
) -> bytes:
    """Fetch ``url`` into memory with retries and size/checksum validation.

    Fault injection (:func:`faults.inject_download_fault`) applies at this
    layer, so injected truncation exercises the same validate-and-retry path a
    real torn download would.
    """
    from torchmetrics_tpu_torch.robust import faults

    description = description or f"fetch of {url}"
    fetch = fetcher or _default_fetcher

    def _once() -> bytes:
        data = faults.corrupt_download(fetch(url))
        if len(data) < min_size:
            raise ResourceIntegrityError(
                f"{description}: got {len(data)} bytes, expected at least {min_size}"
            )
        if expected_sha256 is not None and _sha256_bytes(data) != expected_sha256:
            raise ResourceIntegrityError(f"{description}: sha256 mismatch")
        return data

    return retry_call(_once, schedule=schedule, sleep=sleep, description=description)


def _validate_file(
    path: str,
    *,
    min_size: int,
    expected_sha256: Optional[str],
    validate: Optional[Callable[[str], None]],
) -> None:
    """Raise :class:`ResourceIntegrityError` when ``path`` fails validation."""
    if not os.path.isfile(path):
        raise ResourceIntegrityError(f"{path} does not exist")
    size = os.path.getsize(path)
    if size < min_size:
        raise ResourceIntegrityError(f"{path} is {size} bytes, expected at least {min_size}")
    if expected_sha256 is not None:
        digest = _sha256_file(path)
        if digest != expected_sha256:
            raise ResourceIntegrityError(
                f"{path} sha256 {digest[:12]}… does not match expected {expected_sha256[:12]}…"
            )
    if validate is not None:
        try:
            validate(path)
        except ResourceIntegrityError:
            raise
        except Exception as err:
            raise ResourceIntegrityError(f"{path} failed validation: {err}") from err


def fetch_resource(
    url: str,
    dest: str,
    *,
    schedule: RetrySchedule = DEFAULT_SCHEDULE,
    fetcher: Optional[Callable[[str], bytes]] = None,
    min_size: int = 1,
    expected_sha256: Optional[str] = None,
    validate: Optional[Callable[[str], None]] = None,
    sleep: Callable[[float], None] = time.sleep,
    description: Optional[str] = None,
) -> str:
    """Materialize ``url`` at ``dest`` with retries, validation, and atomic writes.

    A valid existing ``dest`` is reused (cache hit). A *corrupted* existing
    ``dest`` is purged with a warning and refetched — once; if the refetch fails
    validation too, the last error raises. Each fetched payload is validated and
    written to a temp file in ``dest``'s directory, then ``os.replace``-d into
    place, so a crash mid-write can never leave a half-written cache file
    masquerading as the real one.
    """
    description = description or f"fetch of {url}"
    dest = os.path.abspath(dest)
    if os.path.exists(dest):
        try:
            _validate_file(dest, min_size=min_size, expected_sha256=expected_sha256, validate=validate)
            return dest
        except ResourceIntegrityError as err:
            rank_zero_warn(
                f"Cached resource {dest} is corrupted ({err}); purging and refetching.",
                RuntimeWarning,
            )
            os.remove(dest)

    def _once() -> str:
        data = fetch_bytes(
            url,
            schedule=RetrySchedule(max_attempts=1),  # outer retry_call owns the loop
            fetcher=fetcher,
            min_size=min_size,
            expected_sha256=expected_sha256,
            sleep=sleep,
            description=description,
        )
        atomic_write_bytes(
            dest,
            data,
            validate=lambda tmp: _validate_file(
                tmp, min_size=min_size, expected_sha256=expected_sha256, validate=validate
            ),
        )
        return dest

    return retry_call(_once, schedule=schedule, sleep=sleep, description=description)


def load_with_cache_recovery(
    path: str,
    loader: Callable[[str], Any],
    *,
    rebuild: Optional[Callable[[], None]] = None,
    description: Optional[str] = None,
) -> Any:
    """Load a cached artifact, recovering once from corruption when rebuildable.

    ``loader(path)`` failing marks the cache corrupt. When ``rebuild`` is given
    the cache is purged (file or directory), ``rebuild()`` regenerates it from
    its source (e.g. re-converting a raw checkpoint), and the load is retried
    exactly once; a second failure (or no ``rebuild``) raises
    :class:`ResourceIntegrityError` chained to the loader's error.
    """
    description = description or f"cached artifact at {path}"
    try:
        return loader(path)
    except Exception as err:
        if rebuild is None:
            raise ResourceIntegrityError(f"{description} is corrupted: {err}") from err
        rank_zero_warn(
            f"{description} is corrupted ({err}); purging and rebuilding from source.",
            RuntimeWarning,
        )
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.remove(path)
        rebuild()
        try:
            return loader(path)
        except Exception as err2:
            raise ResourceIntegrityError(
                f"{description} is corrupted even after a rebuild: {err2}"
            ) from err2
