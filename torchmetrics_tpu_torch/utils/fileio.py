"""Crash-safe file writes: temp-file-in-place + atomic rename.

Counterpart of ``torchmetrics_tpu/utils/fileio.py``, copied: plain Python. The
payload is fully written (and optionally validated) under a temp name in the
destination's directory, then renamed into place. A crash at any point leaves
either the old file or the new one — never a hybrid — and the temp file is
removed on failure. The streaming engine's flight recorder and warmup manifests
write through it.

Pure stdlib; importable everywhere.
"""

from __future__ import annotations

import os
import tempfile
from contextlib import contextmanager
from typing import Callable, IO, Iterator, Optional

__all__ = ["atomic_open", "atomic_write_bytes", "atomic_write_text", "exclusive_create_text"]


@contextmanager
def atomic_open(
    path: str,
    mode: str = "w",
    encoding: Optional[str] = None,
    validate: Optional[Callable[[str], None]] = None,
) -> Iterator[IO]:
    """Open a temp file that is atomically renamed to ``path`` on clean exit.

    The single implementation of the temp-file protocol (both ``atomic_write_*``
    helpers delegate here). ``mode`` must be a write mode (``"w"`` / ``"wb"``);
    append modes make no sense under replace-on-commit semantics. The temp file
    lives in ``path``'s directory so the final ``os.replace`` never crosses a
    filesystem boundary (a cross-device rename is a copy, which reintroduces
    the torn-write window). ``validate``, when given, is called with the
    fully-written-and-synced temp path *before* the rename — a payload that
    fails validation (raises) never reaches ``path``. On any exception the
    temp file is removed and ``path`` is left untouched.
    """
    if "a" in mode or "r" in mode or "+" in mode:
        raise ValueError(f"atomic_open requires a plain write mode ('w'/'wb'), got {mode!r}")
    path = os.path.abspath(path)
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".", suffix=".tmp", dir=directory)
    try:
        with os.fdopen(fd, mode, encoding=encoding) as fh:
            yield fh
            fh.flush()
            os.fsync(fh.fileno())
        if validate is not None:
            validate(tmp)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def atomic_write_text(path: str, text: str, encoding: str = "utf-8") -> str:
    """Atomically materialize ``text`` at ``path``; returns the absolute path."""
    path = os.path.abspath(path)
    with atomic_open(path, "w", encoding=encoding) as fh:
        fh.write(text)
    return path


def exclusive_create_text(path: str, text: str, encoding: str = "utf-8") -> bool:
    """Create ``path`` with ``text`` iff it does not already exist; win/lose.

    The durable claim primitive (``O_CREAT | O_EXCL``): exactly one of N
    concurrent callers — threads OR processes sharing the filesystem — gets
    ``True``; everyone else gets ``False`` with the file untouched. Unlike
    :func:`atomic_open` the content lands after creation (creation IS the
    atomic event here; the payload is advisory detail for operators), so the
    file is fsynced before close. Any error other than "already exists"
    propagates — a claim that silently failed to persist would elect two
    leaders on the next crash.
    """
    path = os.path.abspath(path)
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    try:
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL)
    except FileExistsError:
        return False
    try:
        with os.fdopen(fd, "w", encoding=encoding) as fh:
            fh.write(text)
            fh.flush()
            os.fsync(fh.fileno())
    except BaseException:
        try:
            os.remove(path)  # a torn claim must not permanently block election
        except OSError:
            pass
        raise
    return True


def atomic_write_bytes(
    path: str, data: bytes, validate: Optional[Callable[[str], None]] = None
) -> str:
    """Atomically materialize ``data`` at ``path``; returns the absolute path.

    ``validate``, when given, runs against the fully-written temp path before
    the rename (see :func:`atomic_open`).
    """
    path = os.path.abspath(path)
    with atomic_open(path, "wb", validate=validate) as fh:
        fh.write(data)
    return path
