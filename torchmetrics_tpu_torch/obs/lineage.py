"""Batch lineage: one stable ``trace_id`` per fed batch.

Counterpart of ``torchmetrics_tpu/obs/lineage.py``, plain Python as there. A batch
has no identity that survives the engine's seams (fusion chunking, poisoned-batch
replay, ``replay_tail()`` after a migration, the crash-recovery gap re-feed), so this
module gives it one:

- :func:`mint` — a **stable, deterministic** trace id per fed batch:
  ``<tenant>-<session epoch>-<ingest ordinal>``. The epoch is minted once per
  pipeline session and *persisted in session bundles*
  (:mod:`torchmetrics_tpu_torch.engine.migrate`), and the ordinal is the session's
  arrival counter (restored across migration and crash recovery), so the same
  logical batch carries the same id on whichever process finally folds it.
- :class:`LineageIndex` — a **bounded**, thread-safe, process-wide index of
  per-batch lineage records (tenant, ordinal, ingest stamp, signature, chunk
  membership, dispatch path, fault outcome, the flight dump that named it, the
  alert rules its commit fired, the checkpoint bundle that covers it).
  Drop-oldest past ``max_traces`` with an ``evicted`` counter.
- :func:`trace` — a contextvar carrying the *current* batch's id through a
  dispatch, so duration histograms can attach **exemplars**
  (:class:`~torchmetrics_tpu_torch.obs.trace._Histogram`) and spans can carry
  ``trace_id`` attrs (never histogram labels: ids are unbounded).

The disabled path is one branch: :data:`ENABLED` stays ``False`` until
:func:`enable` is called, and every engine hook guards on it. The obs server that
reads the index (``GET /trace/<id>``) comes with the obs plane.
"""

from __future__ import annotations

import threading
import time
import uuid
from collections import OrderedDict
from contextlib import contextmanager
from contextvars import ContextVar
from typing import Any, Dict, Iterator, List, Optional

__all__ = [
    "DEFAULT_MAX_TRACES",
    "ENABLED",
    "LOCAL_TENANT",
    "LineageIndex",
    "current_trace",
    "disable",
    "enable",
    "epoch_of",
    "get_index",
    "is_enabled",
    "lookup",
    "mint",
    "new_epoch",
    "note_alert",
    "note_checkpoint",
    "note_dump",
    "ordinal_of",
    "reset",
    "trace",
    "trace_ids",
]

# THE in-use flag. False until enable(); every engine hook guards with
# ``if lineage.ENABLED:`` so the never-enabled runtime pays one module
# attribute load and one branch per batch.
ENABLED = False

DEFAULT_MAX_TRACES = 4096

# the current batch's trace id (set around a dispatch/replay so histogram
# exemplars and nested metric spans can reference it)
_TRACE: ContextVar[Optional[str]] = ContextVar("tm_tpu_trace_id", default=None)

# the label untenanted sessions mint under: a ``__``-prefixed name, which the
# tenant scope reserves — so it can never collide with a real tenant
LOCAL_TENANT = "__local__"


def new_epoch() -> str:
    """A fresh session epoch (random, unique per session *start*).

    Sessions persist their epoch in checkpoint bundles and restores re-adopt it, so
    a batch re-fed after a migration or crash carries the id it was first minted
    with.
    """
    return uuid.uuid4().hex[:12]


def mint(tenant: Optional[str], epoch: str, ordinal: int) -> str:
    """The stable id of one fed batch: tenant + session epoch + ingest ordinal.

    Deterministic given its three parts — re-minting the same (tenant, epoch,
    ordinal) yields the same id, which is exactly how a crash-recovery gap
    re-feed reproduces the lost batches' identities. The id is opaque to
    consumers (:func:`ordinal_of` is the one sanctioned read-back, used when a
    persisted id is re-fed on a host that never saw the original ingest).
    """
    return f"{tenant if tenant is not None else LOCAL_TENANT}-{epoch}-{int(ordinal)}"


def ordinal_of(trace_id: str) -> int:
    """The ingest ordinal a minted id carries (``-1`` on a foreign id)."""
    try:
        return int(trace_id.rsplit("-", 1)[1])
    except (IndexError, ValueError):
        return -1


def epoch_of(trace_id: str) -> Optional[str]:
    """The session epoch a minted id carries (``None`` on a foreign id).

    The epoch doubles as the session's **fencing token** (``robust/fence.py``).
    """
    parts = trace_id.rsplit("-", 2)
    if len(parts) != 3 or not parts[1]:
        return None
    try:
        int(parts[2])  # a real minted id ends in its ingest ordinal
    except ValueError:
        return None
    return parts[1]


class LineageIndex:
    """Bounded, thread-safe map of ``trace_id`` → per-batch lineage record.

    One record per minted id, drop-oldest past ``max_traces`` (``evicted``
    counts the loss). Records are
    plain dicts, safe to serialize.
    """

    def __init__(self, max_traces: int = DEFAULT_MAX_TRACES) -> None:
        if max_traces < 1:
            raise ValueError(f"Expected `max_traces` >= 1, got {max_traces}")
        self._lock = threading.Lock()
        self.max_traces = int(max_traces)
        self.clear()

    def clear(self) -> None:
        with self._lock:
            self._records: "OrderedDict[str, Dict[str, Any]]" = OrderedDict()
            # per-tenant covering-checkpoint watermark: (bundle path, the
            # processed-batch count the bundle covers)
            self._checkpoints: Dict[str, Dict[str, Any]] = {}
            self.evicted = 0
            self.minted = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def open(
        self,
        trace_id: str,
        tenant: Optional[str],
        ordinal: int,
        **fields: Any,
    ) -> Dict[str, Any]:
        """Register one batch's record (idempotent: a re-fed batch whose id is
        already live updates in place)."""
        with self._lock:
            record = self._records.get(trace_id)
            if record is None:
                record = {
                    "trace_id": trace_id,
                    "tenant": tenant,
                    "ordinal": int(ordinal),
                    # the minting session's epoch — the fencing token
                    "epoch": epoch_of(trace_id),
                    "ingest_unix": time.time(),
                    "signature": None,
                    "chunk_id": None,
                    "path": None,
                    "outcome": None,
                    "dump": None,
                    "alerts": [],
                }
                self._records[trace_id] = record
                self.minted += 1
                while len(self._records) > self.max_traces:
                    self._records.popitem(last=False)
                    self.evicted += 1
            record.update(fields)
            return record

    def update(self, trace_id: str, **fields: Any) -> None:
        """Amend a live record (no-op on an evicted/unknown id)."""
        with self._lock:
            record = self._records.get(trace_id)
            if record is not None:
                record.update(fields)

    def note_dump(self, ids: List[str], path: Optional[str]) -> None:
        """Attach the flight dump that named these batches to their records."""
        if path is None:
            return
        with self._lock:
            for trace_id in ids:
                record = self._records.get(trace_id)
                if record is not None:
                    record["dump"] = path

    def note_alert(self, ids: List[str], rules: List[str]) -> None:
        """Attach newly-fired alert rules to the batches whose commit triggered the
        evaluation."""
        with self._lock:
            for trace_id in ids:
                record = self._records.get(trace_id)
                if record is not None:
                    for rule in rules:
                        if rule not in record["alerts"]:
                            record["alerts"].append(rule)

    def note_checkpoint(self, tenant: Optional[str], path: str, covered_batches: int) -> None:
        """Record the newest bundle covering ``tenant``'s first ``covered_batches``
        processed batches.

        Callers note coverage only on a stream where every arrival was processed in
        order: the join compares a batch's ARRIVAL ordinal with this processed-batch
        watermark.
        """
        key = tenant if tenant is not None else LOCAL_TENANT
        with self._lock:
            self._checkpoints[key] = {
                "path": str(path),
                "covered_batches": int(covered_batches),
                "ts_unix": time.time(),
            }

    def covering_checkpoint(self, record: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """The bundle covering this batch, if one has been written past it."""
        key = record.get("tenant") or LOCAL_TENANT
        with self._lock:
            row = self._checkpoints.get(key)
            if row is None or record.get("ordinal", 0) >= row["covered_batches"]:
                return None
            return dict(row)

    def get(self, trace_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            record = self._records.get(trace_id)
            return dict(record) if record is not None else None

    def ids(self, tenant: Optional[str] = None) -> List[str]:
        """Live trace ids, oldest first (optionally one tenant's)."""
        with self._lock:
            if tenant is None:
                return list(self._records)
            return [
                trace_id
                for trace_id, record in self._records.items()
                if record.get("tenant") == tenant
            ]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "size": len(self._records),
                "max_traces": self.max_traces,
                "minted": self.minted,
                "evicted": self.evicted,
            }


_INDEX = LineageIndex()


def get_index() -> LineageIndex:
    return _INDEX


def is_enabled() -> bool:
    return ENABLED


def enable(max_traces: Optional[int] = None, reset: bool = True) -> LineageIndex:
    """Turn batch lineage on; ``reset`` (default) clears the index."""
    global ENABLED
    if max_traces is not None:
        if max_traces < 1:
            raise ValueError(f"Expected `max_traces` >= 1, got {max_traces}")
        _INDEX.max_traces = int(max_traces)
    if reset:
        _INDEX.clear()
    ENABLED = True
    return _INDEX


def disable() -> None:
    global ENABLED
    ENABLED = False


def reset() -> None:
    """Back to the pristine one-branch disabled path (test hygiene)."""
    global ENABLED
    ENABLED = False
    _INDEX.clear()
    _INDEX.max_traces = DEFAULT_MAX_TRACES


def current_trace() -> Optional[str]:
    """The ambient batch's trace id, or ``None`` outside any dispatch."""
    return _TRACE.get()


@contextmanager
def trace(trace_id: Optional[str]) -> Iterator[Optional[str]]:
    """Set the ambient trace id for the block (exemplars + span references).

    ``None`` is accepted and is a no-op context, so call sites need no branch
    of their own beyond the ``lineage.ENABLED`` guard.
    """
    if trace_id is None:
        yield None
        return
    token = _TRACE.set(trace_id)
    try:
        yield trace_id
    finally:
        _TRACE.reset(token)


def lookup(trace_id: str) -> Optional[Dict[str, Any]]:
    """One batch's lineage record (a copy), or ``None``."""
    return _INDEX.get(trace_id)


def trace_ids(tenant: Optional[str] = None) -> List[str]:
    return _INDEX.ids(tenant)


def note_dump(ids: List[str], path: Optional[str]) -> None:
    if ENABLED:
        _INDEX.note_dump(ids, path)


def note_alert(ids: List[str], rules: List[str]) -> None:
    if ENABLED:
        _INDEX.note_alert(ids, rules)


def note_checkpoint(tenant: Optional[str], path: str, covered_batches: int) -> None:
    if ENABLED:
        _INDEX.note_checkpoint(tenant, path, covered_batches)
