"""Low-overhead runtime telemetry: spans, events, counters, duration histograms.

Counterpart of ``torchmetrics_tpu/obs/trace.py``, plain Python as there. The port
instruments its hot seams — the capture cache (``core/jit.py``), the ``Metric``
update/compute/forward/reset lifecycle (``core/metric.py``) and the streaming
engine (``engine/pipeline.py``) — through this module, under the JAX package's
span, counter and gauge names, so the two packages' telemetry reads alike. The
design constraints, in order:

1. **Disabled is free.** A single module-level flag (:data:`ENABLED`); every
   instrumented call site is guarded by ``if trace.ENABLED:`` so the default
   path costs one attribute load and one branch. Nothing here imports torch —
   pure stdlib — so importing the runtime never pays for telemetry either.
2. **Enabled is bounded.** Events land in a ring buffer (``max_events``,
   default 4096, drop-oldest with a ``dropped_events`` counter); counters,
   gauges and histograms are small dicts, and the series count is capped.
3. **Thread-safe.** All recorder mutation is lock-protected, and span nesting
   depth is tracked per thread.

Spans additionally feed a duration histogram (log-scale second buckets) keyed
by the span name plus its *string-valued* attributes — string attributes are
treated as bounded-cardinality labels (metric class, dispatch path), while
numeric attributes (payload sizes, cache sizes) stay event-only so an unbounded
value stream can never explode the histogram key space.

The exporters (JSONL, Prometheus text, summary) and the cross-host aggregation
come with the obs slice.
"""

from __future__ import annotations

import os
import socket
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

# batch lineage (pure stdlib): with lineage enabled, the ambient batch trace
# id (obs/lineage.py contextvar) rides duration observations as bounded
# per-bucket histogram EXEMPLARS — never as labels, so an unbounded id stream
# can never mint series; never-enabled cost is one branch per observation
import torchmetrics_tpu_torch.obs.lineage as _lineage

# tenant/session attribution (pure stdlib, no package-internal imports): every
# recorder write passes its labels through scope.tag so an ambient
# `scope(tenant=...)` context stamps counters/gauges/histograms/spans/events
# with a bounded-cardinality `tenant` label; never-entered cost is one branch
import torchmetrics_tpu_torch.obs.scope as _scope

__all__ = [
    "ENABLED",
    "SCHEMA_VERSION",
    "TraceRecorder",
    "annotate_current_span",
    "disable",
    "enable",
    "event",
    "get_recorder",
    "inc",
    "is_enabled",
    "observe",
    "observe_duration",
    "record_warning",
    "set_gauge",
    "span",
]

# THE enabled flag. Hot call sites guard with ``if trace.ENABLED:`` — the
# disabled path is one module-attribute load and one branch.
ENABLED = False

# Wire-format version of TraceRecorder.snapshot(), the JAX package's: snapshots
# from hosts of different builds must not be mis-parsed. Bump on any structural
# snapshot change.
SCHEMA_VERSION = 1

_DEFAULT_MAX_EVENTS = 4096


def _host_meta() -> Dict[str, Any]:
    """Rank identity of this process: rank and world size from ``torch.distributed``
    when a process group is initialised (and torch is already imported: telemetry
    never imports it), else process 0 of 1; plus a stable host id."""
    index, count = 0, 1
    torch_mod = sys.modules.get("torch")
    dist = getattr(torch_mod, "distributed", None) if torch_mod is not None else None
    if dist is not None and dist.is_available() and dist.is_initialized():
        index, count = int(dist.get_rank()), int(dist.get_world_size())
    return {
        "process_index": index,
        "process_count": count,
        "host_id": f"{socket.gethostname()}:{os.getpid()}",
    }


LabelsKey = Tuple[Tuple[str, Any], ...]


def _labels_key(labels: Dict[str, Any]) -> LabelsKey:
    return tuple(sorted(labels.items()))


class _Histogram:
    """Fixed log-scale duration histogram (seconds), Prometheus-compatible.

    With batch lineage enabled (:mod:`~torchmetrics_tpu_torch.obs.lineage`) each
    bucket additionally keeps the last :data:`EXEMPLAR_K` ``(trace_id, value,
    wall)`` **exemplars** — the OpenMetrics join from a latency bucket back to
    the concrete batch that landed in it. Exemplars are bounded per bucket,
    attach only to already-existing series (they can never mint a new label
    set), and cost nothing while lineage is off (the dict stays ``None``).
    """

    # non-cumulative per-bucket upper bounds; export computes cumulative counts
    BOUNDS: Tuple[float, ...] = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0, float("inf"))

    # exemplars kept per bucket (last-K wins: the freshest evidence is the
    # most actionable, and K bounds the memory per series)
    EXEMPLAR_K: int = 2

    __slots__ = ("counts", "sum", "count", "exemplars")

    def __init__(self) -> None:
        self.counts = [0] * len(self.BOUNDS)
        self.sum = 0.0
        self.count = 0
        self.exemplars: Optional[Dict[int, deque]] = None

    def observe(self, value: float, trace_id: Optional[str] = None) -> None:
        for i, bound in enumerate(self.BOUNDS):
            if value <= bound:
                self.counts[i] += 1
                if trace_id is not None:
                    if self.exemplars is None:
                        self.exemplars = {}
                    ring = self.exemplars.get(i)
                    if ring is None:
                        ring = self.exemplars[i] = deque(maxlen=self.EXEMPLAR_K)
                    ring.append((trace_id, value, time.time()))
                break
        self.sum += value
        self.count += 1

    def snapshot(self) -> Dict[str, Any]:
        snap = {
            "buckets": [[bound, count] for bound, count in zip(self.BOUNDS, self.counts)],
            "sum": self.sum,
            "count": self.count,
        }
        if self.exemplars:
            # additive key (absent without lineage): bucket index -> rows, so
            # pre-lineage consumers of the snapshot shape keep parsing
            snap["exemplars"] = {
                str(i): [[tid, val, wall] for tid, val, wall in ring]
                for i, ring in sorted(self.exemplars.items())
            }
        return snap


class TraceRecorder:
    """Bounded, thread-safe sink for spans/events/counters/gauges/histograms."""

    def __init__(self, max_events: int = _DEFAULT_MAX_EVENTS) -> None:
        self._lock = threading.Lock()
        self._local = threading.local()
        self.max_events = int(max_events)
        self.clear()

    # ------------------------------------------------------------------ lifecycle

    def clear(self) -> None:
        """Drop all recorded data and restart the session clock."""
        with self._lock:
            self._events: deque = deque()
            self.dropped_events = 0
            self._counters: Dict[Tuple[str, LabelsKey], float] = {}
            self._gauges: Dict[Tuple[str, LabelsKey], float] = {}
            self._hists: Dict[Tuple[str, LabelsKey], _Histogram] = {}
            self._seen_warnings: set = set()
            self._t0 = time.monotonic()
            # wall-clock anchor paired with the monotonic session clock: lets
            # cross-host exports place hosts on one shared timeline (each
            # host's event `ts` is monotonic-relative; anchor + ts ≈ wall time)
            self._wall0 = time.time()

    def _span_stack(self) -> List[Tuple[str, Dict[str, Any]]]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _append(self, record: Dict[str, Any]) -> None:
        # caller holds the lock; while (not if): the cap may have been lowered
        # below the current length via set_max_events on a live recorder
        while len(self._events) >= self.max_events:
            self._events.popleft()
            self.dropped_events += 1
        self._events.append(record)

    def set_max_events(self, max_events: int) -> None:
        """Rebound the ring buffer, evicting (and counting) the oldest events
        immediately when the new cap is below the current length."""
        if max_events <= 0:
            raise ValueError(f"Expected `max_events` to be positive, got {max_events}")
        with self._lock:
            self.max_events = int(max_events)
            while len(self._events) > self.max_events:
                self._events.popleft()
                self.dropped_events += 1

    def _restore_max_events(self, max_events: int) -> None:
        """Exit-path restore for ``observe``: reset the cap WITHOUT evicting.

        A scoped capture that raised the cap must stay exportable after the
        block ('recorded data is kept on exit'); ``_append``'s while-eviction
        re-establishes the bound at the next recording instead.
        """
        with self._lock:
            self.max_events = int(max_events)

    # ------------------------------------------------------------------ recording

    def add_event(self, name: str, kind: str = "event", **attrs: Any) -> None:
        attrs = _scope.tag(attrs)
        with self._lock:
            self._append(
                {
                    "kind": kind,
                    "name": name,
                    "ts": time.monotonic() - self._t0,
                    "tid": threading.get_ident(),
                    "attrs": attrs,
                }
            )

    def add_span(self, name: str, start: float, duration: float, depth: int, attrs: Dict[str, Any]) -> None:
        attrs = _scope.tag(attrs)
        with self._lock:
            self._append(
                {
                    "kind": "span",
                    "name": name,
                    "ts": start - self._t0,
                    "dur": duration,
                    "depth": depth,
                    "tid": threading.get_ident(),
                    "attrs": attrs,
                }
            )
            # trace ids are event-only data: an unbounded id stream must never
            # become a histogram label (series explosion) — they ride the span
            # attrs for /trace and Perfetto flows, and the histogram as a
            # bounded exemplar instead
            labels = {
                k: v
                for k, v in attrs.items()
                if isinstance(v, str) and not k.startswith("trace_id")
            }
            key = (name, _labels_key(labels))
            if not self._series_slot(self._hists, key):
                return
            hist = self._hists.get(key)
            if hist is None:
                hist = self._hists[key] = _Histogram()
            hist.observe(
                duration, _lineage.current_trace() if _lineage.ENABLED else None
            )

    def inc(self, name: str, value: float = 1.0, **labels: Any) -> None:
        key = (name, _labels_key(_scope.tag(labels)))
        with self._lock:
            if self._series_slot(self._counters, key):
                self._counters[key] = self._counters.get(key, 0.0) + value

    def set_gauge(self, name: str, value: float, **labels: Any) -> None:
        key = (name, _labels_key(_scope.tag(labels)))
        with self._lock:
            if self._series_slot(self._gauges, key):
                self._gauges[key] = value

    def observe_duration(self, name: str, seconds: float, **labels: Any) -> None:
        key = (name, _labels_key(_scope.tag(labels)))
        with self._lock:
            if not self._series_slot(self._hists, key):
                return
            hist = self._hists.get(key)
            if hist is None:
                hist = self._hists[key] = _Histogram()
            hist.observe(
                seconds, _lineage.current_trace() if _lineage.ENABLED else None
            )

    # dedup tracks at most this many distinct warning messages: warnings with
    # per-occurrence dynamic text (embedded errors, attempt counts) would
    # otherwise grow the seen-set without bound on a long flaky run. Past the
    # cap, new messages still emit and land in the event log — they just stop
    # being dedup-tracked.
    max_tracked_warnings: int = 1024

    # cardinality cap across counter/gauge/histogram series: a long-lived
    # session that keeps constructing metric objects (fresh per-instance
    # labels) must not grow the recorder without bound. New series past the
    # cap are dropped and counted under `series.dropped`.
    max_series: int = 4096

    def _series_slot(self, table: Dict, key: Tuple[str, LabelsKey]) -> bool:
        """True when ``key`` exists or may be created; counts refused series.

        Caller holds the lock.
        """
        if key in table or len(table) < self.max_series:
            return True
        dropped = ("series.dropped", ())
        self._counters[dropped] = self._counters.get(dropped, 0.0) + 1.0
        return False

    def record_warning(self, message: str) -> bool:
        """Log a warning into the event stream; returns False for a duplicate.

        First occurrence of a message is recorded as a ``warning`` event (and
        should still be emitted through ``warnings.warn`` by the caller);
        repeats only bump the ``warnings.deduplicated`` counter.
        """
        with self._lock:
            if message in self._seen_warnings:
                key = ("warnings.deduplicated", ())
                self._counters[key] = self._counters.get(key, 0.0) + 1.0
                return False
            if len(self._seen_warnings) < self.max_tracked_warnings:
                self._seen_warnings.add(message)
            else:
                # past the dedup-tracking cap: the message still emits and
                # lands in the event log, but repeats of it can no longer be
                # deduplicated — count that loss instead of hiding it
                # (surfaced as `warnings_dropped` in summary/Prometheus)
                key = ("warnings.dropped", ())
                self._counters[key] = self._counters.get(key, 0.0) + 1.0
            key = ("warnings.emitted", ())
            self._counters[key] = self._counters.get(key, 0.0) + 1.0
            self._append(
                {
                    "kind": "warning",
                    "name": "warning",
                    "ts": time.monotonic() - self._t0,
                    "tid": threading.get_ident(),
                    "attrs": {"message": message},
                }
            )
            return True

    # ------------------------------------------------------------------ inspection

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def series_counts_by_label(self, label: str, exclude_name_prefix: Optional[str] = None) -> Dict[str, int]:
        """Distinct recorded series (counters + gauges + histograms) per value of
        ``label`` — the per-tenant cardinality behind the ``tenant.series`` gauges.
        ``exclude_name_prefix`` drops series families from the count."""
        counts: Dict[str, int] = {}
        with self._lock:
            for table in (self._counters, self._gauges, self._hists):
                for name, labels in table:
                    if exclude_name_prefix is not None and name.startswith(exclude_name_prefix):
                        continue
                    for key, value in labels:
                        if key == label:
                            counts[str(value)] = counts.get(str(value), 0) + 1
                            break
        return counts

    def counter_value(self, name: str, **labels: Any) -> float:
        """Value of one counter (0.0 when never incremented). With no labels
        given, sums across every label set of ``name``."""
        with self._lock:
            if labels:
                return self._counters.get((name, _labels_key(labels)), 0.0)
            return sum(v for (n, _), v in self._counters.items() if n == name)

    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time copy of everything recorded, as plain python data.

        Rank-aware: carries the snapshot schema version, this process's rank
        identity (``host``), the wall-clock anchor of the session clock, and
        the elapsed session time — what a merge of many hosts' snapshots onto
        one timeline needs.
        """
        host = _host_meta()  # resolved outside the lock: may consult torch.distributed
        with self._lock:
            return {
                "schema_version": SCHEMA_VERSION,
                "host": host,
                "wall_clock_anchor": self._wall0,
                "elapsed": time.monotonic() - self._t0,
                "events": list(self._events),
                "dropped_events": self.dropped_events,
                "counters": [
                    {"name": name, "labels": dict(labels), "value": value}
                    for (name, labels), value in sorted(self._counters.items())
                ],
                "gauges": [
                    {"name": name, "labels": dict(labels), "value": value}
                    for (name, labels), value in sorted(self._gauges.items())
                ],
                "histograms": [
                    {"name": name, "labels": dict(labels), **hist.snapshot()}
                    for (name, labels), hist in sorted(self._hists.items())
                ],
            }


_RECORDER = TraceRecorder()


def get_recorder() -> TraceRecorder:
    return _RECORDER


def is_enabled() -> bool:
    return ENABLED


def enable(max_events: Optional[int] = None, reset: bool = True) -> None:
    """Turn tracing on. ``reset`` (default) clears previously recorded data."""
    global ENABLED
    if max_events is not None:
        _RECORDER.set_max_events(max_events)
    if reset:
        _RECORDER.clear()
    ENABLED = True


def disable() -> None:
    global ENABLED
    ENABLED = False


@contextmanager
def observe(max_events: Optional[int] = None, reset: Optional[bool] = None) -> Iterator[TraceRecorder]:
    """Scoped tracing: enabled inside the block, prior state restored on exit
    (both the enabled flag and any ``max_events`` override).

    ``reset`` defaults to True when tracing was off (a fresh scoped capture)
    and False when tracing is already on — a nested ``observe`` inside a
    process-wide ``enable()`` session must not destroy the outer session's
    recorded data; for the same reason a nested observe IGNORES a
    ``max_events`` override (the ring buffer is shared, so lowering it would
    evict the outer session's events). Recorded data is *kept* on exit so the
    caller can export it::

        with obs.observe() as rec: run_epoch(...)
        print(obs.export.summary())
    """
    global ENABLED
    previous = ENABLED
    previous_max = _RECORDER.max_events
    if reset is None:
        reset = not previous
    if previous:
        max_events = None  # shared ring: never rebound under an outer session
    enable(max_events=max_events, reset=reset)
    try:
        yield _RECORDER
    finally:
        ENABLED = previous
        _RECORDER._restore_max_events(previous_max)


@contextmanager
def span(name: str, **attrs: Any) -> Iterator[None]:
    """Record a wall-clock span (monotonic clock) around the enclosed block.

    Hot call sites should guard entry with ``if trace.ENABLED:`` so the
    disabled path never pays the context-manager machinery; calling this with
    tracing off is still correct (it no-ops).
    """
    if not ENABLED:
        yield
        return
    rec = _RECORDER
    stack = rec._span_stack()
    depth = len(stack)
    stack.append((name, attrs))
    start = time.monotonic()
    try:
        yield
    finally:
        duration = time.monotonic() - start
        stack.pop()
        rec.add_span(name, start, duration, depth, attrs)


def annotate_current_span(**attrs: Any) -> None:
    """Amend the innermost open span's attributes (recorded at span exit).

    Lets a callee correct a label the caller could not know — e.g. the jit
    dispatcher rewriting ``path="jit"`` to ``path="eager_fallback"`` on the
    enclosing ``metric.update`` span when an unhashable static forces eager
    dispatch. No-op with tracing off or outside any span.
    """
    if not ENABLED:
        return
    stack = _RECORDER._span_stack()
    if stack:
        stack[-1][1].update(attrs)


def event(name: str, **attrs: Any) -> None:
    """Record an instant event (no duration)."""
    if ENABLED:
        _RECORDER.add_event(name, **attrs)


def inc(name: str, value: float = 1.0, **labels: Any) -> None:
    """Increment a counter."""
    if ENABLED:
        _RECORDER.inc(name, value, **labels)


def set_gauge(name: str, value: float, **labels: Any) -> None:
    """Set a gauge to its current value (last write wins)."""
    if ENABLED:
        _RECORDER.set_gauge(name, value, **labels)


def observe_duration(name: str, seconds: float, **labels: Any) -> None:
    """Feed one duration sample into a histogram."""
    if ENABLED:
        _RECORDER.observe_duration(name, seconds, **labels)


def record_warning(message: str) -> bool:
    """Route a warning through the event log; False means duplicate (suppress)."""
    if not ENABLED:
        return True
    return _RECORDER.record_warning(message)
