"""Per-metric value timelines: what the metrics *produce*, recorded over time.

Counterpart of ``torchmetrics_tpu/obs/values.py``, plain Python as there. A NaN
accuracy, a frozen F1 or a drifting AUROC is invisible to spans and counters; this
module is the timeline of the values:

- :class:`ValueLog` — a bounded, thread-safe registry of per-metric value series.
  Each ``compute()`` result is flattened into labeled scalar leaves (dict keys become
  leaf labels, nested containers dot-join) and appended as ``(step, wall_time,
  value)`` with the metric's ``update_count`` as the step anchor. Rings are bounded
  (``max_points`` per series, ``max_series`` overall).
- :func:`record_compute` — the ``core/metric.py`` hook: called on every *fresh*
  ``compute`` behind the module flag :data:`ENABLED`.
- :func:`sample_local` — a **sync-free** sample of a live metric or collection:
  values come from ``pure_compute`` over the current local state, so the streaming
  engine's alert seam (``engine/pipeline.py``) can watch values mid-stream without a
  collective and without touching the compute cache. On the card that is one host
  read per scalar leaf, after a commit and outside any capture.

Recorded leaves also land as ``value.current`` gauges in the
:class:`~torchmetrics_tpu_torch.obs.trace.TraceRecorder`. The watchdogs over these
timelines live in :mod:`torchmetrics_tpu_torch.obs.alerts`.

Pure stdlib — values arrive as duck-typed scalars (``.item()`` / ``float()``).
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torchmetrics_tpu_torch.obs.scope as _scope
import torchmetrics_tpu_torch.obs.trace as trace

__all__ = [
    "ENABLED",
    "ValueLog",
    "disable",
    "enable",
    "get_log",
    "is_enabled",
    "iter_scalar_leaves",
    "record_compute",
    "sample_local",
]

# THE enabled flag for the passive compute hook; `if values.ENABLED:` is the
# whole cost of the disabled path in `Metric._wrapped_compute`.
ENABLED = False

_DEFAULT_MAX_POINTS = 512
_DEFAULT_MAX_SERIES = 1024

# leaf label for a bare scalar compute() result (no dict/tuple structure)
ROOT_LEAF = "value"


def _as_scalar(value: Any) -> Optional[float]:
    """Duck-typed scalar extraction: python numbers and size-1 arrays only."""
    if isinstance(value, bool):
        return float(value)
    if isinstance(value, (int, float)):
        return float(value)
    size = getattr(value, "size", None)
    if callable(size):  # a torch tensor: `size()` is its shape, `numel()` its size
        size = value.numel()
    if size == 1:
        try:
            item = value.item() if hasattr(value, "item") else value
            return float(item)
        except Exception:
            return None
    if size is None and getattr(value, "shape", None) == ():
        try:
            return float(value)
        except Exception:
            return None
    return None


def iter_scalar_leaves(value: Any, prefix: str = "") -> Iterator[Tuple[str, float]]:
    """Yield ``(leaf_label, float)`` for every scalar leaf of a compute result.

    Dict keys become leaf labels (nested dicts dot-join), tuple/list positions
    become numeric labels, and a bare scalar gets the label ``"value"``.
    Non-scalar array leaves (curves, per-class vectors) are skipped — the
    timeline tracks *scalar* health signals by design.
    """
    if isinstance(value, dict):
        for key in value:
            yield from iter_scalar_leaves(value[key], f"{prefix}{key}.")
        return
    if isinstance(value, (list, tuple)):
        for index, item in enumerate(value):
            yield from iter_scalar_leaves(item, f"{prefix}{index}.")
        return
    scalar = _as_scalar(value)
    if scalar is None:
        return
    label = prefix[:-1] if prefix else ROOT_LEAF
    yield (label, scalar)


class ValueLog:
    """Bounded, thread-safe per-metric value timelines."""

    def __init__(
        self, max_points: int = _DEFAULT_MAX_POINTS, max_series: int = _DEFAULT_MAX_SERIES
    ) -> None:
        if max_points < 1:
            raise ValueError(f"Expected `max_points` >= 1, got {max_points}")
        self._lock = threading.Lock()
        self.max_points = int(max_points)
        self.max_series = int(max_series)
        self.clear()

    def clear(self) -> None:
        with self._lock:
            # key (metric, inst, leaf, tenant-or-"") -> {"metric", "inst",
            # "leaf", "tenant", "bounds", "points": deque[(step, wall, value)]}
            self._series: Dict[Tuple[str, str, str, str], Dict[str, Any]] = {}
            self.dropped_series = 0
            self.skipped_nonscalar = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._series)

    def record(
        self,
        metric: str,
        inst: str,
        leaf: str,
        step: int,
        value: float,
        bounds: Optional[Tuple[Optional[float], Optional[float]]] = None,
        wall: Optional[float] = None,
        tenant: Optional[str] = None,
    ) -> bool:
        """Append one point; returns False when the series cap refused it.

        ``tenant`` is an extra series dimension: the same metric instance
        computed under two tenants keeps two independent timelines (the
        multi-tenant serving case), and ``None`` keeps the untenanted series
        the single-tenant world always had.
        """
        key = (str(metric), str(inst), str(leaf), str(tenant) if tenant else "")
        wall = time.time() if wall is None else wall
        with self._lock:
            row = self._series.get(key)
            if row is None:
                if len(self._series) >= self.max_series:
                    self.dropped_series += 1
                    return False
                row = self._series[key] = {
                    "metric": key[0],
                    "inst": key[1],
                    "leaf": key[2],
                    "tenant": tenant if tenant else None,
                    "bounds": None,
                    "points": deque(maxlen=self.max_points),
                }
            if bounds is not None:
                row["bounds"] = (bounds[0], bounds[1])
            row["points"].append((int(step), float(wall), float(value)))
        return True

    def series(self) -> List[Dict[str, Any]]:
        """Copies of every series (points as lists, safe to mutate/serialize)."""
        with self._lock:
            return [
                {
                    "metric": row["metric"],
                    "inst": row["inst"],
                    "leaf": row["leaf"],
                    "tenant": row["tenant"],
                    "bounds": row["bounds"],
                    "points": list(row["points"]),
                }
                for row in self._series.values()
            ]

    def restore_series(self, rows: Any) -> int:
        """Re-install serialized series rows (the :meth:`series` shape).

        The live-session migration seam (:mod:`torchmetrics_tpu_torch.engine.migrate`):
        a restored session's value timelines keep their original ``(step, wall,
        value)`` anchors — the watchdogs' frozen/jump windows and the step axis
        of every point survive the host move instead of restarting at zero.
        Appends in order (an existing series extends; the ring bound still
        drops oldest) and respects the series cap exactly like live recording.
        Points a series *already holds* are skipped by exact ``(step, wall)``
        match — restoring a session back into its origin log (or two restores
        of the same bundle) must not double the timeline and fool the frozen/
        jump windows. Returns the number of points restored.
        """
        restored = 0
        for row in rows or []:
            bounds = row.get("bounds")
            key = (
                str(row["metric"]),
                str(row.get("inst", "0")),
                str(row.get("leaf", ROOT_LEAF)),
                str(row.get("tenant")) if row.get("tenant") else "",
            )
            with self._lock:
                existing = self._series.get(key)
                seen = (
                    {(p[0], p[1]) for p in existing["points"]} if existing is not None else set()
                )
            for point in row.get("points") or []:
                step, wall, value = point[0], point[1], point[2]
                if (int(step), float(wall)) in seen:
                    continue
                if self.record(
                    row["metric"],
                    row.get("inst", "0"),
                    row.get("leaf", ROOT_LEAF),
                    step,
                    value,
                    bounds=tuple(bounds) if bounds is not None else None,
                    wall=wall,
                    tenant=row.get("tenant") or None,
                ):
                    restored += 1
        return restored

    def latest(
        self,
        metric: str,
        leaf: str = ROOT_LEAF,
        inst: Optional[str] = None,
        tenant: Optional[str] = None,
    ) -> Optional[float]:
        """Most recent value of one series (first matching inst/tenant when omitted)."""
        with self._lock:
            for (m, i, l, t), row in self._series.items():
                if (
                    m == metric
                    and l == leaf
                    and (inst is None or i == inst)
                    and (tenant is None or t == tenant)
                    and row["points"]
                ):
                    return row["points"][-1][2]
        return None

    def snapshot(self) -> Dict[str, Any]:
        """Plain-data snapshot (the shape behind value sections in exports)."""
        return {
            "series": self.series(),
            "n_series": len(self),
            "dropped_series": self.dropped_series,
            "skipped_nonscalar": self.skipped_nonscalar,
        }


_LOG = ValueLog()


def get_log() -> ValueLog:
    return _LOG


def is_enabled() -> bool:
    return ENABLED


def enable(reset: bool = True) -> None:
    """Turn the passive compute hook on; ``reset`` (default) clears history."""
    global ENABLED
    if reset:
        _LOG.clear()
    ENABLED = True


def disable() -> None:
    global ENABLED
    ENABLED = False


def _record_value_leaves(
    metric_label: str,
    inst: str,
    step: int,
    value: Any,
    bounds: Optional[Tuple[Optional[float], Optional[float]]],
    recorder: Optional[trace.TraceRecorder],
    log: Optional[ValueLog],
    tenant: Optional[str] = None,
) -> int:
    rec = recorder if recorder is not None else trace.get_recorder()
    target = log if log is not None else _LOG
    tenant_label = {"tenant": tenant} if tenant else {}
    recorded = 0
    found_any = False
    for leaf, scalar in iter_scalar_leaves(value):
        found_any = True
        if target.record(metric_label, inst, leaf, step, scalar, bounds=bounds, tenant=tenant):
            recorded += 1
            # latest value as a gauge: Prometheus/snapshot/aggregate/Perfetto
            # pick it up with no further wiring. Written straight to the
            # recorder (NOT gated on trace.ENABLED): recording values is its
            # own opt-in, like the explicit memory-accounting calls.
            rec.set_gauge(
                "value.current", scalar, metric=metric_label, inst=inst, leaf=leaf, **tenant_label
            )
            if not math.isfinite(scalar):
                rec.inc("value.nonfinite", metric=metric_label, leaf=leaf, **tenant_label)
    if not found_any:
        with target._lock:
            target.skipped_nonscalar += 1
    return recorded


def record_compute(
    metric: Any,
    value: Any,
    recorder: Optional[trace.TraceRecorder] = None,
    log: Optional[ValueLog] = None,
) -> int:
    """Record one metric's fresh ``compute()`` result into the timeline.

    The ``core/metric.py`` hook (which records into the process-global log;
    callers holding their own :class:`ValueLog` pass it as ``log``). Defensive
    end to end — a recording failure must never break ``compute`` — and
    returns the number of leaves recorded.
    """
    try:
        label = type(metric).__name__
        inst = str(getattr(metric, "_obs_instance", "0"))
        step = int(getattr(metric, "_update_count", 0) or 0)
        resolver = getattr(metric, "_resolved_value_bounds", None)
        bounds = resolver() if callable(resolver) else None
        tenant = None
        if _scope.ENABLED:
            # ambient scope wins (a shared metric computed under several
            # tenants splits per tenant); a metric constructed/adopted under a
            # tenant stays attributed even on scope-less eager paths
            tenant = _scope.current_tenant() or getattr(metric, "_obs_tenant", None)
        return _record_value_leaves(label, inst, step, value, bounds, recorder, log, tenant)
    except Exception:  # pragma: no cover - recording must never raise into compute
        return 0


def sample_local(
    obj: Any,
    recorder: Optional[trace.TraceRecorder] = None,
    log: Optional[ValueLog] = None,
) -> int:
    """Sample a live metric/collection's values WITHOUT sync or cache effects.

    Values come from ``pure_compute`` over the current local state — no
    cross-host collectives (safe per committed chunk in a multihost stream),
    no ``_computed`` cache pollution. Metrics that have never been updated are
    skipped (their defaults are not an evaluation). Works regardless of
    :data:`ENABLED` — an explicit sampling call is its own opt-in. Returns the
    number of leaves recorded.
    """
    from torchmetrics_tpu_torch.core.metric import Metric  # lazy: metric imports this module

    recorded = 0
    # a port Metric is a torch Module too (its `_modules` holds operands, not members):
    # only a collection samples its members
    metrics = [obj] if isinstance(obj, Metric) else list(obj._modules.values())
    for metric in metrics:
        if not int(getattr(metric, "_update_count", 0) or 0):
            continue
        pure_compute = getattr(metric, "pure_compute", None)
        state = getattr(metric, "_state_values", None)
        if not callable(pure_compute) or not isinstance(state, dict):
            continue
        try:
            value = pure_compute(dict(state))
        except Exception:  # a broken compute is its own (absent) signal
            continue
        recorded += record_compute(metric, value, recorder=recorder, log=log)
    return recorded
