"""Declarative metric-health watchdogs: rules, a firing state machine, egress.

Counterpart of ``torchmetrics_tpu/obs/alerts.py``, plain Python as there, with the
same rule kinds, state machine, history and exported state, so an engine's state
moves between the packages inside a session bundle.

The value timelines (:mod:`torchmetrics_tpu_torch.obs.values`) and the recorder's
counters/gauges (:mod:`torchmetrics_tpu_torch.obs.trace`) say what the runtime and
its metrics are doing; this module decides whether that is *healthy*. An
:class:`AlertEngine` holds declarative :class:`AlertRule` specs and, on every
:meth:`~AlertEngine.evaluate`, drives each matched series through the
Prometheus-style ``inactive → pending → firing → resolved`` state machine:

Rule kinds (over value timelines via ``metric=``/``leaf=`` globs, or over
recorder counter/gauge series via ``series=``):

- ``non_finite`` — the latest value is NaN or ±Inf.
- ``bounds`` — the latest value is outside its declared range: the rule's
  ``min_value``/``max_value``, else the metric's ``Metric.value_bounds``
  metadata (falling back to the plot bounds, e.g. ``[0, 1]`` for accuracy).
- ``frozen`` — the last ``frozen_for`` evaluations produced the exact same
  value (a stuck pipeline keeps computing; the number never moves).
- ``jump`` — the latest value's z-score against a rolling window of the
  previous ``window`` values exceeds ``z_threshold`` (drift/spike detector).
- ``absent`` — no new sample within ``max_age_seconds`` of wall clock (or no
  matching series ever recorded): the silent-death watchdog.
- ``threshold`` — a recorder counter/gauge is ``above``/``below`` a limit
  (e.g. ``updates_quarantined`` climbing, queue depth exploding).

``for_seconds`` adds a pending dwell (the Prometheus ``for:`` duration): the
condition must hold that long before the alert fires. Every transition lands
in a bounded history ring, in an optional JSONL sink (single ``O_APPEND``
lines; :func:`AlertEngine.write_history` dumps the full ring atomically via
``utils/fileio``), in the trace event log, and — via
:meth:`~AlertEngine.record_gauges` — as Prometheus ``ALERTS``-style series
(``tm_tpu_alerts{alertname,alertstate,...} 1``) plus ``alerts.firing`` /
``alerts.pending`` totals. :meth:`~AlertEngine.fire_resolve_times` derives
per-episode ``time_to_fire`` (pending→firing) and ``time_to_resolve``
(firing→resolved) wall deltas from that same bounded history —
``record_gauges`` publishes the latest episode per (rule, series) as
``alerts.time_to_fire_seconds`` / ``alerts.time_to_resolve_seconds``.

A process-global engine (:func:`install` / :func:`get_engine`) is what the JAX
package's introspection server and cross-host aggregation read; in the port those
come with the obs plane. The streaming engine's per-chunk seam
(``PipelineConfig.alert_engine``) evaluates mid-stream and triggers a
flight-recorder dump when a value watchdog fires.

Pure stdlib; evaluation is explicitly driven (scrapes, the pipeline seam, or
user calls) — there is no background thread, and a process that never builds
an engine pays nothing.
"""

from __future__ import annotations

import fnmatch
import json
import math
import os
import threading
import time
import warnings
from collections import deque
from dataclasses import asdict, dataclass
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torchmetrics_tpu_torch.obs.trace as trace
import torchmetrics_tpu_torch.obs.values as values_mod

__all__ = [
    "KINDS",
    "AlertEngine",
    "AlertRule",
    "configure",
    "get_engine",
    "install",
    "uninstall",
]

KINDS = ("non_finite", "bounds", "frozen", "jump", "absent", "threshold")

# state-machine states; "resolved" appears only on transitions/history (a
# resolved alert's live state returns to "inactive", like Prometheus)
STATE_INACTIVE = "inactive"
STATE_PENDING = "pending"
STATE_FIRING = "firing"
STATE_RESOLVED = "resolved"

# kinds that can watch value timelines; recorder series accept every kind
_VALUE_KINDS = frozenset({"non_finite", "bounds", "frozen", "jump", "absent"})


@dataclass
class AlertRule:
    """One declarative watchdog. See the module docstring for the kinds.

    Exactly one source: ``metric=`` (glob over value-timeline metric class
    names, with ``leaf=`` narrowing the scalar leaf) or ``series=`` (glob over
    recorder counter/gauge names, with ``labels=`` a required label subset).
    Value kinds default to ``metric="*"`` when neither is given;
    ``threshold`` requires ``series=``.

    ``tenant=`` is a glob over the tenant attribution
    (:mod:`~torchmetrics_tpu_torch.obs.scope`) of either source: ``tenant="acme"``
    targets one tenant, ``tenant="team-*"`` a cohort, and the default
    ``None`` watches everything — tenanted and untenanted alike. A rule with
    ``tenant=`` set only ever matches series that *carry* a tenant label.
    """

    name: str
    kind: str
    metric: Optional[str] = None
    leaf: str = "*"
    series: Optional[str] = None
    labels: Optional[Dict[str, str]] = None
    tenant: Optional[str] = None
    for_seconds: float = 0.0
    severity: str = "warning"
    # bounds
    min_value: Optional[float] = None
    max_value: Optional[float] = None
    # frozen
    frozen_for: int = 3
    # jump
    window: int = 20
    z_threshold: float = 4.0
    min_samples: int = 5
    # absent
    max_age_seconds: float = 60.0
    # threshold
    above: Optional[float] = None
    below: Optional[float] = None

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"Unknown alert kind {self.kind!r}; expected one of {KINDS}")
        if self.metric is not None and self.series is not None:
            raise ValueError(
                f"Rule {self.name!r} names both a value source (metric=) and a series"
                " source (series=); pick one"
            )
        if self.kind == "threshold":
            if self.series is None:
                raise ValueError(f"threshold rule {self.name!r} requires `series=`")
            if self.above is None and self.below is None:
                raise ValueError(f"threshold rule {self.name!r} requires `above=` or `below=`")
        elif self.metric is None and self.series is None:
            self.metric = "*"
        # the kind/source compatibility table, enforced rather than implied
        if self.series is None and self.kind not in _VALUE_KINDS:
            raise ValueError(
                f"Rule {self.name!r}: kind {self.kind!r} cannot watch value"
                f" timelines; value kinds are {sorted(_VALUE_KINDS)}"
            )
        if self.frozen_for < 2:
            raise ValueError(f"Expected `frozen_for` >= 2, got {self.frozen_for}")
        if self.for_seconds < 0:
            raise ValueError(f"Expected `for_seconds` >= 0, got {self.for_seconds}")

    @property
    def source(self) -> str:
        return "values" if self.series is None else "series"


def _coerce_rule(rule: Any) -> AlertRule:
    if isinstance(rule, AlertRule):
        return rule
    if isinstance(rule, dict):
        return AlertRule(**rule)
    raise TypeError(f"Expected an AlertRule or a rule dict, got {type(rule).__name__}")


class AlertEngine:
    """Evaluate declarative rules over value timelines and recorder series.

    Args:
        rules: initial :class:`AlertRule` specs (or plain dicts).
        recorder: the :class:`~torchmetrics_tpu_torch.obs.trace.TraceRecorder` whose
            counters/gauges series rules read (default: the process-global one).
        value_log: the :class:`~torchmetrics_tpu_torch.obs.values.ValueLog` value
            rules read (default: the process-global one).
        history: bounded transition-history ring size.
        sink_path: optional JSONL path; every transition appends one line
            (single ``O_APPEND`` write, concurrent-appender safe).
        clock: wall-clock source (injectable for deterministic tests).
    """

    def __init__(
        self,
        rules: Iterable[Any] = (),
        recorder: Optional[trace.TraceRecorder] = None,
        value_log: Optional[values_mod.ValueLog] = None,
        history: int = 256,
        sink_path: Optional[str] = None,
        clock=time.time,
    ) -> None:
        self._lock = threading.RLock()
        self._rules: List[AlertRule] = []
        self._recorder = recorder
        self._value_log = value_log
        self._clock = clock
        self.sink_path = sink_path
        self._sink_warned = False
        self._history: deque = deque(maxlen=max(1, int(history)))
        # (rule.name, series_key) -> live alert record
        self._alerts: Dict[Tuple[str, str], Dict[str, Any]] = {}
        # engine-side sampled timelines for recorder series (frozen/jump/absent
        # need history the last-write-wins counters/gauges don't keep); bounded
        # by max_sampled_series (churning labelsets — per-pipeline inst
        # ordinals, say — must not grow the engine without bound)
        self._samples: Dict[Tuple[str, str], Dict[str, Any]] = {}
        self.samples_dropped = 0
        # ALERTS-style labelsets written last record_gauges, for zero-on-clear
        self._gauge_keys: set = set()
        self.evaluations = 0
        for rule in rules:
            self.add_rule(rule)

    # ------------------------------------------------------------------- rules

    def add_rule(self, rule: Any = None, **kwargs: Any) -> AlertRule:
        """Add one rule (an :class:`AlertRule`, a dict, or keyword fields)."""
        spec = _coerce_rule(rule if rule is not None else kwargs)
        with self._lock:
            if any(existing.name == spec.name for existing in self._rules):
                raise ValueError(f"Duplicate alert rule name {spec.name!r}")
            self._rules.append(spec)
        return spec

    def rules(self) -> List[AlertRule]:
        with self._lock:
            return list(self._rules)

    def clear(self) -> None:
        """Drop all live alert state, sampled series and history (rules stay)."""
        with self._lock:
            self._alerts.clear()
            self._samples.clear()
            self._history.clear()
            self._gauge_keys.clear()
            self.evaluations = 0
            self.samples_dropped = 0

    # ------------------------------------------------------------- observations

    def _rec(self) -> trace.TraceRecorder:
        return self._recorder if self._recorder is not None else trace.get_recorder()

    def _log(self) -> values_mod.ValueLog:
        return self._value_log if self._value_log is not None else values_mod.get_log()

    @staticmethod
    def _series_label(name: str, labels: Dict[str, Any]) -> str:
        if not labels:
            return name
        body = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
        return f"{name}{{{body}}}"

    def _value_observations(
        self, rule: AlertRule, all_series: List[Dict[str, Any]]
    ) -> List[Dict[str, Any]]:
        rows = []
        for series in all_series:
            if rule.metric is not None and not fnmatch.fnmatchcase(series["metric"], rule.metric):
                continue
            if not fnmatch.fnmatchcase(series["leaf"], rule.leaf):
                continue
            tenant = series.get("tenant") or None
            if rule.tenant is not None and (
                tenant is None or not fnmatch.fnmatchcase(tenant, rule.tenant)
            ):
                # a tenant= rule only ever matches series that CARRY a tenant
                # (tenant="*" must not sweep in untenanted traffic)
                continue
            key = f"{series['metric']}[{series['inst']}].{series['leaf']}"
            if tenant:
                # tenant is a series dimension: the same metric under two
                # tenants drives two independent alert state machines
                key += f"@{tenant}"
            rows.append(
                {
                    "key": key,
                    "metric": series["metric"],
                    "tenant": tenant,
                    "points": series["points"],  # (step, wall, value)
                    "bounds": series["bounds"],
                }
            )
        return rows

    # cardinality cap on the sampled-series tables (the TraceRecorder
    # max_series pattern): new (rule, labelset) keys past the cap are refused
    # and counted in `samples_dropped` instead of growing forever
    max_sampled_series: int = 4096

    def _series_observations(self, rule: AlertRule, now: float) -> List[Dict[str, Any]]:
        """Sample matching recorder counters/gauges into engine-side timelines."""
        snap_rows: List[Tuple[str, Dict[str, Any], float]] = []
        rec = self._rec()
        with rec._lock:
            for (name, labels), value in list(rec._counters.items()) + list(rec._gauges.items()):
                label_dict = dict(labels)
                if not fnmatch.fnmatchcase(name, rule.series or ""):
                    continue
                if rule.labels and any(label_dict.get(k) != v for k, v in rule.labels.items()):
                    continue
                series_tenant = label_dict.get("tenant")
                if rule.tenant is not None and (
                    series_tenant is None
                    or not fnmatch.fnmatchcase(str(series_tenant), rule.tenant)
                ):
                    continue
                snap_rows.append((name, label_dict, float(value)))
        rows = []
        for name, label_dict, value in snap_rows:
            key = self._series_label(name, label_dict)
            sample = self._samples.get((rule.name, key))
            if sample is None:
                if len(self._samples) >= self.max_sampled_series:
                    self.samples_dropped += 1
                    continue  # the rule cannot judge a series it refused to track
                sample = self._samples[(rule.name, key)] = {
                    "points": deque(maxlen=max(rule.window + rule.frozen_for + 2, 64)),
                    "last_change": now,
                }
            points = sample["points"]
            if not points or points[-1][2] != value:
                sample["last_change"] = now
            points.append((len(points), now, value))
            rows.append(
                {
                    "key": key,
                    "metric": name,
                    "tenant": label_dict.get("tenant") or None,
                    "points": list(points),
                    "bounds": None,
                    "last_change": sample["last_change"],
                }
            )
        return rows

    # -------------------------------------------------------------- conditions

    @staticmethod
    def _breach(rule: AlertRule, obs: Dict[str, Any], now: float) -> Tuple[bool, Optional[float], str]:
        """(breached, latest value, human detail) for one observation."""
        points = obs["points"]
        latest = points[-1][2] if points else None
        if rule.kind == "absent":
            if not points:
                return True, None, "no samples ever recorded"
            anchor = obs.get("last_change", points[-1][1])
            age = now - anchor
            if age > rule.max_age_seconds:
                return True, latest, f"no fresh sample for {age:.1f}s (budget {rule.max_age_seconds:g}s)"
            return False, latest, ""
        if latest is None:
            return False, None, ""
        if rule.kind == "non_finite":
            if not math.isfinite(latest):
                return True, latest, f"value is {latest!r}"
            return False, latest, ""
        if rule.kind == "bounds":
            lo, hi = rule.min_value, rule.max_value
            declared = obs.get("bounds")
            if lo is None and hi is None and declared is not None:
                lo, hi = declared
            if lo is None and hi is None:
                return False, latest, ""  # nothing declared: rule cannot judge
            if not math.isfinite(latest):
                return True, latest, f"value is {latest!r} (bounds [{lo}, {hi}])"
            if lo is not None and latest < lo:
                return True, latest, f"value {latest:g} below declared minimum {lo:g}"
            if hi is not None and latest > hi:
                return True, latest, f"value {latest:g} above declared maximum {hi:g}"
            return False, latest, ""
        if rule.kind == "frozen":
            if len(points) < rule.frozen_for:
                return False, latest, ""
            tail = [p[2] for p in points[-rule.frozen_for :]]
            if all(v == tail[0] for v in tail):
                return True, latest, f"unchanged at {tail[0]:g} for the last {rule.frozen_for} evaluations"
            return False, latest, ""
        if rule.kind == "jump":
            history = [p[2] for p in points[:-1] if math.isfinite(p[2])][-rule.window :]
            if len(history) < rule.min_samples or not math.isfinite(latest):
                return False, latest, ""
            mean = sum(history) / len(history)
            var = sum((v - mean) ** 2 for v in history) / len(history)
            std = math.sqrt(var)
            if std == 0.0:
                breached = latest != mean
                z = math.inf if breached else 0.0
            else:
                z = abs(latest - mean) / std
                breached = z > rule.z_threshold
            if breached:
                return True, latest, (
                    f"z-score {z:g} vs rolling window (mean {mean:g}, std {std:g},"
                    f" n={len(history)}) exceeds {rule.z_threshold:g}"
                )
            return False, latest, ""
        if rule.kind == "threshold":
            if rule.above is not None and latest > rule.above:
                return True, latest, f"value {latest:g} above {rule.above:g}"
            if rule.below is not None and latest < rule.below:
                return True, latest, f"value {latest:g} below {rule.below:g}"
            return False, latest, ""
        return False, latest, ""  # pragma: no cover - kinds validated at construction

    # ------------------------------------------------------------- state machine

    def evaluate(
        self, now: Optional[float] = None, recorder: Optional[trace.TraceRecorder] = None
    ) -> List[Dict[str, Any]]:
        """One evaluation pass over every rule; returns the transitions.

        ``recorder`` redirects the transition egress (counters + trace events)
        — the introspection server passes its own recorder so a
        custom-recorder server's alert telemetry stays on its own page instead
        of splitting across sessions.
        """
        now = self._clock() if now is None else float(now)
        transitions: List[Dict[str, Any]] = []
        value_series: Optional[List[Dict[str, Any]]] = None
        with self._lock:
            self.evaluations += 1
            for rule in self._rules:
                if rule.source == "values":
                    if value_series is None:
                        # ONE snapshot of the value log per pass, shared by
                        # every value rule — series() copies each series' full
                        # point ring, which the per-chunk pipeline seam must
                        # not pay once per rule
                        value_series = self._log().series()
                    observations = self._value_observations(rule, value_series)
                else:
                    observations = self._series_observations(rule, now)
                placeholder_key = rule.metric or rule.series or "*"
                if not observations and rule.kind == "absent":
                    # nothing matched at all: the silent-death case the absence
                    # watchdog exists for. A non-glob tenant= rule carries its
                    # tenant onto the placeholder, so the never-recorded tenant
                    # is still NAMED on ?tenant= views, /healthz and the fleet
                    # merge — the one tenant an absence watchdog exists to name
                    placeholder_tenant = None
                    if rule.tenant is not None and not any(c in rule.tenant for c in "*?["):
                        placeholder_tenant = rule.tenant
                    observations = [
                        {
                            "key": placeholder_key,
                            "metric": placeholder_key,
                            "tenant": placeholder_tenant,
                            "points": [],
                            "bounds": None,
                        }
                    ]
                observed = set()
                for obs in observations:
                    observed.add(obs["key"])
                    breached, value, detail = self._breach(rule, obs, now)
                    transition = self._advance(
                        rule, obs["key"], breached, value, detail, now, tenant=obs.get("tenant")
                    )
                    if transition is not None:
                        transitions.append(transition)
                # an active alert whose series was NOT observed this pass can
                # never clear through _breach again — resolve it instead of
                # stranding it firing forever (the superseded nothing-matched
                # placeholder once real series appear, or a series wiped by a
                # log/recorder clear). Exception: an absent rule's REAL series
                # vanishing is still absence, and total disappearance re-enters
                # through the placeholder above.
                for (rule_name, key), alert in list(self._alerts.items()):
                    if rule_name != rule.name or key in observed:
                        continue
                    if alert["state"] not in (STATE_PENDING, STATE_FIRING):
                        continue
                    if rule.kind == "absent" and key != placeholder_key:
                        continue
                    transition = self._advance(
                        rule, key, False, alert["value"], "", now, tenant=alert.get("tenant")
                    )
                    if transition is not None:
                        transitions.append(transition)
        for transition in transitions:
            self._egress(transition, recorder)
        return transitions

    def _advance(
        self,
        rule: AlertRule,
        series_key: str,
        breached: bool,
        value: Optional[float],
        detail: str,
        now: float,
        tenant: Optional[str] = None,
    ) -> Optional[Dict[str, Any]]:
        """Drive one (rule, series) through the state machine; returns the
        transition record when the state changed. Caller holds the lock."""
        key = (rule.name, series_key)
        alert = self._alerts.get(key)
        if alert is None:
            if not breached:
                return None
            alert = self._alerts[key] = {
                "rule": rule.name,
                "kind": rule.kind,
                "source": rule.source,
                "severity": rule.severity,
                "series": series_key,
                "tenant": tenant,
                "state": STATE_INACTIVE,
                "since": None,
                "fired_at": None,
                "resolved_at": None,
                "value": None,
                "detail": "",
            }
        state = alert["state"]
        alert["value"] = value
        if breached:
            alert["detail"] = detail
            if state == STATE_INACTIVE:
                alert["since"] = now
                alert["resolved_at"] = None
                if rule.for_seconds > 0:
                    alert["state"] = STATE_PENDING
                    return self._transition(alert, STATE_INACTIVE, STATE_PENDING, now)
                alert["state"] = STATE_FIRING
                alert["fired_at"] = now
                return self._transition(alert, STATE_INACTIVE, STATE_FIRING, now)
            if state == STATE_PENDING and now - alert["since"] >= rule.for_seconds:
                alert["state"] = STATE_FIRING
                alert["fired_at"] = now
                return self._transition(alert, STATE_PENDING, STATE_FIRING, now)
            return None
        if state == STATE_PENDING:
            alert["state"] = STATE_INACTIVE
            alert["since"] = None
            return self._transition(alert, STATE_PENDING, STATE_INACTIVE, now)
        if state == STATE_FIRING:
            alert["state"] = STATE_INACTIVE
            alert["since"] = None
            alert["resolved_at"] = now
            return self._transition(alert, STATE_FIRING, STATE_RESOLVED, now)
        return None

    def _transition(self, alert: Dict[str, Any], prev: str, to: str, now: float) -> Dict[str, Any]:
        record = {
            "rule": alert["rule"],
            "kind": alert["kind"],
            "source": alert["source"],
            "severity": alert["severity"],
            "series": alert["series"],
            "tenant": alert.get("tenant"),
            "from": prev,
            "to": to,
            "at": now,
            "value": alert["value"],
            "detail": alert["detail"],
        }
        self._history.append(record)
        return record

    def _egress(
        self, transition: Dict[str, Any], recorder: Optional[trace.TraceRecorder] = None
    ) -> None:
        """Transition fan-out: trace counters/events + the JSONL sink."""
        rec = recorder if recorder is not None else self._rec()
        # tenant always explicit (None = stripped by scope.tag): an untenanted
        # alert evaluated inside a pipeline's tenant scope must NOT have its
        # egress counters mis-attributed to that ambient tenant
        tenant = transition.get("tenant")
        rec.inc("alerts.transitions", rule=transition["rule"], to=transition["to"], tenant=tenant)
        if transition["to"] == STATE_FIRING:
            rec.inc("alerts.fired", rule=transition["rule"], tenant=tenant)
        if trace.ENABLED:
            rec.add_event(
                "alerts.transition",
                kind="event",
                rule=transition["rule"],
                series=transition["series"],
                to=transition["to"],
                detail=transition["detail"],
            )
        if self.sink_path is None:
            return
        try:
            directory = os.path.dirname(os.path.abspath(self.sink_path))
            os.makedirs(directory, exist_ok=True)
            # single O_APPEND line: concurrent appenders never lose each
            # other's records (the bench-history pattern, obs/regress.py)
            with open(self.sink_path, "a", encoding="utf-8") as fh:
                fh.write(json.dumps(transition, sort_keys=True, default=str) + "\n")
        except OSError as err:
            if not self._sink_warned:
                self._sink_warned = True
                warnings.warn(
                    f"Alert JSONL sink {self.sink_path!r} is unwritable"
                    f" ({type(err).__name__}: {err}); transitions keep their"
                    " in-memory history but lose the on-disk trail.",
                    RuntimeWarning,
                    stacklevel=3,
                )

    # ----------------------------------------------------------------- readers

    def active(self) -> List[Dict[str, Any]]:
        """Pending + firing alerts (plain dicts, sorted, safe to serialize)."""
        with self._lock:
            rows = [
                dict(alert)
                for alert in self._alerts.values()
                if alert["state"] in (STATE_PENDING, STATE_FIRING)
            ]
        rows.sort(key=lambda a: (a["rule"], a["series"]))
        return rows

    def firing(self) -> List[Dict[str, Any]]:
        return [alert for alert in self.active() if alert["state"] == STATE_FIRING]

    def history(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(record) for record in self._history]

    def fire_resolve_times(self) -> List[Dict[str, Any]]:
        """Fire/resolve episodes derived from the bounded transition history.

        One row per *fire* of a ``(rule, series)`` pair, oldest first::

            {"rule", "series", "tenant", "severity",
             "breach_at",            # when the breach entered the machine
             "fired_at", "time_to_fire",      # fired_at - breach_at (0 when
                                              #  the rule has no pending dwell)
             "resolved_at", "time_to_resolve"}  # None while still firing

        ``time_to_fire`` is the pending→firing wall delta (the dwell the
        operator actually waited); ``time_to_resolve`` the firing→resolved
        delta. A pending episode that cleared without firing produces no row.
        This is the read behind the ``alerts.time_to_*_seconds`` gauges —
        derived purely from history, so it is as bounded as the history ring.
        """
        episodes: List[Dict[str, Any]] = []
        pending_at: Dict[Tuple[str, str], float] = {}
        firing: Dict[Tuple[str, str], Dict[str, Any]] = {}
        for record in self.history():
            key = (record["rule"], record["series"])
            to = record["to"]
            if to == STATE_PENDING:
                pending_at[key] = record["at"]
            elif to == STATE_FIRING:
                breach_at = pending_at.pop(key, record["at"])
                episode = {
                    "rule": record["rule"],
                    "series": record["series"],
                    "tenant": record.get("tenant"),
                    "severity": record.get("severity"),
                    "breach_at": breach_at,
                    "fired_at": record["at"],
                    "time_to_fire": record["at"] - breach_at,
                    "resolved_at": None,
                    "time_to_resolve": None,
                }
                episodes.append(episode)
                firing[key] = episode
            elif to == STATE_RESOLVED:
                episode = firing.pop(key, None)
                if episode is not None:
                    episode["resolved_at"] = record["at"]
                    episode["time_to_resolve"] = record["at"] - episode["fired_at"]
            elif to == STATE_INACTIVE:
                pending_at.pop(key, None)  # a dwell that never fired
        return episodes

    def export_state(self) -> Dict[str, Any]:
        """Serializable snapshot of the engine: rules, live state machines,
        transition history.

        The session-bundle seam (:mod:`torchmetrics_tpu_torch.engine.migrate`): a
        live session's alert machines — a ``pending`` alert mid-dwell, a
        ``firing`` one awaiting its resolve — are part of what a rolling
        deploy must not lose. Plain data only (rules via ``asdict``), suitable
        for JSON.
        """
        with self._lock:
            return {
                "rules": [asdict(rule) for rule in self._rules],
                "alerts": [dict(alert) for alert in self._alerts.values()],
                "history": [dict(record) for record in self._history],
                "evaluations": self.evaluations,
            }

    def restore_state(self, state: Dict[str, Any], rules: bool = True) -> int:
        """Re-install live alert machines exported by :meth:`export_state`.

        Restored ``pending``/``firing`` alerts resume **with their dwell
        clocks intact**: ``since``/``fired_at`` carry the origin host's wall
        stamps, so a pending alert fires after its *remaining* ``for_seconds``
        dwell (not a fresh one) and a firing alert's eventual
        ``time_to_resolve`` spans the migration. History extends the bounded
        ring oldest-first — transitions the engine *already holds* (a restore
        back into the origin process, or two sessions sharing one engine) are
        skipped by exact match, so :meth:`fire_resolve_times` never derives
        phantom episodes from duplicated records. With ``rules`` (default),
        rules from the snapshot that this engine does not already have (by
        name) are re-added — a fresh engine on the restoring host picks up
        the session's watchdogs wholesale. Returns the number of live
        machines restored.
        """
        restored = 0
        with self._lock:
            if rules:
                have = {rule.name for rule in self._rules}
                for spec in state.get("rules") or []:
                    if spec.get("name") not in have:
                        self._rules.append(AlertRule(**spec))
            for alert in state.get("alerts") or []:
                rule_name, series = alert.get("rule"), alert.get("series")
                if not rule_name or not series:
                    continue
                self._alerts[(rule_name, series)] = dict(alert)
                restored += 1
            seen = {
                (r.get("rule"), r.get("series"), r.get("from"), r.get("to"), r.get("at"))
                for r in self._history
            }
            fresh = []
            for record in state.get("history") or []:
                key = (
                    record.get("rule"),
                    record.get("series"),
                    record.get("from"),
                    record.get("to"),
                    record.get("at"),
                )
                if key in seen:
                    continue
                seen.add(key)
                fresh.append(dict(record))
            if fresh:
                # merge by wall stamp, NOT by appending at the tail: the
                # engine may already hold transitions newer than the
                # snapshot's (shared engine, origin records aged out of its
                # ring), and fire_resolve_times derives episodes from ring
                # ORDER — an old resolve appended after a newer fire would
                # pair into an episode with a negative time_to_resolve
                merged = sorted(
                    list(self._history) + fresh, key=lambda r: float(r.get("at") or 0.0)
                )
                self._history.clear()
                self._history.extend(merged)  # bounded deque keeps the newest
        return restored

    def report(self) -> Dict[str, Any]:
        """The ``GET /alerts`` payload."""
        with self._lock:
            rules = [asdict(rule) for rule in self._rules]
            tracked = [dict(alert) for alert in self._alerts.values()]
        active = [a for a in tracked if a["state"] in (STATE_PENDING, STATE_FIRING)]
        active.sort(key=lambda a: (a["rule"], a["series"]))
        return {
            "rules": rules,
            "n_rules": len(rules),
            "active": active,
            "firing": [a for a in active if a["state"] == STATE_FIRING],
            "tracked_series": len(tracked),
            "history": self.history(),
            "evaluations": self.evaluations,
        }

    def write_history(self, path: str) -> int:
        """Atomically dump the transition history as JSONL; returns line count.

        Crash-safe via :func:`torchmetrics_tpu_torch.utils.fileio.atomic_write_text`
        (the append-per-transition sink is the live trail; this is the
        post-mortem export).
        """
        from torchmetrics_tpu_torch.utils.fileio import atomic_write_text

        lines = [json.dumps(record, sort_keys=True, default=str) for record in self.history()]
        atomic_write_text(path, "\n".join(lines) + ("\n" if lines else ""))
        return len(lines)

    # ------------------------------------------------------------------ gauges

    def record_gauges(self, recorder: Optional[trace.TraceRecorder] = None) -> Dict[str, int]:
        """Write Prometheus ``ALERTS``-style series into the recorder.

        ``alerts{alertname,alertstate,series,kind,severity}`` is 1 for every
        pending/firing alert; labelsets that were active on the previous call
        but no longer are get an explicit 0 (last-write-wins gauges cannot be
        deleted, and a scraper must see the resolve edge). ``alerts.firing`` /
        ``alerts.pending`` carry the totals. Not gated on ``trace.ENABLED`` —
        like the memory-accounting gauges, an explicit call is the opt-in.
        """
        rec = recorder if recorder is not None else self._rec()
        live: set = set()
        n_firing = n_pending = 0
        for alert in self.active():
            labels = {
                "alertname": alert["rule"],
                "alertstate": alert["state"],
                "series": alert["series"],
                "kind": alert["kind"],
                "severity": alert["severity"],
            }
            if alert.get("tenant"):
                labels["tenant"] = alert["tenant"]
            live.add(tuple(sorted(labels.items())))
            # tenant=None for untenanted alerts = the ambient-injection opt-out
            # (scope.tag strips it), so a scrape from inside a tenant scope
            # cannot mis-attribute another alert — and the written labelset
            # matches the `live` key exactly, keeping zero-on-clear correct
            rec.set_gauge("alerts", 1.0, **{"tenant": None, **labels})
            if alert["state"] == STATE_FIRING:
                n_firing += 1
            else:
                n_pending += 1
        with self._lock:
            for stale in self._gauge_keys - live:
                rec.set_gauge("alerts", 0.0, **{"tenant": None, **dict(stale)})
            self._gauge_keys = live
        rec.set_gauge("alerts.firing", float(n_firing), tenant=None)
        rec.set_gauge("alerts.pending", float(n_pending), tenant=None)
        # operational-latency gauges: the LATEST episode's pending→firing and
        # firing→resolved wall deltas per (rule, series) — what a dashboard
        # plots as "how fast do our watchdogs react". Bounded by the same
        # cardinality as the ALERTS series above.
        latest: Dict[Tuple[str, str], Dict[str, Any]] = {}
        for episode in self.fire_resolve_times():
            latest[(episode["rule"], episode["series"])] = episode
        for episode in latest.values():
            labels = {"alertname": episode["rule"], "series": episode["series"]}
            if episode.get("tenant"):
                labels["tenant"] = episode["tenant"]
            rec.set_gauge(
                "alerts.time_to_fire_seconds",
                float(episode["time_to_fire"]),
                **{"tenant": None, **labels},
            )
            # the pair always describes ONE episode: a refire that has not
            # resolved yet must not leave the PREVIOUS episode's resolve
            # delta standing next to the new fire delta (zero = "current
            # episode unresolved", the ALERTS zero-on-clear convention)
            rec.set_gauge(
                "alerts.time_to_resolve_seconds",
                float(episode["time_to_resolve"]) if episode["time_to_resolve"] is not None else 0.0,
                **{"tenant": None, **labels},
            )
        return {"firing": n_firing, "pending": n_pending}


# ------------------------------------------------------- module-level singleton

_ENGINE: Optional[AlertEngine] = None
_ENGINE_LOCK = threading.Lock()


def get_engine() -> Optional[AlertEngine]:
    """The process-wide engine installed via :func:`install`/:func:`configure`."""
    return _ENGINE


def install(engine: AlertEngine) -> AlertEngine:
    """Install ``engine`` as the process-wide default (what ``/alerts``,
    ``/healthz`` and cross-host aggregation read)."""
    global _ENGINE
    with _ENGINE_LOCK:
        _ENGINE = engine
    return engine


def uninstall() -> None:
    global _ENGINE
    with _ENGINE_LOCK:
        _ENGINE = None


def configure(*rules: Any, **kwargs: Any) -> AlertEngine:
    """Build an :class:`AlertEngine` from rule specs and install it."""
    return install(AlertEngine(rules=rules, **kwargs))
