"""Tenant/session scoping: who a span, value, alert or checkpoint belongs to.

Counterpart of ``torchmetrics_tpu/obs/scope.py``, plain Python as there. In a serving
process with many concurrent tenants, "something is quarantining batches" is useless
until it becomes "tenant acme-prod is quarantining batches". This module is that
attribution plane:

- :func:`scope` — a contextvar-based context manager. Inside
  ``with scope(tenant="acme-prod"):`` every recorder write (counters, gauges,
  histogram labels, span/event attrs — see ``TraceRecorder``), every value timeline
  point (:mod:`~torchmetrics_tpu_torch.obs.values`) and every alert observation
  (:mod:`~torchmetrics_tpu_torch.obs.alerts`) picks up the ambient tenant as a
  ``tenant`` label. Contextvars make this thread- and task-correct.
- :class:`TenantRegistry` — a **bounded** registry of tenant liveness: first/last
  activity (wall clock + a monotonic activity step), update and compute counts,
  active pipelines. Past the cap (``max_tenants``, default 1024) new tenants collapse
  into a counted ``__overflow__`` bucket with ONE loud warning.
- :func:`record_gauges` — per-tenant liveness gauges (``tenant.*``), the continuous
  checkpoint, lease and fence gauges, written straight into the recorder.
- the migration, checkpoint, lease and fence status notes that the session engine
  (``engine/migrate.py``, ``robust/fence.py``) reports here, so they outlive the
  session object whose crash or hang they describe.

- :class:`TenantQuota` / :class:`AdmissionController` — the **cost-aware admission
  plane**: per-tenant budgets (updates / estimated flops / estimated bytes / capture
  seconds per rolling window, priced by the :mod:`~torchmetrics_tpu_torch.obs.cost`
  ledger's per-dispatch counts) with an over-quota policy of ``"shed"`` (drop,
  counted, loud once) or ``"defer"`` (hold until the window rolls or the stream
  closes). Tenant ``MetricPipeline`` sessions and the ``TenantMultiplexer``
  (``engine/mux.py``) consult :func:`get_admission` per fed batch; decisions surface
  as ``tenant.quota_*`` gauges (``tenant.quota_exceeded`` is
  :class:`~torchmetrics_tpu_torch.obs.alerts.AlertRule`-compatible).
- :func:`track_thread_tenants` / :func:`thread_tenants` — the thread→tenant mirror
  that the host profiler (``obs/hostprof.py``) reads from its sampler thread, where
  a contextvar cannot be read.
The obs server's ``/healthz``, ``/tenants`` and ``/leases`` views
(:mod:`~torchmetrics_tpu_torch.obs.server`) read these notes.

The disabled path is one branch: :data:`ENABLED` stays ``False`` until the first
tenant is registered (a scope entered, a metric adopted, a pipeline configured), and
every hook in the hot paths guards on it. Pure stdlib: importing this module never
imports torch or numpy.
"""

from __future__ import annotations

import threading
import time
import warnings
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

__all__ = [
    "ADMIT",
    "DEFAULT_MAX_TENANTS",
    "DEFER",
    "ENABLED",
    "OVERFLOW_TENANT",
    "SHED",
    "AdmissionController",
    "TenantQuota",
    "TenantRegistry",
    "adopt",
    "checkpoint_overdue",
    "checkpoint_status",
    "configure",
    "current_tenant",
    "expired_leases",
    "failover_yielded_count",
    "fence_status",
    "fenced_rejected_count",
    "fenced_swept_count",
    "fenced_tenants",
    "get_admission",
    "get_registry",
    "install_admission",
    "is_fenced",
    "lease_status",
    "migrating_tenants",
    "migration",
    "note_checkpoint",
    "note_checkpoint_closed",
    "note_checkpoint_failure",
    "note_compute",
    "note_failover_yielded",
    "note_fence",
    "note_fenced_bundle_rejected",
    "note_fenced_bundle_swept",
    "note_lease",
    "note_lease_released",
    "note_torn_bundles",
    "note_update",
    "record_gauges",
    "reset",
    "scope",
    "session",
    "tag",
    "torn_bundle_count",
    "thread_tenants",
    "track_thread_tenants",
    "validate_tenant",
]

# THE in-use flag. False until the first tenant registration anywhere in the
# process; every hot-path hook guards with ``if scope.ENABLED:`` so the
# never-scoped runtime pays one module-attribute load and one branch.
ENABLED = False

# the counted collapse bucket for tenants past the registry cap; reserved
# (user tenant names may not start with ``__``)
OVERFLOW_TENANT = "__overflow__"

DEFAULT_MAX_TENANTS = 1024

# the ambient tenant of the current context (always an *effective* label:
# past-cap tenants were already collapsed to OVERFLOW_TENANT at scope entry)
_TENANT: ContextVar[Optional[str]] = ContextVar("tm_tpu_tenant", default=None)

# cross-thread tenant attribution for the sampling profiler: a ContextVar is
# unreadable from another thread, so while tracking is on, scope()/session()
# also mirror the effective tenant into this thread-id-keyed dict. Off by
# default — the hot per-feed session entry pays one module-attribute load and
# one branch; obs/hostprof flips it on only while its sampler is live.
_TRACK_THREAD_TENANTS = False
_THREAD_TENANTS: Dict[int, str] = {}


def track_thread_tenants(on: bool) -> None:
    """Enable/disable the thread→tenant mirror (hostprof's sampler hook)."""
    global _TRACK_THREAD_TENANTS
    _TRACK_THREAD_TENANTS = bool(on)
    if not on:
        _THREAD_TENANTS.clear()


def thread_tenants() -> Dict[int, str]:
    """Snapshot of ``{thread_id: effective_tenant}`` for live scoped threads."""
    return dict(_THREAD_TENANTS)


def validate_tenant(tenant: Any) -> str:
    """A usable tenant name: non-empty string, ``__``-prefix reserved.

    :data:`OVERFLOW_TENANT` itself is accepted — it is the one label the
    runtime hands back (``adopt``/``scope`` return effective labels), and a
    pipeline whose tenant collapsed must still be able to enter its scope.
    """
    if not isinstance(tenant, str) or not tenant.strip():
        raise ValueError(f"Expected a non-empty string tenant name, got {tenant!r}")
    if tenant.startswith("__") and tenant != OVERFLOW_TENANT:
        raise ValueError(
            f"Tenant names starting with '__' are reserved;"
            f" got {tenant!r} (only {OVERFLOW_TENANT!r} may round-trip)"
        )
    return tenant


class TenantRegistry:
    """Bounded, thread-safe table of per-tenant liveness and activity.

    One row per tenant: first/last activity as wall clock AND a registry-wide
    monotonic activity step (so "which tenant went quiet first" is answerable
    without trusting wall-clock monotonicity), update/compute counts fed by
    the ``core/metric.py`` hooks, and the number of currently-active
    :class:`~torchmetrics_tpu_torch.engine.pipeline.MetricPipeline` sessions.

    Cardinality bound: at most ``max_tenants`` real rows. The registration
    that would create row ``max_tenants + 1`` lands in the counted
    :data:`OVERFLOW_TENANT` row instead (``collapsed_names`` distinct names,
    ``overflow_registrations`` total hits) with one loud ``RuntimeWarning`` —
    the overflow bucket is deliberately visible everywhere a real tenant is.
    """

    def __init__(self, max_tenants: int = DEFAULT_MAX_TENANTS) -> None:
        if max_tenants < 1:
            raise ValueError(f"Expected `max_tenants` >= 1, got {max_tenants}")
        self._lock = threading.Lock()
        self.max_tenants = int(max_tenants)
        self.clear()

    def clear(self) -> None:
        with self._lock:
            self._rows: Dict[str, Dict[str, Any]] = {}
            self._step = 0
            # distinct names collapsed into the overflow bucket; the tracking
            # set is itself bounded (a hostile name stream must not grow it)
            self.overflow_names = 0
            self._overflow_seen: set = set()
            self.overflow_registrations = 0
            self._warned_overflow = False

    def _new_row(self, tenant: str, now: float) -> Dict[str, Any]:
        return {
            "tenant": tenant,
            "first_seen_unix": now,
            "last_seen_unix": now,
            "first_step": self._step,
            "last_step": self._step,
            "updates": 0,
            "computes": 0,
            "active_pipelines": 0,
            "registrations": 0,
            "collapsed_names": 0,
        }

    # ---------------------------------------------------------------- activity

    def activate(self, tenant: str) -> str:
        """Register (or touch) ``tenant``; returns the **effective** label —
        the tenant itself, or :data:`OVERFLOW_TENANT` past the cap."""
        warn = False
        with self._lock:
            self._step += 1
            now = time.time()
            row = self._rows.get(tenant)
            if row is None:
                live = len(self._rows) - (1 if OVERFLOW_TENANT in self._rows else 0)
                if tenant != OVERFLOW_TENANT and live >= self.max_tenants:
                    self.overflow_registrations += 1
                    if tenant not in self._overflow_seen:
                        if len(self._overflow_seen) < self.max_tenants:
                            # distinct-name count SATURATES at the tracking-set
                            # cap: once full, re-registrations of an untracked
                            # name cannot be told apart from new names, so the
                            # count stops (an honest lower bound) instead of
                            # inflating on every repeat hit
                            self._overflow_seen.add(tenant)
                            self.overflow_names += 1
                    tenant = OVERFLOW_TENANT
                    row = self._rows.get(tenant)
                    if row is None:
                        row = self._rows[tenant] = self._new_row(tenant, now)
                    row["collapsed_names"] = self.overflow_names
                    warn = not self._warned_overflow
                    self._warned_overflow = True
                else:
                    row = self._rows[tenant] = self._new_row(tenant, now)
            row["registrations"] += 1
            row["last_seen_unix"] = now
            row["last_step"] = self._step
        if warn:
            warnings.warn(
                f"Tenant registry is FULL ({self.max_tenants} tenants): new tenants now"
                f" collapse into the counted {OVERFLOW_TENANT!r} bucket and lose"
                " individual attribution (liveness, series labels, per-tenant alerts)."
                " Raise the cap with `obs.scope.configure(max_tenants=...)` if the"
                " tenant population is legitimate; this is reported once per process.",
                RuntimeWarning,
                stacklevel=4,
            )
            import torchmetrics_tpu_torch.obs.trace as trace  # lazy: trace imports this module

            if trace.ENABLED:
                trace.event(
                    "tenant.overflow", max_tenants=self.max_tenants, collapsed=self.overflow_names
                )
        return tenant

    def _touch(self, tenant: Optional[str], field: str, n: int = 1) -> None:
        if tenant is None:
            return
        with self._lock:
            row = self._rows.get(tenant)
            if row is None:
                return  # labels only come from activate(); an unknown name is stale
            self._step += 1
            row[field] += n
            row["last_seen_unix"] = time.time()
            row["last_step"] = self._step

    def note_update(self, tenant: Optional[str], n: int = 1) -> None:
        self._touch(tenant, "updates", n)

    def note_compute(self, tenant: Optional[str]) -> None:
        self._touch(tenant, "computes", 1)

    def pipeline_started(self, tenant: Optional[str]) -> None:
        self._touch(tenant, "active_pipelines", 1)

    def pipeline_finished(self, tenant: Optional[str]) -> None:
        self._touch(tenant, "active_pipelines", -1)

    # -------------------------------------------------------------- inspection

    def known(self, tenant: str) -> bool:
        with self._lock:
            return tenant in self._rows

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    def rows(self) -> List[Dict[str, Any]]:
        """Copies of every row, oldest-registered first (overflow row last)."""
        with self._lock:
            rows = [dict(row) for row in self._rows.values()]
        rows.sort(key=lambda r: (r["tenant"] == OVERFLOW_TENANT, r["first_step"]))
        return rows

    def snapshot(self) -> Dict[str, Any]:
        """Plain-data registry snapshot (rides ``host_snapshot`` cross-host)."""
        return {
            "max_tenants": self.max_tenants,
            "n_tenants": len(self),
            "overflow_names": self.overflow_names,
            "overflow_registrations": self.overflow_registrations,
            "tenants": self.rows(),
        }

    def restore_row(
        self,
        tenant: str,
        updates: int = 0,
        computes: int = 0,
        first_seen_unix: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Merge a migrated session's lifetime activity into the tenant's row.

        The live-session migration path (:mod:`torchmetrics_tpu_torch.engine.migrate`):
        a session restored on this host carries its origin host's update/compute
        totals, and the registry must keep counting from there — a tenant that
        served a million updates before the rolling deploy did not become a
        newborn by moving. The merge is a **high-water max**, not an add: the
        restored totals are recovered state, not new work. On a pristine host
        the row jumps to the carried total; when the restore lands in the SAME
        process that already counted those updates (a placement-controller
        rebalance, a supervisor restart in-process), adding would double-count
        — and a rate consumer (the fleet sampler) would read every move as an
        instant burst on the destination host, which is exactly the phantom
        signal a load-balancing controller must not chase. The earliest
        first-seen stamp wins; the restore itself counts as activity
        (``last_seen`` moves). Returns a copy of the merged row.
        """
        with self._lock:
            self._step += 1
            now = time.time()
            row = self._rows.get(tenant)
            if row is None:
                row = self._rows[tenant] = self._new_row(tenant, now)
            row["updates"] = max(row["updates"], int(updates))
            row["computes"] = max(row["computes"], int(computes))
            if first_seen_unix is not None:
                row["first_seen_unix"] = min(row["first_seen_unix"], float(first_seen_unix))
            row["last_seen_unix"] = now
            row["last_step"] = self._step
            return dict(row)


_REGISTRY = TenantRegistry()


def get_registry() -> TenantRegistry:
    return _REGISTRY


def configure(max_tenants: Optional[int] = None) -> TenantRegistry:
    """Adjust the process-wide registry (currently: the tenant cap)."""
    if max_tenants is not None:
        if max_tenants < 1:
            raise ValueError(f"Expected `max_tenants` >= 1, got {max_tenants}")
        _REGISTRY.max_tenants = int(max_tenants)
    return _REGISTRY


def reset() -> None:
    """Drop all tenant state and return to the never-entered (free) path.

    Test hygiene: the registry and the :data:`ENABLED` flag are process-global,
    so suites that exercise tenancy call this to leave the next suite the
    pristine one-branch disabled path.
    """
    global ENABLED, _ADMISSION, _TORN_BUNDLES, _FENCED_REJECTED, _FENCED_SWEPT
    global _FAILOVER_YIELDED
    _REGISTRY.clear()
    _REGISTRY.max_tenants = DEFAULT_MAX_TENANTS
    _ADMISSION = None
    with _MIGRATION_LOCK:
        _MIGRATIONS.clear()
    with _CHECKPOINT_LOCK:
        _CHECKPOINTS.clear()
    with _LEASE_LOCK:
        _LEASES.clear()
        _FENCES.clear()
        _TORN_BUNDLES = 0
        _FENCED_REJECTED = 0
        _FENCED_SWEPT = 0
        _FAILOVER_YIELDED = 0
    track_thread_tenants(False)
    ENABLED = False


def registries_snapshot() -> Dict[str, Any]:
    """Copies of the process-wide tenant, migration, checkpoint, lease and fence
    registries, and of the enabled flags, for :func:`restore_registries`."""
    with _REGISTRY._lock:
        rows = {tenant: dict(row) for tenant, row in _REGISTRY._rows.items()}
    with _MIGRATION_LOCK:
        migrations = {tenant: list(phases) for tenant, phases in _MIGRATIONS.items()}
    with _CHECKPOINT_LOCK:
        checkpoints = {tenant: dict(row) for tenant, row in _CHECKPOINTS.items()}
    with _LEASE_LOCK:
        leases = {tenant: dict(row) for tenant, row in _LEASES.items()}
        fences = {epoch: dict(row) for epoch, row in _FENCES.items()}
    return {"enabled": ENABLED, "track_threads": _TRACK_THREAD_TENANTS, "threads": dict(_THREAD_TENANTS),
            "rows": rows, "migrations": migrations, "checkpoints": checkpoints, "leases": leases,
            "fences": fences}


def restore_registries(snapshot: Dict[str, Any]) -> None:
    """Put the registries of :func:`registries_snapshot` back as they were: a
    self-contained run (a chaos replay) leaves no tenant, lease or checkpoint row of
    its own behind. The running totals behind the fence gauges stay."""
    global ENABLED, _TRACK_THREAD_TENANTS
    with _REGISTRY._lock:
        _REGISTRY._rows = snapshot["rows"]
    for lock, registry, key in ((_MIGRATION_LOCK, _MIGRATIONS, "migrations"),
                                (_CHECKPOINT_LOCK, _CHECKPOINTS, "checkpoints"),
                                (_LEASE_LOCK, _LEASES, "leases"), (_LEASE_LOCK, _FENCES, "fences")):
        with lock:
            registry.clear()
            registry.update(snapshot[key])
    _THREAD_TENANTS.clear()
    _THREAD_TENANTS.update(snapshot["threads"])
    _TRACK_THREAD_TENANTS = snapshot["track_threads"]
    ENABLED = snapshot["enabled"]


def current_tenant() -> Optional[str]:
    """The ambient (effective) tenant of the calling context, or ``None``."""
    return _TENANT.get()


@contextmanager
def scope(tenant: str) -> Iterator[str]:
    """Enter a tenant scope: everything recorded inside belongs to ``tenant``.

    Yields the *effective* label — the tenant itself, or
    :data:`OVERFLOW_TENANT` once the registry cap collapsed it. Nesting is
    allowed (innermost wins); contextvars keep concurrent threads/tasks
    isolated.
    """
    global ENABLED
    effective = _REGISTRY.activate(validate_tenant(tenant))
    ENABLED = True
    token = _TENANT.set(effective)
    tid = prev = None
    if _TRACK_THREAD_TENANTS:
        tid = threading.get_ident()
        prev = _THREAD_TENANTS.get(tid)
        _THREAD_TENANTS[tid] = effective
    try:
        yield effective
    finally:
        _TENANT.reset(token)
        if tid is not None:
            if prev is None:
                _THREAD_TENANTS.pop(tid, None)
            else:
                _THREAD_TENANTS[tid] = prev


@contextmanager
def session(effective: str) -> Iterator[str]:
    """Re-enter an ALREADY-REGISTERED effective label: contextvar only.

    The pipeline hot path: :func:`adopt` registered the tenant once at
    construction, so per-call re-entry needs no registry lock and no
    ``registrations`` bump — just the ambient label for :func:`tag` and the
    liveness hooks. Pass only labels the runtime handed back (``adopt`` /
    ``scope`` return values); an unregistered label would tag series the
    registry cannot explain.
    """
    token = _TENANT.set(effective)
    tid = prev = None
    if _TRACK_THREAD_TENANTS:
        tid = threading.get_ident()
        prev = _THREAD_TENANTS.get(tid)
        _THREAD_TENANTS[tid] = effective
    try:
        yield effective
    finally:
        _TENANT.reset(token)
        if tid is not None:
            if prev is None:
                _THREAD_TENANTS.pop(tid, None)
            else:
                _THREAD_TENANTS[tid] = prev


def adopt(tenant: Optional[str] = None) -> Optional[str]:
    """Resolve a tenant for sticky capture (no context entered).

    With ``tenant`` given: register it and return the effective label (the
    ``PipelineConfig.tenant`` path). Without: return the ambient tenant, if
    any (the ``Metric.__init__`` capture path).
    """
    global ENABLED
    if tenant is None:
        return _TENANT.get()
    effective = _REGISTRY.activate(validate_tenant(tenant))
    ENABLED = True
    return effective


def note_update(fallback: Optional[str] = None, n: int = 1) -> None:
    """Count ``n`` metric updates against the ambient tenant (else ``fallback``).

    Callers guard with ``if scope.ENABLED:`` — this function assumes tenancy
    is in use and only resolves which tenant to bill.
    """
    tenant = _TENANT.get() or fallback
    if tenant is not None:
        _REGISTRY.note_update(tenant, n)


def note_compute(fallback: Optional[str] = None) -> None:
    """Count one fresh ``compute()`` against the ambient tenant (else ``fallback``)."""
    tenant = _TENANT.get() or fallback
    if tenant is not None:
        _REGISTRY.note_compute(tenant)


def tag(labels: Dict[str, Any]) -> Dict[str, Any]:
    """Inject the ambient tenant into a label/attr dict (idempotent, in place).

    THE propagation seam: every ``TraceRecorder`` write passes its labels
    through here, so counters, gauges, histogram keys and span/event attrs all
    pick up ``tenant=...`` while a scope is active. An explicit ``tenant``
    label is never overwritten — and an explicit ``tenant=None`` is the
    opt-OUT: the key is stripped and no ambient injection happens, so
    deliberately-global series (registry totals, per-class cost rollups,
    untenanted alert egress) stay unlabeled even when written inside a scope.
    The never-entered path is one branch.
    """
    if "tenant" in labels and labels["tenant"] is None:
        del labels["tenant"]
        return labels
    if not ENABLED:
        return labels
    tenant = _TENANT.get()
    if tenant is not None and "tenant" not in labels:
        labels["tenant"] = tenant
    return labels


# --------------------------------------------------------------------- migration

# tenants with a live-session migration in flight: tenant -> phase stack
# (nested phases — drain inside a rolling-deploy window — innermost wins).
# Lives here (pure stdlib, next to the liveness registry) so /healthz can name
# the migrating tenant without the obs server importing the engine layer.
_MIGRATIONS: Dict[str, List[str]] = {}
_MIGRATION_LOCK = threading.Lock()


@contextmanager
def migration(tenant: str, phase: str = "migrating") -> Iterator[str]:
    """Mark ``tenant``'s live session as mid-migration for the block's duration.

    The degraded-not-dead seam of :mod:`torchmetrics_tpu_torch.engine.migrate`:
    while any phase is active, ``/healthz`` answers ``degraded`` with the
    migrating tenant *named* (``tenants_migrating``) — a host handing a
    session off is still serving, but an operator watching the fleet must see
    WHO is in flight, not a silently shrinking tenant list. Nesting stacks
    (the innermost phase is the reported one); the entry is removed when the
    outermost block exits, crash or not.
    """
    validate_tenant(tenant)
    phase = str(phase)
    with _MIGRATION_LOCK:
        _MIGRATIONS.setdefault(tenant, []).append(phase)
    try:
        yield phase
    finally:
        with _MIGRATION_LOCK:
            stack = _MIGRATIONS.get(tenant)
            if stack:
                stack.pop()
                if not stack:
                    _MIGRATIONS.pop(tenant, None)


def migrating_tenants() -> Dict[str, str]:
    """Tenants with a migration in flight: ``{tenant: current phase}``."""
    with _MIGRATION_LOCK:
        return {tenant: stack[-1] for tenant, stack in _MIGRATIONS.items() if stack}


# ------------------------------------------------------------------ checkpoints

# per-tenant continuous-checkpoint liveness (engine/migrate.py's
# ContinuousCheckpointer reports here): last success, full-vs-delta bundle
# accounting, and the optional staleness budget /healthz judges. Lives here —
# pure stdlib, next to the liveness registry — so the obs server can surface
# checkpoint freshness without importing the engine layer, and so the record
# survives the session object whose crash it exists to describe.
_CHECKPOINTS: Dict[str, Dict[str, Any]] = {}
_CHECKPOINT_LOCK = threading.Lock()


def note_checkpoint(
    tenant: str,
    path: str,
    nbytes: int,
    kind: str,
    seconds: float,
    stale_after_seconds: Optional[float] = None,
) -> None:
    """Record one successful continuous-checkpoint bundle for ``tenant``.

    ``kind`` is ``"full"`` or ``"delta"``; ``stale_after_seconds`` (when the
    session's policy declares one) is the budget :func:`checkpoint_overdue`
    and ``/healthz`` judge the last-success age against.
    """
    validate_tenant(tenant)
    now = time.time()
    with _CHECKPOINT_LOCK:
        row = _CHECKPOINTS.setdefault(
            tenant,
            {
                "tenant": tenant,
                "bundles": {"full": 0, "delta": 0},
                "bytes": {"full": 0, "delta": 0},
                "failures": 0,
            },
        )
        row["last_unix"] = now
        row["last_path"] = str(path)
        row["last_kind"] = str(kind)
        row["last_bytes"] = int(nbytes)
        row["last_write_seconds"] = float(seconds)
        row["closed"] = False  # a fresh bundle reopens a closed session's row
        if kind in row["bundles"]:
            row["bundles"][kind] += 1
            row["bytes"][kind] += int(nbytes)
        if stale_after_seconds is not None:
            row["stale_after_seconds"] = float(stale_after_seconds)


def note_checkpoint_failure(tenant: str) -> None:
    """Count one failed continuous-checkpoint write for ``tenant``."""
    with _CHECKPOINT_LOCK:
        row = _CHECKPOINTS.get(tenant)
        if row is None:
            row = _CHECKPOINTS[tenant] = {
                "tenant": tenant,
                "bundles": {"full": 0, "delta": 0},
                "bytes": {"full": 0, "delta": 0},
                "failures": 0,
            }
        row["failures"] += 1


def note_checkpoint_closed(tenant: str) -> None:
    """Mark ``tenant``'s checkpointed session as cleanly closed.

    A closed session has no freshness promise: its age must stop being judged
    (``/healthz`` staleness) and stop being exported as the live
    ``checkpoint.last_success_age_seconds`` gauge — otherwise every cleanly
    shut-down session would flip the fleet degraded ``stale_after_seconds``
    later and strand a staleness alert firing forever. The bundle accounting
    (counts, bytes, failures) stays — it describes work that happened. A later
    :func:`note_checkpoint` (the session restarted or was restored) reopens
    the row.
    """
    with _CHECKPOINT_LOCK:
        row = _CHECKPOINTS.get(tenant)
        if row is not None:
            row["closed"] = True


def checkpoint_status() -> Dict[str, Dict[str, Any]]:
    """Per-tenant checkpoint liveness rows (deep-copied; the /tenants join)."""
    with _CHECKPOINT_LOCK:
        return {
            tenant: {**row, "bundles": dict(row["bundles"]), "bytes": dict(row["bytes"])}
            for tenant, row in _CHECKPOINTS.items()
        }


def checkpoint_overdue(now: Optional[float] = None) -> Dict[str, Dict[str, float]]:
    """Tenants whose last successful bundle is older than their declared budget.

    ``{tenant: {"age": seconds_since_success, "budget": stale_after_seconds}}``
    — only tenants whose policy declared ``stale_after_seconds`` are judged;
    the rest checkpoint on a best-effort cadence without a health contract.
    """
    now = time.time() if now is None else now
    overdue: Dict[str, Dict[str, float]] = {}
    with _CHECKPOINT_LOCK:
        for tenant, row in _CHECKPOINTS.items():
            budget = row.get("stale_after_seconds")
            last = row.get("last_unix")
            if budget is None or last is None or row.get("closed"):
                continue  # a cleanly closed session promises no freshness
            age = now - float(last)
            if age > float(budget):
                overdue[tenant] = {"age": age, "budget": float(budget)}
    return overdue


# ------------------------------------------------------------- leases & fencing

# per-tenant session leases (robust/fence.py reports here): holder id, session
# epoch (the fencing token), expiry/renewal stamps. Lives here — pure stdlib,
# next to the checkpoint registry — so ``GET /leases`` and the /healthz
# fenced-tenant naming never import the engine layer, and so the record
# survives the session object whose hang it exists to describe.
_LEASES: Dict[str, Dict[str, Any]] = {}
# fenced session epochs: epoch -> fence record. The process-local mirror of
# the durable FENCED.json markers engine/migrate.py writes next to bundle
# streams; GET /trace/<id> joins a trace id's epoch against this to call an
# update post-fence.
_FENCES: Dict[str, Dict[str, Any]] = {}
_LEASE_LOCK = threading.Lock()
# torn/corrupt bundles skipped by recovery scans, post-fence zombie bundles
# rejected by them, and post-fence zombie bundles garbage-collected by
# retention sweeps — running process totals behind the
# ``checkpoint.torn_bundles`` / ``fence.bundles_rejected`` /
# ``fence.bundles_swept`` gauges
_TORN_BUNDLES = 0
_FENCED_REJECTED = 0
_FENCED_SWEPT = 0
# failover elections lost: watchdogs that detected a stale lease, raced the
# durable FAILOVER_CLAIM.json, observed another survivor's claim and stood
# down — the running total behind the ``fence.failover_yielded`` gauge
_FAILOVER_YIELDED = 0


def note_lease(
    tenant: Optional[str],
    *,
    holder: str,
    epoch: str,
    ttl_seconds: float,
    expires_unix: float,
    renewed_unix: Optional[float] = None,
) -> None:
    """Record (or renew) ``tenant``'s session lease.

    ``epoch`` is the session's lineage epoch — THE fencing token: a failover
    restores under a fresh epoch and fences the old one, after which the
    zombie holder's bundle writes (still stamped with the fenced epoch) are
    rejected by recovery scans. Untenanted sessions lease under the reserved
    ``__local__`` label.
    """
    key = tenant if tenant is not None else "__local__"
    now = time.time()
    with _LEASE_LOCK:
        row = _LEASES.setdefault(key, {"tenant": key, "renewals": 0})
        if str(epoch) in _FENCES and row.get("epoch") not in (None, str(epoch)):
            # a zombie renewing its FENCED epoch must not clobber the row the
            # failed-over session holds under the new epoch — the fence is
            # exactly the promise that the old holder's writes stop counting
            return
        if row.get("epoch") == epoch:
            row["renewals"] += 1
        else:
            row["renewals"] = 0
        row["holder"] = str(holder)
        row["epoch"] = str(epoch)
        row["ttl_seconds"] = float(ttl_seconds)
        row["expires_unix"] = float(expires_unix)
        row["renewed_unix"] = float(renewed_unix if renewed_unix is not None else now)
        row["released"] = False


def note_lease_released(tenant: Optional[str]) -> None:
    """Mark ``tenant``'s lease cleanly released (session closed).

    A released lease promises nothing: it must not age into the expired set —
    a clean shutdown is not a hung host."""
    key = tenant if tenant is not None else "__local__"
    with _LEASE_LOCK:
        row = _LEASES.get(key)
        if row is not None:
            row["released"] = True


def lease_status() -> Dict[str, Dict[str, Any]]:
    """Per-tenant lease rows (copied; the ``GET /leases`` payload)."""
    with _LEASE_LOCK:
        return {tenant: dict(row) for tenant, row in _LEASES.items()}


def expired_leases(
    now: Optional[float] = None, grace: float = 0.0
) -> Dict[str, Dict[str, Any]]:
    """Tenants whose lease expired without a release or an existing fence.

    ``{tenant: {"holder", "epoch", "age": seconds_past_expiry}}`` — the fence
    watchdog's stale-lease detection input. ``grace`` widens the expiry so one
    late renewal under scheduler jitter is not a failover."""
    now = time.time() if now is None else now
    stale: Dict[str, Dict[str, Any]] = {}
    with _LEASE_LOCK:
        for tenant, row in _LEASES.items():
            expires = row.get("expires_unix")
            if expires is None or row.get("released"):
                continue
            if row.get("epoch") in _FENCES:
                continue  # already fenced: failover happened, not stale again
            age = now - float(expires) - float(grace)
            if age > 0:
                stale[tenant] = {
                    "tenant": tenant,
                    "holder": row.get("holder"),
                    "epoch": row.get("epoch"),
                    "age": age,
                }
    return stale


def note_fence(
    epoch: str,
    *,
    tenant: Optional[str] = None,
    holder: Optional[str] = None,
    by: Optional[str] = None,
    target: Optional[str] = None,
    fenced_unix: Optional[float] = None,
) -> Dict[str, Any]:
    """Record that session ``epoch`` is fenced out.

    ``holder`` is the (presumed-hung) lease holder being fenced, ``by`` who
    fenced it, ``target`` where the tenant failed over to. Returns the fence
    record. Idempotent per epoch (the first record wins — a fence is a fact,
    not a counter)."""
    with _LEASE_LOCK:
        record = _FENCES.get(epoch)
        if record is None:
            record = _FENCES[epoch] = {
                "epoch": str(epoch),
                "tenant": tenant,
                "holder": holder,
                "by": by,
                "target": target,
                "fenced_unix": float(fenced_unix if fenced_unix is not None else time.time()),
            }
        return dict(record)


def fence_status() -> Dict[str, Dict[str, Any]]:
    """Fenced epochs: ``{epoch: fence record}`` (copied)."""
    with _LEASE_LOCK:
        return {epoch: dict(record) for epoch, record in _FENCES.items()}


def is_fenced(epoch: Optional[str]) -> bool:
    """Is ``epoch`` a fenced-out session epoch?"""
    if not epoch:
        return False
    with _LEASE_LOCK:
        return epoch in _FENCES


def fenced_tenants() -> Dict[str, Dict[str, Any]]:
    """Fenced tenants, newest fence per tenant: the /healthz naming input."""
    out: Dict[str, Dict[str, Any]] = {}
    with _LEASE_LOCK:
        for record in sorted(_FENCES.values(), key=lambda r: r["fenced_unix"]):
            tenant = record.get("tenant")
            if tenant is not None:
                out[tenant] = dict(record)
    return out


def note_torn_bundles(n: int) -> None:
    """Count ``n`` torn/corrupt bundles a recovery scan skipped."""
    global _TORN_BUNDLES
    if n > 0:
        with _LEASE_LOCK:
            _TORN_BUNDLES += int(n)


def torn_bundle_count() -> int:
    with _LEASE_LOCK:
        return _TORN_BUNDLES


def note_fenced_bundle_rejected(n: int = 1) -> None:
    """Count ``n`` post-fence zombie bundle(s) a recovery scan rejected."""
    global _FENCED_REJECTED
    if n > 0:
        with _LEASE_LOCK:
            _FENCED_REJECTED += int(n)


def fenced_rejected_count() -> int:
    with _LEASE_LOCK:
        return _FENCED_REJECTED


def note_fenced_bundle_swept(n: int = 1) -> None:
    """Count ``n`` post-fence zombie bundle(s) a retention sweep GC'd."""
    global _FENCED_SWEPT
    if n > 0:
        with _LEASE_LOCK:
            _FENCED_SWEPT += int(n)


def fenced_swept_count() -> int:
    with _LEASE_LOCK:
        return _FENCED_SWEPT


def note_failover_yielded(n: int = 1) -> None:
    """Count ``n`` failover(s) this process stood down from (lost election)."""
    global _FAILOVER_YIELDED
    if n > 0:
        with _LEASE_LOCK:
            _FAILOVER_YIELDED += int(n)


def failover_yielded_count() -> int:
    with _LEASE_LOCK:
        return _FAILOVER_YIELDED


# --------------------------------------------------------------------- admission

# admission decisions (AdmissionController.admit return values)
ADMIT = "admit"
SHED = "shed"
DEFER = "defer"


@dataclass
class TenantQuota:
    """One tenant's budget per rolling window — the promises admission enforces.

    All limits are optional (``None`` = unmetered on that dimension); a quota
    with no limits admits everything but still tracks burn. ``flops`` and
    ``bytes`` are *estimated* costs — the cost ledger's per-dispatch counted
    numbers (``obs/cost.py``), dispatch-weighted — so enforcement is
    prediction-priced, not profiler-priced (the honest option on a host where
    per-tenant wall time cannot be isolated from shared dispatches).

    Args:
        updates_per_window: admitted update batches per window.
        flops_per_window: estimated flops per window.
        bytes_per_window: estimated bytes-accessed per window.
        compile_seconds_per_window: capture wall-seconds billed to the
            tenant per window (fresh variants its traffic forced).
        window_seconds: rolling-window length; burn resets when it elapses.
        over_quota: ``"shed"`` drops over-quota batches (counted, loud once
            per tenant — the warn_skip pattern); ``"defer"`` deprioritizes
            them (held until the window rolls under quota or the stream
            closes).
        priority: the tenant's latency class (higher = more
            latency-sensitive; default 0). Priority does not change THIS
            tenant's own quota math — it orders tenants *relative to each
            other* under pressure: deferred backlogs drain
            highest-class-first (:meth:`AdmissionController.drain_order`,
            consumed by the multiplexer's re-admission sweeps), so when the
            fleet recovers headroom the latency-sensitive tenants get it
            first and batch tiers absorb the wait.
    """

    updates_per_window: Optional[float] = None
    flops_per_window: Optional[float] = None
    bytes_per_window: Optional[float] = None
    compile_seconds_per_window: Optional[float] = None
    window_seconds: float = 60.0
    over_quota: str = SHED
    priority: int = 0

    # burn-dimension name -> the quota field bounding it
    _DIMENSIONS = (
        ("updates", "updates_per_window"),
        ("flops", "flops_per_window"),
        ("bytes", "bytes_per_window"),
        ("compile_seconds", "compile_seconds_per_window"),
    )

    def __post_init__(self) -> None:
        if self.over_quota not in (SHED, DEFER):
            raise ValueError(
                f"Expected `over_quota` of {SHED!r} or {DEFER!r}, got {self.over_quota!r}"
            )
        if self.window_seconds <= 0:
            raise ValueError(f"Expected positive `window_seconds`, got {self.window_seconds}")
        if not isinstance(self.priority, int) or self.priority < 0:
            raise ValueError(f"Expected non-negative integer `priority`, got {self.priority!r}")
        for _, field in self._DIMENSIONS:
            limit = getattr(self, field)
            if limit is not None and limit <= 0:
                raise ValueError(f"Expected positive `{field}` (or None), got {limit}")

    def limits(self) -> Dict[str, float]:
        """The metered dimensions only: ``{dimension: limit}``."""
        out = {}
        for dim, field in self._DIMENSIONS:
            limit = getattr(self, field)
            if limit is not None:
                out[dim] = float(limit)
        return out


class AdmissionController:
    """Per-tenant quota enforcement over rolling burn windows (thread-safe).

    The control loop the serving layers consult per fed batch:
    :meth:`admit` answers ``"admit"`` / ``"shed"`` / ``"defer"`` from the
    tenant's current window burn vs its quota, and :meth:`charge` is how the
    dispatch layers bill work back (updates always; estimated flops/bytes and
    compile seconds when the cost ledger priced the executed variant). Burn
    state is bounded by the tenant registry's own cap discipline: windows
    exist only for tenants with a quota (explicit or default) that have seen
    traffic.

    ``tenant.quota_exceeded`` flips are written to the recorder at decision
    time (not only at scrape time) so a ``threshold`` series
    :class:`~torchmetrics_tpu_torch.obs.alerts.AlertRule` watching it fires
    mid-stream.
    """

    def __init__(
        self,
        default_quota: Optional[TenantQuota] = None,
        clock: Any = time.monotonic,
    ) -> None:
        self._lock = threading.Lock()
        self.default_quota = default_quota
        self._clock = clock
        self._quotas: Dict[str, TenantQuota] = {}
        self._windows: Dict[str, Dict[str, float]] = {}
        self._shed: Dict[str, int] = {}
        self._deferred: Dict[str, int] = {}
        self._exceeded: Dict[str, bool] = {}  # last reported state per tenant

    def set_quota(self, tenant: str, quota: TenantQuota) -> "AdmissionController":
        validate_tenant(tenant)
        with self._lock:
            self._quotas[tenant] = quota
        return self

    def quota_for(self, tenant: str) -> Optional[TenantQuota]:
        with self._lock:
            return self._quotas.get(tenant, self.default_quota)

    def _window(self, tenant: str, quota: TenantQuota) -> Dict[str, float]:
        """The tenant's live burn window (lock held); rolls when elapsed."""
        now = self._clock()
        window = self._windows.get(tenant)
        if window is None or now - window["start"] >= quota.window_seconds:
            window = {"start": now, "updates": 0.0, "flops": 0.0, "bytes": 0.0, "compile_seconds": 0.0}
            self._windows[tenant] = window
        return window

    @staticmethod
    def _burn(window: Dict[str, float], quota: TenantQuota) -> Dict[str, Any]:
        limits = quota.limits()
        ratios = {dim: window[dim] / limit for dim, limit in limits.items()}
        burn_ratio = max(ratios.values()) if ratios else 0.0
        return {
            "used": {dim: window[dim] for dim, _ in TenantQuota._DIMENSIONS},
            "limits": limits,
            "burn_ratio": burn_ratio,
            "exceeded": burn_ratio >= 1.0,
        }

    def charge(
        self,
        tenant: str,
        updates: float = 0.0,
        flops: float = 0.0,
        bytes_accessed: float = 0.0,
        compile_seconds: float = 0.0,
    ) -> None:
        """Bill executed work to the tenant's current window (unmetered
        tenants — no quota anywhere — are not tracked at all)."""
        quota = self.quota_for(tenant)
        if quota is None:
            return
        with self._lock:
            window = self._window(tenant, quota)
            window["updates"] += updates
            window["flops"] += flops
            window["bytes"] += bytes_accessed
            window["compile_seconds"] += compile_seconds

    def admit(self, tenant: str, recorder: Optional[Any] = None) -> str:
        """The per-batch decision: :data:`ADMIT`, :data:`SHED` or :data:`DEFER`.

        Over-quota is *current window burn already at/over a limit* — the
        batch that would cross the line is still admitted (its charge tips
        the window), so enforcement never needs to predict a batch's cost
        before running it.
        """
        quota = self.quota_for(tenant)
        if quota is None:
            return ADMIT
        with self._lock:
            window = self._window(tenant, quota)
            exceeded = self._burn(window, quota)["exceeded"]
            if exceeded:
                decision = quota.over_quota
                if decision == SHED:
                    self._shed[tenant] = self._shed.get(tenant, 0) + 1
                else:
                    self._deferred[tenant] = self._deferred.get(tenant, 0) + 1
            else:
                decision = ADMIT
            flipped = self._exceeded.get(tenant) != exceeded
            self._exceeded[tenant] = exceeded
        if flipped:
            # the AlertRule-compatible signal, written on the EDGE (a
            # threshold series rule sees pressure start and end mid-stream,
            # without waiting for a scrape); tenant=... is explicit so an
            # ambient scope can never mis-attribute the flip
            import torchmetrics_tpu_torch.obs.trace as trace  # lazy: scope stays cycle-free

            rec = recorder if recorder is not None else trace.get_recorder()
            rec.set_gauge("tenant.quota_exceeded", 1.0 if exceeded else 0.0, tenant=tenant)
            if trace.ENABLED:
                trace.event(
                    "tenant.quota_" + ("exceeded" if exceeded else "recovered"),
                    tenant=tenant,
                    decision=decision,
                )
        return decision

    def priority_of(self, tenant: str) -> int:
        """The tenant's latency class (its quota's ``priority``; 0 unmetered)."""
        quota = self.quota_for(tenant)
        return int(quota.priority) if quota is not None else 0

    def drain_order(self, tenants: Iterable[str]) -> List[str]:
        """``tenants`` sorted for backlog drains: highest class first.

        Ties break by name for determinism. The multiplexer's deferred
        re-admission sweeps walk this order, so recovered headroom reaches
        latency-sensitive tenants before batch tiers.
        """
        return sorted(tenants, key=lambda t: (-self.priority_of(t), t))

    def would_admit(self, tenant: str) -> bool:
        """Read-only probe: would :meth:`admit` answer :data:`ADMIT` right now?

        The wall-clock re-admission check for deferred backlogs: a tenant
        parked over quota drains its deprioritized batches only when *someone*
        asks again, and an idle tenant never does — the serving layers
        (pipeline ``flush``/``poll_admission``, the multiplexer's per-feed
        sweep) probe this instead. **No state mutates**: no decision counters,
        no ``quota_exceeded`` edge writes, and an elapsed/absent window is not
        created or rolled — an answer of ``True`` simply means the next real
        ``admit()`` would let the backlog through.
        """
        quota = self.quota_for(tenant)
        if quota is None:
            return True
        with self._lock:
            now = self._clock()
            window = self._windows.get(tenant)
            if window is None or now - window["start"] >= quota.window_seconds:
                return True  # elapsed/absent window: a fresh window has zero burn
            return not self._burn(window, quota)["exceeded"]

    def note_degraded_shed(self, tenant: str, recorder: Optional[Any] = None) -> None:
        """Reclassify one DEFER decision as SHED (full-backlog degrade).

        :meth:`admit` already counted the batch as deferred when it answered
        ``"defer"``; a caller whose backlog is full drops the batch instead —
        this keeps the controller's (and so ``tenant.quota_shed`` /
        ``/tenants``) accounting truthful about the loss.
        """
        with self._lock:
            if self._deferred.get(tenant, 0) > 0:
                self._deferred[tenant] -= 1
            self._shed[tenant] = self._shed.get(tenant, 0) + 1

    # -------------------------------------------------------------- inspection

    def shed_count(self, tenant: str) -> int:
        with self._lock:
            return self._shed.get(tenant, 0)

    def deferred_count(self, tenant: str) -> int:
        with self._lock:
            return self._deferred.get(tenant, 0)

    def status(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant quota/burn rows — the ``GET /tenants`` join.

        Covers every tenant with an explicit quota or live burn window:
        current-window used/limits/burn_ratio, the exceeded flag, the
        over-quota policy, and lifetime shed/deferred totals. **Read-only**:
        scrapes never create or roll windows — a tenant whose window has
        elapsed (or that never saw traffic) reports zero burn without
        mutating enforcement state.
        """
        empty = {"start": 0.0, "updates": 0.0, "flops": 0.0, "bytes": 0.0, "compile_seconds": 0.0}
        with self._lock:
            now = self._clock()
            tenants = set(self._quotas) | set(self._windows) | set(self._shed) | set(self._deferred)
            rows: Dict[str, Dict[str, Any]] = {}
            for tenant in tenants:
                quota = self._quotas.get(tenant, self.default_quota)
                if quota is None:
                    continue
                window = self._windows.get(tenant)
                if window is None or now - window["start"] >= quota.window_seconds:
                    window, age = empty, 0.0  # elapsed/absent: zero burn, no write
                else:
                    age = max(0.0, now - window["start"])
                rows[tenant] = {
                    "tenant": tenant,
                    "window_seconds": quota.window_seconds,
                    "window_age_seconds": age,
                    "over_quota_policy": quota.over_quota,
                    "priority": int(quota.priority),
                    "shed": self._shed.get(tenant, 0),
                    "deferred": self._deferred.get(tenant, 0),
                    **self._burn(window, quota),
                }
        return rows

    def record_gauges(self, recorder: Optional[Any] = None) -> int:
        """Write ``tenant.quota_*`` gauges into the recorder; returns row count.

        Families (all labeled ``{tenant}``): ``tenant.quota_exceeded`` (the
        alert-compatible 0/1 signal), ``tenant.quota_burn_ratio`` (max
        used/limit across metered dimensions), ``tenant.quota_shed`` /
        ``tenant.quota_deferred`` (lifetime decisions), and per-dimension
        ``tenant.quota_window_*`` burn.
        """
        import torchmetrics_tpu_torch.obs.trace as trace  # lazy: scope stays cycle-free

        rec = recorder if recorder is not None else trace.get_recorder()
        rows = self.status()
        for tenant, row in rows.items():
            labels = {"tenant": tenant}
            rec.set_gauge("tenant.quota_exceeded", 1.0 if row["exceeded"] else 0.0, **labels)
            rec.set_gauge("tenant.quota_burn_ratio", float(row["burn_ratio"]), **labels)
            rec.set_gauge("tenant.quota_shed", float(row["shed"]), **labels)
            rec.set_gauge("tenant.quota_deferred", float(row["deferred"]), **labels)
            rec.set_gauge("tenant.quota_priority", float(row["priority"]), **labels)
            for dim in ("updates", "flops", "bytes", "compile_seconds"):
                rec.set_gauge(f"tenant.quota_window_{dim}", float(row["used"][dim]), **labels)
        return len(rows)


_ADMISSION: Optional[AdmissionController] = None


def install_admission(controller: Optional[AdmissionController]) -> Optional[AdmissionController]:
    """Install (or clear, with ``None``) the process-wide admission controller.

    The engine layers resolve it per fed batch via :func:`get_admission`, so
    installing mid-stream starts enforcing on the next batch; ``/tenants``
    joins its quota/burn rows. Returns the controller for chaining.
    """
    global _ADMISSION
    _ADMISSION = controller
    return controller


def get_admission() -> Optional[AdmissionController]:
    """The installed admission controller, or ``None`` (everything admitted)."""
    return _ADMISSION


def record_gauges(recorder: Optional[Any] = None) -> Dict[str, Any]:
    """Write per-tenant liveness/cardinality gauges into the recorder.

    Families (dots become underscores under the ``tm_tpu_`` Prometheus
    prefix), all labeled ``{tenant}`` except the two totals:

    - ``tenant.updates`` / ``tenant.computes`` — lifetime activity counts;
    - ``tenant.active_pipelines`` — live :class:`MetricPipeline` sessions;
    - ``tenant.series`` — recorder series currently carrying this tenant's
      label (the per-tenant cardinality gauge: the central risk, measured);
    - ``tenant.last_activity_age_seconds`` — wall-clock staleness;
    - ``tenant.registered`` (unlabeled) — tenants in the registry;
    - ``tenant.overflow_collapsed`` (unlabeled) — distinct names collapsed
      into the overflow bucket (loud by design: a nonzero value means
      attribution is being lost).

    Like the memory-accounting gauges, writes go straight to the recorder —
    an explicit call (or a ``/metrics`` scrape) is its own opt-in.
    """
    import torchmetrics_tpu_torch.obs.trace as trace  # lazy: scope stays import-cycle-free

    rec = recorder if recorder is not None else trace.get_recorder()
    rows = _REGISTRY.rows()
    counts = (
        # the tenant.* meta-gauges this function writes must not count
        # themselves as the tenant's own cardinality
        rec.series_counts_by_label("tenant", exclude_name_prefix="tenant.")
        if hasattr(rec, "series_counts_by_label")
        else {}
    )
    now = time.time()
    for row in rows:
        labels = {"tenant": row["tenant"]}
        rec.set_gauge("tenant.updates", float(row["updates"]), **labels)
        rec.set_gauge("tenant.computes", float(row["computes"]), **labels)
        rec.set_gauge("tenant.active_pipelines", float(row["active_pipelines"]), **labels)
        rec.set_gauge("tenant.series", float(counts.get(row["tenant"], 0)), **labels)
        rec.set_gauge(
            "tenant.last_activity_age_seconds",
            max(0.0, now - float(row["last_seen_unix"])),
            **labels,
        )
    # registry-wide totals stay UNLABELED even when this runs inside a scope:
    # tenant=None is the tag() opt-out, preventing an ambient tenant from
    # splitting the totals into per-tenant variants
    rec.set_gauge("tenant.registered", float(len(rows)), tenant=None)
    rec.set_gauge("tenant.overflow_collapsed", float(_REGISTRY.overflow_names), tenant=None)
    quota_rows = 0
    if _ADMISSION is not None:
        # the admission plane's quota/burn gauges refresh alongside the
        # registry's: one scrape shows who is active AND who is over budget
        quota_rows = _ADMISSION.record_gauges(recorder=rec)
    # continuous-checkpoint liveness (engine/migrate.py): the last-success age
    # refreshes per scrape, so checkpoint_staleness_rule's threshold series and
    # the /healthz staleness reason read a live number, not the write-time one
    checkpoint_rows = checkpoint_status()
    for tenant, row in checkpoint_rows.items():
        labels = {"tenant": tenant}
        last = row.get("last_unix")
        if last is not None and not row.get("closed"):
            # the age gauge is a LIVE-session signal only: a cleanly closed
            # session must not age into a firing staleness alert
            rec.set_gauge(
                "checkpoint.last_success_age_seconds",
                max(0.0, now - float(last)),
                **labels,
            )
        if row.get("last_write_seconds") is not None:
            rec.set_gauge(
                "checkpoint.write_seconds", float(row["last_write_seconds"]), **labels
            )
        rec.set_gauge("checkpoint.failures", float(row.get("failures", 0)), **labels)
        for kind in ("full", "delta"):
            count = row["bundles"].get(kind, 0)
            rec.set_gauge("checkpoint.bundles", float(count), kind=kind, **labels)
            if count:
                rec.set_gauge(
                    "checkpoint.bundle_bytes",
                    float(row["bytes"].get(kind, 0)) / count,
                    kind=kind,
                    **labels,
                )
    # lease/fence liveness: per-tenant time-to-expiry (negative = expired, the
    # watchdog's detection signal made scrapable) plus unlabeled fleet totals
    lease_rows = lease_status()
    active = 0
    expired = 0
    for tenant, row in lease_rows.items():
        if row.get("released"):
            continue
        expires = row.get("expires_unix")
        if expires is None:
            continue
        remaining = float(expires) - now
        rec.set_gauge("lease.seconds_to_expiry", remaining, tenant=tenant)
        if remaining > 0:
            active += 1
        else:
            expired += 1
    rec.set_gauge("lease.active", float(active), tenant=None)
    rec.set_gauge("lease.expired", float(expired), tenant=None)
    fence_rows = fence_status()
    rec.set_gauge("fence.fenced_epochs", float(len(fence_rows)), tenant=None)
    rec.set_gauge("fence.bundles_rejected", float(fenced_rejected_count()), tenant=None)
    rec.set_gauge("fence.bundles_swept", float(fenced_swept_count()), tenant=None)
    rec.set_gauge("fence.failover_yielded", float(failover_yielded_count()), tenant=None)
    # torn/corrupt bundles skipped by recovery scans (each scan also warns once)
    rec.set_gauge("checkpoint.torn_bundles", float(torn_bundle_count()), tenant=None)
    return {
        "tenants": len(rows),
        "overflow_collapsed": _REGISTRY.overflow_names,
        "quota_rows": quota_rows,
        "checkpoint_rows": len(checkpoint_rows),
        "lease_rows": len(lease_rows),
        "fenced_epochs": len(fence_rows),
    }
