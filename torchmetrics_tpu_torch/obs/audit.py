"""Conservation audit plane: exactly-once batch accounting across seams.

The engine makes hard exactly-once claims — mux poisoned-row isolation is
bit-identical to per-tenant eager, crash recovery and fencing are zero
double-counting — but each claim is proven only at test time by shadow-control
bit-identity inside the chaos bench. At serving time nothing watches whether a
batch was folded twice, shed silently, or stranded in a deferred backlog
forever. This module is the continuous accounting instrument: it derives, per
tenant and per session, the flow ledger

    fed = processed + shed + deferred_pending + quarantined + skipped + in_flight

from the seams that already exist (lineage arrival counters +
:class:`~torchmetrics_tpu_torch.obs.lineage.LineageIndex` records,
``PipelineReport``/``MuxReport`` accounting,
:class:`~torchmetrics_tpu_torch.obs.scope.AdmissionController` burn, checkpoint
cursors + coverage watermarks, the ``FENCED.json`` epoch ledger) and checks
cross-seam invariants on every ``/metrics`` scrape tick (cadence-gated,
in-flight-coalesced — the fleet-sampler pattern):

- ``no_double_fold`` — no trace id folds twice within one session generation
  (a restored session is a NEW generation: tail replays and crash-gap re-feeds
  legitimately re-fold ids the dead origin folded).
- ``no_post_fence_fold`` — no fold lands under a fenced epoch; a fenced
  zombie's *rejected bundle* is an audit event, never a violation.
- ``flow_conservation`` — arrivals reconcile with the ledger sum. A deficit
  (arrivals ahead of the ledger) is in-flight restore/replay work and only
  becomes a violation when it sits without progress past ``deferred_wall``;
  a surplus (ledger ahead of arrivals) is double-counted work and confirms
  after ``confirm_ticks`` consecutive identical observations (the counters
  are read lock-free across threads, so one tick may straddle a feed).
- ``deferred_accounting`` — the report's deferred ledger
  (``deferred_batches − deferred_replayed``) must equal the live backlog; a
  backlog mutated behind the controller is named by its stranded trace ids.
- ``checkpoint_coverage`` — a tenant's covering-checkpoint watermark never
  claims more processed batches than any session of the tenant has folded.
- ``exec_reconcile`` — the target metric's ``updates_ok`` never exceeds the
  ledger's ok-fold count: raw ``pure_update``/commit work done behind the
  auditor's back surfaces here. Exact for single-metric sessions; collections
  are skipped (members disagree by design — see PERF.md for the tolerance).

Lineage eviction makes a ledger honest-approximate (``approximate: true`` with
the evicted count), never silently wrong. The disabled path is one branch:
:data:`ENABLED` stays ``False`` until :func:`install_auditor`, every engine
hook guards on it, and importing this module is pure stdlib.

Egress: 7 HELP'd ``tm_tpu_audit_*`` gauges (:func:`record_gauges`), ``GET
/audit`` (:mod:`~torchmetrics_tpu_torch.obs.server`), the :func:`audit_violation_rule`
alert preset (standard pending→firing machinery; flips ``/healthz``
degraded-not-dead naming tenant + invariant), and ``python -m
torchmetrics_tpu_torch.obs.audit`` — an offline auditor for an on-disk checkpoint
stream (chain cursors, fence ledger, coverage continuity; exit 0/1/2 per the
regress/migrate CLI convention).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torchmetrics_tpu_torch.obs.lineage as _lineage
import torchmetrics_tpu_torch.obs.scope as _scope

__all__ = [
    "DEFAULT_CADENCE_SECONDS",
    "DEFAULT_CONFIRM_TICKS",
    "DEFAULT_DEFERRED_WALL_SECONDS",
    "ENABLED",
    "INVARIANTS",
    "ConservationAuditor",
    "audit_violation_rule",
    "get_auditor",
    "install_auditor",
    "main",
    "record_gauges",
]

# THE in-use flag (the lineage.ENABLED pattern): False until install_auditor()
# installs a live auditor; every engine fold/close/drain hook guards with
# ``if audit.ENABLED:`` so the never-audited runtime pays one module attribute
# load and one branch per batch.
ENABLED = False

DEFAULT_CADENCE_SECONDS = 2.0
# a deferred backlog (or an arrivals deficit: restore/replay work in motion)
# may sit this long without progress before it counts as stranded
DEFAULT_DEFERRED_WALL_SECONDS = 300.0
# cross-thread counter reads may straddle one feed: a candidate violation
# must be observed identical on this many consecutive ticks to confirm
DEFAULT_CONFIRM_TICKS = 2
DEFAULT_MAX_FOLD_IDS = 65536
DEFAULT_MAX_CLOSED_SCOPES = 256

INVARIANTS = (
    "flow_conservation",
    "no_double_fold",
    "no_post_fence_fold",
    "checkpoint_coverage",
    "deferred_accounting",
    "exec_reconcile",
)

_LOCAL = _lineage.LOCAL_TENANT

# ledger quantities summed/merged into per-tenant totals
_TOTAL_FIELDS = (
    "fed",
    "batches",
    "folded",
    "processed",
    "shed",
    "deferred",
    "deferred_replayed",
    "deferred_pending",
    "quarantined",
    "skipped",
    "in_flight",
    "handed_off",
)


class _Scope:
    """One tracked session OBJECT (= one session generation).

    A restored session is a new Python object, so object identity is the
    generation boundary the double-fold invariant scopes to: tail replays and
    crash-gap re-feeds land on the successor object with a fresh fold map and
    never false-positive against the dead origin's folds.
    """

    __slots__ = (
        "ref",
        "kind",
        "label",
        "created_unix",
        "closed",
        "folds",
        "fold_evicted",
        "handed_off",
        "rows",
    )

    def __init__(self, owner: Any, kind: str, label: str, wall: float) -> None:
        self.ref = weakref.ref(owner)
        self.kind = kind
        self.label = label
        self.created_unix = wall
        self.closed = False
        # tenant -> {trace_id: fold count this generation}
        self.folds: Dict[str, Dict[str, int]] = {}
        self.fold_evicted = 0
        # tenant -> batches drained out of this session into a bundle tail
        # (pipeline drain() / cooperative mux slice extraction): still this
        # session's arrivals, conserved as handed-off work
        self.handed_off: Dict[str, int] = {}
        # tenant -> last derived ledger row (refreshed per tick while live,
        # frozen at close — a closed generation keeps contributing its final
        # totals to the per-tenant merge)
        self.rows: Dict[str, Dict[str, Any]] = {}


class ConservationAuditor:
    """Continuous cross-seam conservation auditor (the fleet-sampler shape).

    ``tick()`` is cadence-gated and in-flight-coalesced — wire it into the
    ``/metrics`` render path and scrapes drive the audit for free. ``clock``
    and ``wall`` are injectable for tests.
    """

    def __init__(
        self,
        cadence_seconds: float = DEFAULT_CADENCE_SECONDS,
        deferred_wall_seconds: float = DEFAULT_DEFERRED_WALL_SECONDS,
        confirm_ticks: int = DEFAULT_CONFIRM_TICKS,
        max_fold_ids: int = DEFAULT_MAX_FOLD_IDS,
        max_closed_scopes: int = DEFAULT_MAX_CLOSED_SCOPES,
        max_violations: int = 256,
        clock: Any = time.monotonic,
        wall: Any = time.time,
    ) -> None:
        if cadence_seconds <= 0:
            raise ValueError(f"Expected `cadence_seconds` > 0, got {cadence_seconds}")
        if deferred_wall_seconds <= 0:
            raise ValueError(
                f"Expected `deferred_wall_seconds` > 0, got {deferred_wall_seconds}"
            )
        if confirm_ticks < 1:
            raise ValueError(f"Expected `confirm_ticks` >= 1, got {confirm_ticks}")
        if max_fold_ids < 1:
            raise ValueError(f"Expected `max_fold_ids` >= 1, got {max_fold_ids}")
        self.cadence_seconds = float(cadence_seconds)
        self.deferred_wall_seconds = float(deferred_wall_seconds)
        self.confirm_ticks = int(confirm_ticks)
        self.max_fold_ids = int(max_fold_ids)
        self.max_closed_scopes = int(max_closed_scopes)
        self.max_violations = int(max_violations)
        self._clock = clock
        self._wall = wall
        self._lock = threading.RLock()
        # serializes the derive pass; a scrape landing mid-tick skips instead
        # of stacking (the fleet-sampler coalescing rule)
        self._tick_lock = threading.Lock()
        self._scopes: Dict[int, _Scope] = {}
        self._closed_order: List[int] = []
        self._last_tick_mono: Optional[float] = None
        self.last_tick_unix: Optional[float] = None
        self.ticks = 0
        # sticky violations keyed (invariant, tenant, trace_id): a violation
        # is a fact about the stream, not a level — it never self-clears
        self._violations: Dict[Tuple[str, str, Optional[str]], Dict[str, Any]] = {}
        self.violations_dropped = 0
        # candidate cross-thread observations awaiting confirm_ticks
        self._candidates: Dict[Tuple[str, str, Optional[str]], Dict[str, Any]] = {}
        # (scope id, tenant) -> (deficit, first-seen mono) for the stranded wall
        self._deficits: Dict[Tuple[int, str], Tuple[int, float]] = {}
        # audit events (not violations): rejected zombie bundles etc.
        self._fenced_rejected_base = _scope.fenced_rejected_count()
        self._report_cache: Dict[str, Any] = {}

    # ------------------------------------------------------------- engine hooks

    def track(self, owner: Any, kind: str, label: Optional[str] = None) -> None:
        """Register a live session object (pipeline or mux) for auditing.

        Idempotent; sessions first seen at fold time self-register, so an
        auditor installed mid-life still audits exactly (ledger rows derive
        from the session's own lifetime counters, not from watched deltas).
        """
        with self._lock:
            self._scope_for(owner, kind, label)

    def _scope_for(self, owner: Any, kind: str, label: Optional[str] = None) -> _Scope:
        key = id(owner)
        scope = self._scopes.get(key)
        if scope is None or scope.ref() is not owner:
            scope = _Scope(
                owner, kind, label or type(owner).__name__, float(self._wall())
            )
            self._scopes[key] = scope
        return scope

    def note_fold(
        self,
        owner: Any,
        kind: str,
        tenant: Optional[str],
        epoch: Optional[str],
        trace_id: Optional[str],
    ) -> None:
        """One batch folded into ``owner``'s state (the engine commit seams).

        Exact-event invariants run here: a repeated trace id within this
        generation is a double fold, a fold under a fenced epoch is zombie
        work — both are named immediately with tenant + trace id.
        """
        key = tenant if tenant is not None else _LOCAL
        with self._lock:
            scope = self._scope_for(owner, kind)
            if trace_id is not None:
                folds = scope.folds.setdefault(key, {})
                n = folds.get(trace_id, 0) + 1
                folds[trace_id] = n
                if n > 1:
                    self._record_violation(
                        "no_double_fold",
                        key,
                        trace_id,
                        f"trace {trace_id} folded {n}x within one"
                        f" {scope.kind} session generation ({scope.label})",
                    )
                elif len(folds) > self.max_fold_ids:
                    # drop-oldest: the fold map is bounded like the lineage
                    # index; past the cap double-fold detection goes
                    # approximate (counted, reported), never wrong
                    folds.pop(next(iter(folds)))
                    scope.fold_evicted += 1
            if epoch is not None and _scope.is_fenced(epoch):
                self._record_violation(
                    "no_post_fence_fold",
                    key,
                    trace_id,
                    f"fold landed under fenced epoch {epoch}"
                    f" ({scope.kind} {scope.label})",
                )

    def note_handed_off(self, owner: Any, kind: str, tenant: Optional[str], n: int) -> None:
        """``n`` accepted batches left ``owner`` inside a bundle tail
        (pipeline ``drain()`` / cooperative mux slice extraction) — conserved
        as handed-off work, completed by the restoring session."""
        if n <= 0:
            return
        key = tenant if tenant is not None else _LOCAL
        with self._lock:
            scope = self._scope_for(owner, kind)
            scope.handed_off[key] = scope.handed_off.get(key, 0) + int(n)

    def note_close(self, owner: Any) -> None:
        """``owner`` closed: freeze its final ledger rows (they keep feeding
        the per-tenant merge) and stop deriving from the dead object."""
        with self._lock:
            scope = self._scopes.get(id(owner))
            if scope is None or scope.ref() is not owner or scope.closed:
                return
            try:
                self._refresh_scope_rows(scope, owner)
            except Exception:
                pass  # a half-torn-down session keeps its last good rows
            for row in scope.rows.values():
                row["closed"] = True
                row["in_flight"] = 0
            scope.closed = True
            self._closed_order.append(id(owner))
            while len(self._closed_order) > self.max_closed_scopes:
                self._scopes.pop(self._closed_order.pop(0), None)

    # ------------------------------------------------------------------- derive

    def _refresh_scope_rows(self, scope: _Scope, owner: Any) -> None:
        if scope.kind == "pipeline":
            scope.rows.update(self._pipeline_rows(scope, owner))
        else:
            rows = self._mux_rows(scope, owner)
            scope.rows.update(rows)
            # a cooperatively-extracted tenant vanishes from the live mux:
            # its frozen last row keeps contributing to the merge
            for tenant, row in scope.rows.items():
                if tenant not in rows:
                    row["closed"] = True
                    row["in_flight"] = 0

    def _pipeline_rows(self, scope: _Scope, pipe: Any) -> Dict[str, Dict[str, Any]]:
        rep = pipe._report
        tenant = pipe._tenant if pipe._tenant is not None else _LOCAL
        quarantined, skipped = pipe._robust_counts()
        chunk = pipe._chunk
        folded = int(rep.fused_batches + rep.eager_batches + rep.replayed_batches)
        row = {
            "kind": "pipeline",
            "label": scope.label,
            "tenant": tenant,
            "epoch": pipe._lineage_epoch,
            "lineage": bool(_lineage.ENABLED),
            "fed": int(pipe._lineage_seq),
            "batches": int(rep.batches),
            "folded": folded,
            "processed": folded - int(quarantined) - int(skipped),
            "shed": int(rep.shed_batches),
            "deferred": int(rep.deferred_batches),
            "deferred_replayed": int(rep.deferred_replayed),
            "deferred_pending": len(pipe._deferred),
            "quarantined": int(quarantined),
            "skipped": int(skipped),
            "in_flight": len(chunk) if chunk is not None else 0,
            "handed_off": scope.handed_off.get(tenant, 0),
            "updates_ok": None
            if pipe._is_collection
            else int(getattr(pipe._target, "updates_ok", 0) or 0),
            "collection": bool(pipe._is_collection),
            "fold_evicted": scope.fold_evicted,
            "closed": False,
        }
        return {tenant: row}

    def _mux_rows(self, scope: _Scope, mux: Any) -> Dict[str, Dict[str, Any]]:
        rows: Dict[str, Dict[str, Any]] = {}
        for tenant in list(mux._metrics):
            quarantined, skipped = mux._tenant_robust_counts(tenant)
            folded = int(mux._tenant_folded.get(tenant, 0))
            target = mux._metrics.get(tenant)
            deferred = int(mux._tenant_deferred.get(tenant, 0))
            replayed = int(mux._tenant_deferred_replayed.get(tenant, 0))
            rows[tenant] = {
                "kind": "mux",
                "label": scope.label,
                "tenant": tenant,
                "epoch": mux._lineage_epoch,
                "lineage": bool(_lineage.ENABLED),
                "fed": int(mux._tenant_arrivals.get(tenant, 0)),
                "batches": folded + (1 if tenant in mux._pending else 0),
                "folded": folded,
                "processed": folded - int(quarantined) - int(skipped),
                "shed": int(mux._tenant_shed.get(tenant, 0)),
                "deferred": deferred,
                "deferred_replayed": replayed,
                "deferred_pending": len(mux._deferred.get(tenant, ())),
                "quarantined": int(quarantined),
                "skipped": int(skipped),
                "in_flight": 1 if tenant in mux._pending else 0,
                "handed_off": scope.handed_off.get(tenant, 0),
                "updates_ok": None
                if mux._is_collection
                else int(getattr(target, "updates_ok", 0) or 0),
                "collection": bool(mux._is_collection),
                "fold_evicted": scope.fold_evicted,
                "closed": bool(getattr(mux, "_closed", False)),
            }
        return rows

    # -------------------------------------------------------------------- tick

    def tick(self, now: Optional[float] = None) -> Optional[Dict[str, Any]]:
        """One audit pass: refresh ledger rows, check invariants, cache the
        ``/audit`` payload. Cadence-gated; coalesces under a slow pass."""
        mono = float(now if now is not None else self._clock())
        if (
            self._last_tick_mono is not None
            and mono - self._last_tick_mono < self.cadence_seconds
        ):
            return None
        if self._tick_lock.locked():
            return None  # a scrape landed mid-derive: skip, don't stack
        with self._tick_lock:
            self._last_tick_mono = mono
            self.last_tick_unix = float(self._wall())
            self.ticks += 1
            with self._lock:
                self._derive_and_check(mono)
                return dict(self._report_cache)

    def _derive_and_check(self, mono: float) -> None:
        # 1. refresh rows from live owners (dead owners keep frozen rows)
        for key in list(self._scopes):
            scope = self._scopes[key]
            if scope.closed:
                continue
            owner = scope.ref()
            if owner is None:
                scope.closed = True
                for row in scope.rows.values():
                    row["closed"] = True
                    row["in_flight"] = 0
                self._closed_order.append(key)
                while len(self._closed_order) > self.max_closed_scopes:
                    self._scopes.pop(self._closed_order.pop(0), None)
                continue
            try:
                self._refresh_scope_rows(scope, owner)
            except Exception:
                continue  # a session mid-teardown keeps its last good rows

        # 2. per-row invariants (cross-thread reads confirm over ticks)
        live_candidates: set = set()
        for key, scope in self._scopes.items():
            for tenant, row in scope.rows.items():
                self._check_row(key, scope, tenant, row, mono, live_candidates)

        # 3. tenant-level checkpoint-coverage watermarks
        self._check_coverage(live_candidates)

        # drop candidates that did not re-observe this tick (transients)
        for cand in list(self._candidates):
            if cand not in live_candidates:
                self._candidates.pop(cand, None)

        self._rebuild_report()

    def _check_row(
        self,
        scope_key: int,
        scope: _Scope,
        tenant: str,
        row: Dict[str, Any],
        mono: float,
        live_candidates: set,
    ) -> None:
        # deferred ledger identity: report counters vs the live backlog.
        # Exact per thread; confirmed over ticks against mid-feed straddles.
        if not row["closed"]:
            # handed-off tails were deferred-not-replayed work: they leave the
            # backlog but stay on this side of the ledger until restored
            ledger_pending = row["deferred"] - row["deferred_replayed"]
            actual = row["deferred_pending"] + row["handed_off"]
            if ledger_pending != actual:
                self._candidate(
                    "deferred_accounting",
                    tenant,
                    self._stranded_deferred_id(scope, tenant, row),
                    f"deferred ledger says {ledger_pending} pending but the live"
                    f" backlog holds {row['deferred_pending']}"
                    f" (+{row['handed_off']} handed off) — backlog mutated"
                    f" behind the controller ({row['kind']} {row['label']})",
                    (ledger_pending, actual),
                    live_candidates,
                )

        # flow conservation: arrivals vs ledger sum (lineage-minted arrivals
        # only exist while lineage is enabled)
        if row["lineage"] and row["fed"]:
            ledger_sum = (
                row["batches"] + row["shed"] + row["deferred_pending"] + row["handed_off"]
            )
            if ledger_sum > row["fed"]:
                self._candidate(
                    "flow_conservation",
                    tenant,
                    None,
                    f"ledger accounts {ledger_sum} batches but only {row['fed']}"
                    f" arrived — work double-counted ({row['kind']} {row['label']}:"
                    f" batches={row['batches']} shed={row['shed']}"
                    f" deferred_pending={row['deferred_pending']}"
                    f" handed_off={row['handed_off']})",
                    (row["fed"], ledger_sum),
                    live_candidates,
                )
                self._deficits.pop((scope_key, tenant), None)
            elif ledger_sum < row["fed"] and not row["closed"]:
                # arrivals ahead: restore/replay work in motion, or a batch
                # lost to a propagated raise. Stranded only past the wall
                # with no progress.
                deficit = row["fed"] - ledger_sum
                seen = self._deficits.get((scope_key, tenant))
                if seen is None or seen[0] != deficit:
                    self._deficits[(scope_key, tenant)] = (deficit, mono)
                elif mono - seen[1] > self.deferred_wall_seconds:
                    self._record_violation(
                        "flow_conservation",
                        tenant,
                        None,
                        f"{deficit} arrived batch(es) unaccounted for"
                        f" {mono - seen[1]:.0f}s with no progress"
                        f" ({row['kind']} {row['label']})",
                    )
            else:
                self._deficits.pop((scope_key, tenant), None)

        # deferred backlogs drain or age: a non-empty backlog sitting without
        # progress past the wall is silent stranding
        if not row["closed"] and row["deferred_pending"]:
            marker = (scope_key, tenant + "\x00backlog")
            seen = self._deficits.get(marker)
            if seen is None or seen[0] != row["deferred_replayed"]:
                self._deficits[marker] = (row["deferred_replayed"], mono)
            elif mono - seen[1] > self.deferred_wall_seconds:
                self._record_violation(
                    "deferred_accounting",
                    tenant,
                    self._stranded_deferred_id(scope, tenant, row),
                    f"{row['deferred_pending']} deferred batch(es) stranded"
                    f" {mono - seen[1]:.0f}s with no drain progress"
                    f" ({row['kind']} {row['label']})",
                )
        else:
            self._deficits.pop((scope_key, tenant + "\x00backlog"), None)

        # executed-work reconciliation: updates_ok can never exceed the
        # ledger's ok folds — raw pure_update/commit work behind the
        # auditor's back lands here. Under-counts are legitimate (reset()).
        if row["updates_ok"] is not None and not row["collection"]:
            ok_folds = row["processed"]
            if row["updates_ok"] > ok_folds >= 0:
                self._candidate(
                    "exec_reconcile",
                    tenant,
                    self._newest_fold_id(scope, tenant),
                    f"target counts {row['updates_ok']} ok updates but the"
                    f" ledger folded only {ok_folds} — work executed behind"
                    f" the auditor ({row['kind']} {row['label']})",
                    (row["updates_ok"], ok_folds),
                    live_candidates,
                )

    def _check_coverage(self, live_candidates: set) -> None:
        """Per-tenant covering-checkpoint watermark ≤ the most-folded session."""
        index = _lineage.get_index()
        watermarks: Dict[str, Dict[str, Any]]
        with index._lock:
            watermarks = {k: dict(v) for k, v in index._checkpoints.items()}
        if not watermarks:
            return
        max_folded: Dict[str, int] = {}
        for scope in self._scopes.values():
            for tenant, row in scope.rows.items():
                max_folded[tenant] = max(max_folded.get(tenant, 0), row["folded"])
        for tenant, mark in watermarks.items():
            if tenant not in max_folded:
                continue  # a watermark for a session this process never saw
            covered = int(mark.get("covered_batches", 0) or 0)
            if covered > max_folded[tenant]:
                epoch = None
                for scope in self._scopes.values():
                    row = scope.rows.get(tenant)
                    if row is not None and row["folded"] == max_folded[tenant]:
                        epoch = row["epoch"]
                        break
                trace_id = (
                    _lineage.mint(tenant, epoch, max_folded[tenant])
                    if epoch is not None
                    else None
                )
                self._candidate(
                    "checkpoint_coverage",
                    tenant,
                    trace_id,
                    f"checkpoint {mark.get('path')} claims to cover {covered}"
                    f" processed batches but the tenant's furthest session"
                    f" folded only {max_folded[tenant]} — watermark ahead of"
                    " the cursor",
                    (covered, max_folded[tenant]),
                    live_candidates,
                )

    def _stranded_deferred_id(
        self, scope: _Scope, tenant: str, row: Dict[str, Any]
    ) -> Optional[str]:
        """Name a deferred-then-vanished batch: a lineage record stamped
        ``deferred`` whose id is neither in the live backlog nor ever folded."""
        if not row["lineage"]:
            return None
        index = _lineage.get_index()
        owner = scope.ref()
        live: set = set()
        try:
            if owner is not None:
                if scope.kind == "pipeline":
                    live = {t for _, _, t in owner._deferred if t is not None}
                else:
                    live = {
                        t
                        for _, _, t in owner._deferred.get(tenant, ())
                        if t is not None
                    }
        except Exception:
            pass
        folds = scope.folds.get(tenant, {})
        for trace_id in index.ids(None if tenant == _LOCAL else tenant):
            record = index.get(trace_id)
            if (
                record is not None
                and record.get("outcome") == "deferred"
                and trace_id not in live
                and trace_id not in folds
            ):
                return trace_id
        return None

    def _newest_fold_id(self, scope: _Scope, tenant: str) -> Optional[str]:
        folds = scope.folds.get(tenant)
        if not folds:
            return None
        return next(reversed(folds))

    # -------------------------------------------------------------- violations

    def _candidate(
        self,
        invariant: str,
        tenant: str,
        trace_id: Optional[str],
        detail: str,
        fingerprint: Any,
        live_candidates: set,
    ) -> None:
        """A cross-thread observation: confirms into a violation only when the
        identical fingerprint is re-observed ``confirm_ticks`` ticks running —
        a tick straddling a feed's counter updates must not false-positive."""
        key = (invariant, tenant, trace_id)
        live_candidates.add(key)
        seen = self._candidates.get(key)
        if seen is None or seen["fingerprint"] != fingerprint:
            self._candidates[key] = {"fingerprint": fingerprint, "ticks": 1, "detail": detail}
            seen = self._candidates[key]
        else:
            seen["ticks"] += 1
            seen["detail"] = detail
        if seen["ticks"] >= self.confirm_ticks:
            self._record_violation(invariant, tenant, trace_id, detail)

    def _record_violation(
        self, invariant: str, tenant: str, trace_id: Optional[str], detail: str
    ) -> None:
        key = (invariant, tenant, trace_id)
        if key in self._violations:
            return
        if len(self._violations) >= self.max_violations:
            self.violations_dropped += 1
            return
        self._violations[key] = {
            "invariant": invariant,
            "tenant": tenant,
            "trace_id": trace_id,
            "detail": detail,
            "at_unix": float(self._wall()),
        }

    def violations(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(v) for v in self._violations.values()]

    def violation_count(self) -> int:
        with self._lock:
            return len(self._violations)

    # ----------------------------------------------------------------- report

    def _rebuild_report(self) -> None:
        index_stats = _lineage.get_index().stats()
        fold_evicted = sum(s.fold_evicted for s in self._scopes.values())
        approximate = bool(index_stats.get("evicted", 0) or fold_evicted)
        fences = _scope.fence_status()
        fenced_epochs = set(fences)

        tenants: Dict[str, Dict[str, Any]] = {}
        for scope in self._scopes.values():
            for tenant, row in scope.rows.items():
                entry = tenants.setdefault(
                    tenant,
                    {"tenant": tenant, "sessions": [], "epochs": {}, "totals": {}},
                )
                entry["sessions"].append(dict(row))
                epoch = row.get("epoch")
                fenced = epoch in fenced_epochs
                bucket = entry["epochs"].setdefault(
                    epoch, {"fenced": fenced, "row": None}
                )
                bucket["fenced"] = fenced
                # max-merge within an epoch: a restored generation ADOPTS the
                # origin's totals and extends them, so the furthest row is
                # the epoch's truth — summing generations would double-count
                best = bucket["row"]
                if best is None or (row["fed"], row["folded"]) >= (
                    best["fed"],
                    best["folded"],
                ):
                    bucket["row"] = dict(row)
        for entry in tenants.values():
            totals = {field: 0 for field in _TOTAL_FIELDS}
            for epoch, bucket in entry["epochs"].items():
                if bucket["fenced"]:
                    # a fenced epoch's work continued under the failover
                    # session's fresh epoch (which adopted these totals):
                    # counting both would double-count the zombie's folds
                    continue
                row = bucket["row"]
                for field in _TOTAL_FIELDS:
                    totals[field] += int(row.get(field, 0) or 0)
            entry["totals"] = totals

        violations = [dict(v) for v in self._violations.values()]
        invariants = []
        by_invariant: Dict[str, int] = {}
        for v in violations:
            by_invariant[v["invariant"]] = by_invariant.get(v["invariant"], 0) + 1
        for name in INVARIANTS:
            count = by_invariant.get(name, 0)
            invariants.append(
                {"invariant": name, "passed": count == 0, "violations": count}
            )

        self._report_cache = {
            "enabled": True,
            "cadence_seconds": self.cadence_seconds,
            "confirm_ticks": self.confirm_ticks,
            "deferred_wall_seconds": self.deferred_wall_seconds,
            "ticks": self.ticks,
            "last_tick_unix": self.last_tick_unix,
            "sessions": sum(len(s.rows) for s in self._scopes.values()),
            "approximate": approximate,
            "lineage_evicted": int(index_stats.get("evicted", 0) or 0),
            "fold_ids_evicted": fold_evicted,
            "tenants": tenants,
            "invariants": invariants,
            "violations": violations,
            "violations_dropped": self.violations_dropped,
            "events": {
                # a fenced zombie's REJECTED bundle is correct fencing at
                # work — an audit event, never a violation
                "fenced_bundles_rejected": max(
                    0, _scope.fenced_rejected_count() - self._fenced_rejected_base
                ),
                "fenced_epochs": len(fenced_epochs),
            },
        }

    def report(self, tenant: Optional[str] = None) -> Dict[str, Any]:
        """The ``/audit`` payload (last tick's derivation; ``?tenant=`` scoped)."""
        with self._lock:
            if not self._report_cache:
                self._rebuild_report()
            payload = dict(self._report_cache)
            if tenant is not None:
                payload["tenants"] = {
                    key: value
                    for key, value in payload["tenants"].items()
                    if key == tenant
                }
                payload["violations"] = [
                    v for v in payload["violations"] if v["tenant"] == tenant
                ]
            return payload

    # ----------------------------------------------------------------- gauges

    def record_gauges(self, recorder: Optional[Any] = None) -> Dict[str, Any]:
        """Write the ``audit.*`` gauge families into the recorder.

        7 families, refreshed per scrape: plane cardinality
        (``audit.sessions``), per-tenant ledger quantities (``audit.fed``,
        ``audit.processed``, ``audit.shed``, ``audit.deferred_pending``),
        violation counts per invariant (``audit.violations``) and the
        honest-approximation flag (``audit.approximate``).
        """
        import torchmetrics_tpu_torch.obs.trace as _trace  # lazy: audit stays cycle-free

        rec = recorder if recorder is not None else _trace.get_recorder()
        with self._lock:
            if not self._report_cache:
                self._rebuild_report()
            payload = self._report_cache
        rec.set_gauge("audit.sessions", float(payload["sessions"]), tenant=None)
        rec.set_gauge(
            "audit.approximate", 1.0 if payload["approximate"] else 0.0, tenant=None
        )
        for name, entry in payload["tenants"].items():
            totals = entry["totals"]
            rec.set_gauge("audit.fed", float(totals["fed"]), tenant=name)
            rec.set_gauge("audit.processed", float(totals["processed"]), tenant=name)
            rec.set_gauge("audit.shed", float(totals["shed"]), tenant=name)
            rec.set_gauge(
                "audit.deferred_pending",
                float(totals["deferred_pending"]),
                tenant=name,
            )
        total = 0
        for row in payload["invariants"]:
            rec.set_gauge(
                "audit.violations",
                float(row["violations"]),
                tenant=None,
                invariant=row["invariant"],
            )
            total += row["violations"]
        # the unlabeled total the audit_violation alert preset watches
        rec.set_gauge("audit.violations", float(total), tenant=None)
        return payload

    def reset(self) -> None:
        with self._lock:
            self._scopes.clear()
            self._closed_order.clear()
            self._violations.clear()
            self._candidates.clear()
            self._deficits.clear()
            self._report_cache = {}
            self._last_tick_mono = None
            self.last_tick_unix = None
            self.ticks = 0
            self.violations_dropped = 0
            self._fenced_rejected_base = _scope.fenced_rejected_count()


# ----------------------------------------------------------------- singleton

_AUDITOR: Optional[ConservationAuditor] = None


def install_auditor(
    auditor: Optional[ConservationAuditor],
) -> Optional[ConservationAuditor]:
    """Install the process-wide auditor (``None`` uninstalls); returns the
    previous one. Flips :data:`ENABLED` — the engine fold hooks' one branch."""
    global _AUDITOR, ENABLED
    previous = _AUDITOR
    _AUDITOR = auditor
    ENABLED = auditor is not None
    return previous


def get_auditor() -> Optional[ConservationAuditor]:
    return _AUDITOR


def record_gauges(recorder: Optional[Any] = None) -> Optional[Dict[str, Any]]:
    auditor = _AUDITOR
    if auditor is None:
        return None
    return auditor.record_gauges(recorder=recorder)


def audit_violation_rule(
    for_seconds: float = 0.0, severity: str = "critical"
) -> Any:
    """The audit-violation alert preset: fires (pending→firing through the
    standard machinery) while any conservation invariant stands violated."""
    from torchmetrics_tpu_torch.obs.alerts import AlertRule

    return AlertRule(
        name="audit_violation",
        kind="threshold",
        series="audit.violations",
        above=0.0,
        for_seconds=for_seconds,
        severity=severity,
    )


# ------------------------------------------------- engine hook entry points
# Module-level shims so engine call sites stay one guarded line:
#     if _audit.ENABLED: _audit.note_fold(self, "pipeline", tenant, epoch, tid)


def track(owner: Any, kind: str, label: Optional[str] = None) -> None:
    auditor = _AUDITOR
    if auditor is not None:
        auditor.track(owner, kind, label)


def note_fold(
    owner: Any,
    kind: str,
    tenant: Optional[str],
    epoch: Optional[str],
    trace_id: Optional[str],
) -> None:
    auditor = _AUDITOR
    if auditor is not None:
        auditor.note_fold(owner, kind, tenant, epoch, trace_id)


def note_handed_off(owner: Any, kind: str, tenant: Optional[str], n: int) -> None:
    auditor = _AUDITOR
    if auditor is not None:
        auditor.note_handed_off(owner, kind, tenant, n)


def note_close(owner: Any) -> None:
    auditor = _AUDITOR
    if auditor is not None:
        auditor.note_close(owner)


# ------------------------------------------------------------------ offline CLI


def _find_bundles(root: str) -> List[str]:
    """Bundle directories under ``root`` (a stream layout: ``root/<tenant>/
    <bundle>/`` or bundles directly under ``root``), shallow walk."""
    from torchmetrics_tpu_torch.engine.migrate import _MANIFEST_NAME

    found: List[str] = []
    for dirpath, dirnames, filenames in os.walk(root):
        if _MANIFEST_NAME in filenames:
            found.append(dirpath)
            dirnames[:] = []  # bundles never nest
            continue
        if dirpath != root:
            depth = os.path.relpath(dirpath, root).count(os.sep)
            if depth >= 2:
                dirnames[:] = []
    return sorted(found)


def audit_stream(root: str) -> Dict[str, Any]:
    """Audit an on-disk checkpoint stream offline.

    Verifies every bundle (digest, schema, delta chain), then checks the
    offline conservation invariants: chain-cursor monotonicity
    (``batches_ingested`` never regresses along a delta chain), per-bundle
    coverage sanity (``lineage.seq >= batches_ingested`` — a cursor can never
    claim more processed work than arrived), epoch constancy within a chain,
    and the fence ledger (bundles written under a fenced epoch are reported
    as events, the rejected-zombie convention — not violations).
    """
    from torchmetrics_tpu_torch.engine.migrate import (
        SessionBundleError,
        _bundle_epoch,
        _chain_manifests,
        _verify_one,
        fenced_epochs,
    )

    result: Dict[str, Any] = {
        "root": os.path.abspath(root),
        "bundles": 0,
        "corrupt": [],
        "violations": [],
        "events": [],
        "fenced_epochs": {},
        "tenants": {},
    }
    fences: Dict[str, Dict[str, Any]] = {}
    for fence_dir in {root, *(os.path.dirname(b) for b in _find_bundles(root))}:
        try:
            fences.update(fenced_epochs(fence_dir))
        except Exception:
            pass
    result["fenced_epochs"] = fences

    per_tenant: Dict[str, Dict[str, Any]] = {}
    for path in _find_bundles(root):
        result["bundles"] += 1
        try:
            manifest = _verify_one(path, check_fence=False)
            chain = _chain_manifests(path, manifest, check_fence=False)
        except SessionBundleError as err:
            result["corrupt"].append({"path": path, "error": str(err)})
            continue
        tenant = manifest.get("tenant") or _LOCAL
        epoch = _bundle_epoch(manifest)
        cursor = manifest.get("cursor") or {}
        committed = int(cursor.get("batches_ingested", 0) or 0)
        seq = int((cursor.get("lineage") or {}).get("seq", 0) or 0)
        row = per_tenant.setdefault(
            tenant, {"bundles": 0, "max_committed": 0, "epochs": set()}
        )
        row["bundles"] += 1
        row["max_committed"] = max(row["max_committed"], committed)
        row["epochs"].add(epoch)

        if epoch in fences:
            fenced_at = float(fences[epoch].get("fenced_unix", 0) or 0)
            created = float(manifest.get("created_unix", 0) or 0)
            result["events"].append(
                {
                    "event": "fenced_epoch_bundle",
                    "path": path,
                    "tenant": tenant,
                    "epoch": epoch,
                    "post_fence": bool(created and created > fenced_at),
                }
            )

        if seq and seq < committed:
            result["violations"].append(
                {
                    "invariant": "checkpoint_coverage",
                    "path": path,
                    "tenant": tenant,
                    "trace_id": _lineage.mint(tenant, epoch, max(0, seq)),
                    "detail": f"cursor claims {committed} processed batches but"
                    f" lineage.seq says only {seq} arrived",
                }
            )

        # chain walk: newest first — cursors must never regress toward the
        # base, and the epoch (the fencing token) is constant along a chain
        prev_committed: Optional[int] = None
        prev_path = path
        for link_path, link_manifest in chain:
            link_cursor = link_manifest.get("cursor") or {}
            link_committed = int(link_cursor.get("batches_ingested", 0) or 0)
            link_epoch = _bundle_epoch(link_manifest)
            if prev_committed is not None and link_committed > prev_committed:
                result["violations"].append(
                    {
                        "invariant": "flow_conservation",
                        "path": prev_path,
                        "tenant": tenant,
                        "trace_id": _lineage.mint(tenant, epoch, link_committed),
                        "detail": f"delta chain cursor regressed: {prev_path}"
                        f" covers {prev_committed} batches but its base"
                        f" {link_path} covers {link_committed}",
                    }
                )
            if link_epoch != epoch:
                result["violations"].append(
                    {
                        "invariant": "no_post_fence_fold",
                        "path": link_path,
                        "tenant": tenant,
                        "trace_id": None,
                        "detail": f"delta chain crosses epochs: {epoch} at the"
                        f" tip but {link_epoch} at {link_path} — a chain never"
                        " spans a fence/failover",
                    }
                )
            prev_committed, prev_path = link_committed, link_path

    for tenant, row in per_tenant.items():
        result["tenants"][tenant] = {
            "bundles": row["bundles"],
            "max_committed": row["max_committed"],
            "epochs": sorted(e for e in row["epochs"] if e),
        }
    return result


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m torchmetrics_tpu_torch.obs.audit <stream-dir>`` — exit 0 when the
    stream's accounting is conserved, 1 on corruption or a violated invariant,
    2 when the audit cannot run (missing directory, no bundles)."""
    parser = argparse.ArgumentParser(
        prog="python -m torchmetrics_tpu_torch.obs.audit",
        description="Audit an on-disk checkpoint stream's batch accounting offline.",
    )
    parser.add_argument("directory", help="checkpoint stream directory")
    parser.add_argument(
        "--json", action="store_true", help="emit the full audit result as JSON"
    )
    parser.add_argument(
        "--quiet", action="store_true", help="suppress the human-readable report"
    )
    args = parser.parse_args(argv)

    if not os.path.isdir(args.directory):
        print(f"audit: no such directory: {args.directory}", file=sys.stderr)
        return 2
    result = audit_stream(args.directory)
    if not result["bundles"]:
        print(f"audit: no session bundles under {args.directory}", file=sys.stderr)
        return 2

    if args.json and not args.quiet:
        print(json.dumps(result, indent=2, sort_keys=True, default=str))
    elif not args.quiet:
        print(
            f"audited {result['bundles']} bundle(s),"
            f" {len(result['tenants'])} tenant(s),"
            f" {len(result['fenced_epochs'])} fenced epoch(s)"
        )
        for tenant, row in sorted(result["tenants"].items()):
            print(
                f"  {tenant}: {row['bundles']} bundle(s), cursor ≤"
                f" {row['max_committed']}, epochs {', '.join(row['epochs'])}"
            )
        for event in result["events"]:
            print(
                f"  event: {event['event']} tenant={event['tenant']}"
                f" epoch={event['epoch']} ({event['path']})"
            )
    for entry in result["corrupt"]:
        print(f"CORRUPT: {entry['path']}: {entry['error']}", file=sys.stderr)
    for violation in result["violations"]:
        print(
            f"VIOLATION: {violation['invariant']} tenant={violation['tenant']}"
            f" trace_id={violation['trace_id']}: {violation['detail']}",
            file=sys.stderr,
        )
    return 1 if result["corrupt"] or result["violations"] else 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
