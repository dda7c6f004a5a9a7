"""Lease-based hung-host fencing and automatic failover.

Counterpart of ``torchmetrics_tpu/robust/fence.py``. Whole-host death is survivable
(``CheckpointPolicy`` + crash recovery), but a *wedged-but-alive* host — hung
collective, stuck disk — is only observable, not survivable, until this module
closes the gap with the lease/fencing-token construction:

- **Lease**: every :class:`~torchmetrics_tpu_torch.engine.pipeline.MetricPipeline`
  session holds a renewable wall-clock lease minted per session *epoch* (the lineage
  epoch from :mod:`~torchmetrics_tpu_torch.obs.lineage`). The lease — holder id,
  epoch, expiry — is stamped into every checkpoint bundle manifest, so a host that
  stops writing bundles stops renewing, observably.
- **Fencing token**: the session epoch. A failover restores the tenant under a
  *fresh* epoch and durably fences the old one (``FENCED.json`` next to the bundles,
  via :func:`~torchmetrics_tpu_torch.engine.migrate.fence_epoch`). The zombie's
  later bundle writes still carry the fenced epoch and are rejected by
  ``verify_bundle``/``latest_valid_bundle`` — never selected, loudly counted.
- **Watchdog**: :class:`Watchdog` detects a stale lease from absent renewals
  (in-process: the scope lease registry; cross-host: the lease stamped in the newest
  bundle) plus checkpoint freshness, then runs :func:`failover`: fence FIRST, then
  select the restore bundle. Its clock is injectable (``tick(now=...)``).

The placement controller that may choose the restore host (JAX ``fleet``) comes
with the fleet plane; until then :meth:`Watchdog._placement_controller` finds none,
as the JAX package does when no controller is installed. Pure stdlib at import;
``engine.migrate`` is imported lazily inside :func:`failover` because the engine
layer imports :mod:`robust` at module scope.
"""

from __future__ import annotations

import json
import os
import socket
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torchmetrics_tpu_torch.obs.scope as _scope
import torchmetrics_tpu_torch.obs.trace as _trace
from torchmetrics_tpu_torch.utils.fileio import exclusive_create_text
from torchmetrics_tpu_torch.utils.prints import rank_zero_warn

__all__ = [
    "CLAIM_FILE",
    "Watchdog",
    "WatchdogConfig",
    "claim_failover",
    "failover",
    "get_watchdog",
    "holder_id",
    "install_watchdog",
    "lease_expired",
    "mint_lease",
    "renew_lease",
    "scan_bundle_lease",
    "stale_leases",
]

# the durable failover-election claim, beside FENCED.json in the bundle
# directory: first exclusive creation wins the right to run the failover
CLAIM_FILE = "FAILOVER_CLAIM.json"


def holder_id() -> str:
    """This process's lease-holder identity: ``host:pid``."""
    return f"{socket.gethostname()}:{os.getpid()}"


# ------------------------------------------------------------------- leases


def mint_lease(
    tenant: Optional[str],
    *,
    epoch: str,
    ttl_seconds: float,
    holder: Optional[str] = None,
    now: Optional[float] = None,
) -> Dict[str, Any]:
    """Mint a session lease for ``tenant`` under session ``epoch``.

    Returns the lease record — ``{"holder", "epoch", "ttl_seconds",
    "expires_unix", "renewed_unix"}`` — and registers it with the scope lease
    registry so ``GET /leases`` and the in-process watchdog see it.
    """
    if ttl_seconds <= 0:
        raise ValueError(f"Expected `ttl_seconds` to be positive, got {ttl_seconds}")
    now = time.time() if now is None else now
    lease = {
        "holder": holder if holder is not None else holder_id(),
        "epoch": str(epoch),
        "ttl_seconds": float(ttl_seconds),
        "expires_unix": now + float(ttl_seconds),
        "renewed_unix": now,
    }
    _scope.note_lease(
        tenant,
        holder=lease["holder"],
        epoch=lease["epoch"],
        ttl_seconds=lease["ttl_seconds"],
        expires_unix=lease["expires_unix"],
        renewed_unix=now,
    )
    return lease


def renew_lease(
    lease: Dict[str, Any], tenant: Optional[str] = None, now: Optional[float] = None
) -> Dict[str, Any]:
    """Renew ``lease`` in place (new expiry = now + ttl) and re-register it."""
    now = time.time() if now is None else now
    lease["expires_unix"] = now + float(lease["ttl_seconds"])
    lease["renewed_unix"] = now
    _scope.note_lease(
        tenant,
        holder=lease["holder"],
        epoch=lease["epoch"],
        ttl_seconds=lease["ttl_seconds"],
        expires_unix=lease["expires_unix"],
        renewed_unix=now,
    )
    if _trace.ENABLED:
        _trace.inc("lease.renewals")
    return lease


def lease_expired(
    lease: Optional[Dict[str, Any]], now: Optional[float] = None, grace: float = 0.0
) -> bool:
    """Is ``lease`` past its expiry (plus ``grace`` seconds of jitter budget)?"""
    if not lease:
        return False
    expires = lease.get("expires_unix")
    if expires is None:
        return False
    now = time.time() if now is None else now
    return now > float(expires) + float(grace)


def stale_leases(now: Optional[float] = None, grace: float = 0.0) -> Dict[str, Dict[str, Any]]:
    """In-process stale-lease view: unreleased, unfenced, expired past grace."""
    return _scope.expired_leases(now=now, grace=grace)


def scan_bundle_lease(directory: str) -> Optional[Dict[str, Any]]:
    """Read the lease stamped into the newest bundle under ``directory``.

    The *cross-host* renewal signal: a remote holder renews observably by
    writing bundles, so the newest manifest's lease block is its last
    provable renewal. Returns the lease dict (with ``"bundle"`` and
    ``"tenant"`` added) or ``None`` when no bundle carries one (empty
    directory, or pre-lease schema-2 bundles only). Torn or unreadable
    manifests are skipped silently here — recovery scans judge them loudly.
    """
    try:
        names = sorted(os.listdir(directory), reverse=True)
    except OSError:
        return None
    for name in names:
        full = os.path.join(directory, name)
        if not os.path.isdir(full) or ".tmp." in name or ".old." in name:
            continue
        try:
            with open(os.path.join(full, "MANIFEST.json"), encoding="utf-8") as fh:
                manifest = json.load(fh)
        except (OSError, ValueError):
            continue
        lease = manifest.get("lease")
        if isinstance(lease, dict) and lease.get("expires_unix") is not None:
            return {**lease, "bundle": full, "tenant": manifest.get("tenant")}
    return None


# ----------------------------------------------------------------- failover


def claim_failover(
    directory: str,
    epoch: str,
    *,
    by: Optional[str] = None,
    now: Optional[float] = None,
) -> bool:
    """Race the durable failover claim for ``epoch`` under ``directory``.

    The leader election for shared-disk fleets: when several survivors detect
    the same stale lease, each tries to exclusively create
    ``FAILOVER_CLAIM.json`` beside the bundles
    (:func:`~torchmetrics_tpu_torch.utils.fileio.exclusive_create_text` —
    ``O_CREAT | O_EXCL``, so exactly one creation succeeds across processes).
    Returns ``True`` for the winner (run the failover) and ``False`` for
    losers (stand down; the loss is counted via
    :func:`~torchmetrics_tpu_torch.obs.scope.note_failover_yielded` by the
    watchdog). A leftover claim from an *earlier* epoch's completed failover
    does not block the election: it is removed and the creation retried once
    — a stale claim is litter, not a leader.
    """
    path = os.path.join(os.path.abspath(directory), CLAIM_FILE)
    payload = json.dumps(
        {
            "epoch": str(epoch),
            "by": by if by is not None else holder_id(),
            "claimed_unix": time.time() if now is None else float(now),
        },
        sort_keys=True,
    )
    for _ in range(2):
        if exclusive_create_text(path, payload + "\n"):
            return True
        try:
            with open(path, encoding="utf-8") as fh:
                existing = json.load(fh)
        except (OSError, ValueError):
            # torn or vanished mid-read: retry the creation once — either we
            # win now or a well-formed winner's claim answers the next read
            continue
        if str(existing.get("epoch")) == str(epoch):
            return False  # a live claim for THIS epoch: someone else leads
        try:
            os.remove(path)  # an older epoch's leftover: clear and re-race
        except OSError:
            pass
    return False


def failover(
    metric: Any,
    directory: str,
    *,
    tenant: Optional[str] = None,
    epoch: Optional[str] = None,
    holder: Optional[str] = None,
    by: Optional[str] = None,
    target: Optional[str] = None,
    **restore_overrides: Any,
) -> Tuple[Any, Dict[str, Any]]:
    """Fence the stale holder's epoch and restore the tenant here.

    Order matters: the old epoch is fenced (durably, ``FENCED.json`` in
    ``directory``) *before* the restore bundle is selected, so a zombie bundle
    landing mid-failover is already fenced-out and never selected. The restore
    runs under a **fresh** session epoch (``fresh_epoch=True``) — the new
    fencing token — and the new session mints its own lease.

    ``metric`` is a freshly constructed same-spec metric (the
    ``restore_session`` contract). ``epoch``/``holder`` default to the lease
    visible in the scope registry or, cross-host, the newest bundle's stamp.
    Returns ``(pipeline, report)`` where ``report`` names the fenced epoch,
    the new epoch, the bundle restored from, and the failover timings.
    """
    from torchmetrics_tpu_torch.engine import migrate  # lazy: engine imports robust

    t0 = time.time()
    if epoch is None or holder is None:
        row = _scope.lease_status().get(tenant if tenant is not None else "__local__")
        if row is None or row.get("epoch") is None:
            row = scan_bundle_lease(directory)
        if row is not None:
            epoch = epoch if epoch is not None else row.get("epoch")
            holder = holder if holder is not None else row.get("holder")
    if epoch is None:
        raise RuntimeError(
            f"Cannot fail over tenant {tenant!r} from {directory}: no lease found in"
            " the scope registry or any bundle manifest — nothing to fence."
        )
    by = by if by is not None else holder_id()
    # the restore target defaults to the fencer itself; a placement
    # controller's delegation (Watchdog.tick) passes the load-chosen host
    target = target if target is not None else by
    # 1) fence FIRST — from here on the zombie's epoch is dead on arrival
    fence_record = migrate.fence_epoch(
        directory, epoch, tenant=tenant, holder=holder, by=by, target=target
    )
    # 2) only now select the restore bundle: anything the zombie wrote after
    #    the fence record's snapshot is rejected, not selected
    bundle = migrate.latest_valid_bundle(directory)
    if bundle is None:
        raise RuntimeError(
            f"Cannot fail over tenant {tenant!r}: fenced epoch {epoch} but found no"
            f" valid pre-fence bundle under {directory}."
        )
    pipe, manifest = migrate.restore_session(
        metric, bundle, fresh_epoch=True, **restore_overrides
    )
    t1 = time.time()
    if _trace.ENABLED:
        _trace.inc("fence.failovers", tenant=tenant)
    rank_zero_warn(
        f"Fenced session epoch {epoch} (holder {holder!r}) for tenant {tenant!r};"
        f" restored from {os.path.basename(bundle)} under new epoch"
        f" {pipe.lineage_epoch} in {t1 - t0:.3f}s.",
        RuntimeWarning,
    )
    report = {
        "tenant": tenant,
        "fenced_epoch": str(epoch),
        "fenced_holder": holder,
        "by": by,
        "target": target,
        "new_epoch": pipe.lineage_epoch,
        "bundle": bundle,
        "bundle_ts_unix": manifest.get("ts_unix"),
        # the restore point's ingest cursor: the supervisor re-feeds its
        # retained stream from here to close the gap the hang opened
        "restored_cursor": int(
            (manifest.get("cursor") or {}).get("batches_ingested", 0) or 0
        ),
        "failover_seconds": t1 - t0,
        "fenced_unix": fence_record.get("fenced_unix", t0),
        "known_bundles": list(fence_record.get("known", ())),
    }
    # 3) survivor-side cleanup: the zombie's post-fence bundles are rejected
    #    garbage from here on — GC them now (recency keep untouched: the new
    #    session's own retention policy, or everything, stays)
    try:
        keep = getattr(getattr(pipe.config, "checkpoint", None), "keep", None)
        swept = migrate.sweep_bundles(
            directory, keep=int(keep) if keep else 1_000_000, gc_fenced=True
        )
        report["zombie_bundles_swept"] = len(swept)
    except Exception:  # cleanup must never cost the failover
        report["zombie_bundles_swept"] = 0
    return pipe, report


# ----------------------------------------------------------------- watchdog


@dataclass
class WatchdogConfig:
    """One watched tenant's detection/failover policy.

    ``grace`` widens lease expiry so one late renewal under scheduler jitter
    is not a failover. ``require_checkpoint_stale`` additionally demands the
    newest bundle be older than ``lease ttl + grace`` before fencing — the
    "checkpoint freshness" half of detection, guarding against a host whose
    renewals are lost but whose bundle stream is demonstrably alive.
    """

    grace: float = 0.0
    require_checkpoint_stale: bool = False
    restore_overrides: Dict[str, Any] = field(default_factory=dict)


class Watchdog:
    """Detect stale leases and fail their tenants over automatically.

    Register tenants with :meth:`watch`; call :meth:`tick` from any loop —
    or :func:`install_watchdog` to have the obs server's ``/metrics`` scrape
    path tick it for free. Each tick checks every watched tenant's lease
    (in-process registry first, newest-bundle stamp as the cross-host
    fallback) and, on staleness, fences + restores via :func:`failover`.
    Completed failovers accumulate on :attr:`failovers` and are handed to
    ``on_failover`` when given.
    """

    def __init__(self, on_failover: Optional[Callable[[Any, Dict[str, Any]], None]] = None):
        self._watches: Dict[str, Dict[str, Any]] = {}
        self._on_failover = on_failover
        self.failovers: List[Dict[str, Any]] = []

    def watch(
        self,
        tenant: Optional[str],
        directory: str,
        metric_factory: Callable[[], Any],
        config: Optional[WatchdogConfig] = None,
    ) -> None:
        """Watch ``tenant``'s bundle ``directory``; ``metric_factory`` builds
        the fresh same-spec metric a failover restores onto."""
        key = tenant if tenant is not None else "__local__"
        self._watches[key] = {
            "tenant": tenant,
            "directory": os.path.abspath(directory),
            "metric_factory": metric_factory,
            "config": config or WatchdogConfig(),
        }

    def unwatch(self, tenant: Optional[str]) -> None:
        self._watches.pop(tenant if tenant is not None else "__local__", None)

    def _stale_lease(
        self, key: str, watch: Dict[str, Any], now: float
    ) -> Optional[Dict[str, Any]]:
        cfg: WatchdogConfig = watch["config"]
        row = _scope.lease_status().get(key)
        if row is not None:
            # the in-process registry is authoritative when it has seen the
            # tenant at all: a RELEASED lease is a clean shutdown, never a
            # hung host — falling through to the bundle-stamp fallback here
            # would fence a session that said goodbye properly
            if row.get("released"):
                return None
            if _scope.is_fenced(row.get("epoch")):
                return None
            if not lease_expired(row, now=now, grace=cfg.grace):
                return None
            lease = row
        else:
            lease = scan_bundle_lease(watch["directory"])
            if lease is None or _scope.is_fenced(lease.get("epoch")):
                return None
            if not lease_expired(lease, now=now, grace=cfg.grace):
                return None
        if cfg.require_checkpoint_stale:
            newest = scan_bundle_lease(watch["directory"])
            if newest is not None:
                budget = float(lease.get("ttl_seconds") or 0.0) + cfg.grace
                if now - float(newest.get("renewed_unix") or 0.0) <= budget:
                    return None  # bundle stream is provably alive: not hung
        return dict(lease)

    @staticmethod
    def _placement_controller() -> Optional[Any]:
        """The installed placement controller: ``None`` until the fleet plane
        (``fleet/placement.py``) is ported, which keeps every delegation seam the
        caller-named-directory behavior."""
        return None

    def tick(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One detection pass; returns the failover reports it produced.

        Before running a failover the survivors race the durable
        ``FAILOVER_CLAIM.json`` beside the bundles (:func:`claim_failover`) so
        exactly one executes it; losers stand down, counted
        (``fence.failover_yielded``), and stop watching the epoch — the
        winner's fence is the tenant's new truth. The restore *target* is the
        fencer itself until the fleet plane's placement controller is ported
        (:meth:`_placement_controller`)."""
        now = time.time() if now is None else now
        produced: List[Dict[str, Any]] = []
        controller = self._placement_controller()
        for key, watch in list(self._watches.items()):
            stale = self._stale_lease(key, watch, now)
            if stale is None:
                continue
            cfg: WatchdogConfig = watch["config"]
            epoch = stale.get("epoch")
            if epoch is not None and not claim_failover(
                watch["directory"], str(epoch), now=now
            ):
                # lost the election: another survivor owns this failover —
                # stand down loudly instead of running a racing restore
                _scope.note_failover_yielded()
                if _trace.ENABLED:
                    _trace.inc("fence.failover_yielded", tenant=watch["tenant"])
                self.unwatch(watch["tenant"])
                continue
            target = None
            if controller is not None and watch["tenant"] is not None:
                try:
                    target = controller.choose_restore_host(watch["tenant"])
                except Exception:  # noqa: BLE001 - delegation must not block failover
                    target = None
            try:
                pipe, report = failover(
                    watch["metric_factory"](),
                    watch["directory"],
                    tenant=watch["tenant"],
                    epoch=epoch,
                    holder=stale.get("holder"),
                    target=target,
                    **cfg.restore_overrides,
                )
            except Exception as err:  # noqa: BLE001 - a watchdog must not die with its patient
                rank_zero_warn(
                    f"Watchdog failover for tenant {watch['tenant']!r} failed: {err}",
                    RuntimeWarning,
                )
                continue
            report = {**report, "detected_unix": now}
            if controller is not None and watch["tenant"] is not None and target is not None:
                try:
                    # commit the choice to the placement table (and, in the
                    # virtual-host model, the sampler's placement map) so the
                    # fleet aggregate shows the tenant's host change
                    controller.note_failover(watch["tenant"], target)
                except Exception:  # noqa: BLE001
                    pass
            self.failovers.append(report)
            produced.append(report)
            # the restored session owns the tenant now; stop watching the
            # fenced one (the new session's own lease is watched by whoever
            # supervises *this* host)
            self.unwatch(watch["tenant"])
            if self._on_failover is not None:
                self._on_failover(pipe, report)
        return produced


# process-global watchdog the obs server's scrape loop drives (render_metrics
# ticks it right after refreshing the scope gauges)
_WATCHDOG: Optional[Watchdog] = None


def install_watchdog(watchdog: Optional[Watchdog]) -> Optional[Watchdog]:
    """Install (or with ``None`` remove) the scrape-driven watchdog; returns
    the previous one."""
    global _WATCHDOG
    previous = _WATCHDOG
    _WATCHDOG = watchdog
    return previous


def get_watchdog() -> Optional[Watchdog]:
    return _WATCHDOG
