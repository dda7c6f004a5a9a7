"""Fault-tolerance layer of the port: update guards and fault injection.

Counterpart of ``torchmetrics_tpu/robust``, as far as the engine slice needs it:

- :mod:`~torchmetrics_tpu_torch.robust.policy` — per-metric / global **error
  policies** (``raise`` | ``warn_skip`` | ``quarantine``) applied in the ``Metric``
  update path. The default (no policy configured) screens nothing and lets
  exceptions propagate.
- :mod:`~torchmetrics_tpu_torch.robust.retry` — deterministic (jitter-free)
  exponential backoff with deadline support, plus :func:`fetch_resource` /
  :func:`fetch_bytes` for external resources with checksum/size validation,
  atomic writes, and corrupted-cache purge-and-refetch.
- :mod:`~torchmetrics_tpu_torch.robust.degraded` — a timeout + bounded-retry guard
  around the eager collectives of ``parallel/sync.py``. On exhaustion the metric
  degrades to local-only state with a loud warning and a ``sync_degraded`` flag
  instead of hanging the job.
- :mod:`~torchmetrics_tpu_torch.robust.faults` — deterministic fault-injection
  context managers (NaN bursts, raising/hanging collectives, truncated downloads).

- :mod:`~torchmetrics_tpu_torch.robust.fence` — lease-stamped sessions with the
  session epoch as a fencing token: a :class:`~torchmetrics_tpu_torch.robust.fence.Watchdog`
  that sees a lease lapse fences the epoch, restores the tenant from the latest
  valid bundle under a fresh epoch, and the zombie's later bundles are refused.
"""

from torchmetrics_tpu_torch.robust.degraded import (
    CollectiveError,
    CollectiveTimeoutError,
    configure_sync_guard,
    sync_guard,
)
from torchmetrics_tpu_torch.robust.fence import (
    Watchdog,
    WatchdogConfig,
    failover,
    get_watchdog,
    holder_id,
    install_watchdog,
    lease_expired,
    mint_lease,
    renew_lease,
    scan_bundle_lease,
    stale_leases,
)
from torchmetrics_tpu_torch.robust.policy import (
    ErrorPolicy,
    UpdateGuardError,
    error_policy,
    get_error_policy,
    set_error_policy,
)
from torchmetrics_tpu_torch.robust.retry import (
    ResourceIntegrityError,
    RetryError,
    RetrySchedule,
    fetch_bytes,
    fetch_resource,
    load_with_cache_recovery,
    retry_call,
)

__all__ = [
    "CollectiveError",
    "CollectiveTimeoutError",
    "ErrorPolicy",
    "ResourceIntegrityError",
    "RetryError",
    "RetrySchedule",
    "UpdateGuardError",
    "Watchdog",
    "WatchdogConfig",
    "configure_sync_guard",
    "error_policy",
    "failover",
    "fetch_bytes",
    "fetch_resource",
    "get_error_policy",
    "get_watchdog",
    "holder_id",
    "install_watchdog",
    "lease_expired",
    "load_with_cache_recovery",
    "mint_lease",
    "renew_lease",
    "retry_call",
    "scan_bundle_lease",
    "set_error_policy",
    "stale_leases",
    "sync_guard",
]
