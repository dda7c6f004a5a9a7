"""Fault-tolerance layer of the port: update guards and fault injection.

Counterpart of ``torchmetrics_tpu/robust``, as far as the engine slice needs it:

- :mod:`~torchmetrics_tpu_torch.robust.policy` — per-metric / global **error
  policies** (``raise`` | ``warn_skip`` | ``quarantine``) applied in the ``Metric``
  update path. The default (no policy configured) screens nothing and lets
  exceptions propagate.
- :mod:`~torchmetrics_tpu_torch.robust.faults` — deterministic fault-injection
  context managers (NaN bursts; collective and download plans).

- :mod:`~torchmetrics_tpu_torch.robust.fence` — lease-stamped sessions with the
  session epoch as a fencing token: a :class:`~torchmetrics_tpu_torch.robust.fence.Watchdog`
  that sees a lease lapse fences the epoch, restores the tenant from the latest
  valid bundle under a fresh epoch, and the zombie's later bundles are refused.

The retrying fetcher (``retry``) and the guard around eager collectives
(``degraded``) come with the robust plane.
"""

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

__all__ = [
    "ErrorPolicy",
    "UpdateGuardError",
    "Watchdog",
    "WatchdogConfig",
    "error_policy",
    "failover",
    "get_error_policy",
    "get_watchdog",
    "holder_id",
    "install_watchdog",
    "lease_expired",
    "mint_lease",
    "renew_lease",
    "scan_bundle_lease",
    "set_error_policy",
    "stale_leases",
]
